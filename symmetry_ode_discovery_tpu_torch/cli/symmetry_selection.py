"""Symmetry selection: checkpoint-only criteria of the LV noise-0.99 LaLiGAN
equilibria against their downstream EquivSINDy-r sweeps.

    python -m symmetry_ode_discovery_tpu_torch.cli.symmetry_selection \
        --val_x <lv-val-noise99-gp-x.npy> [--ckpt_root saved_models] \
        [--ckpts laligan-noise99-lv,laligan-noise99-lv-s44,...] \
        [--results_root eval_results] [--device cpu]

The port's counterpart of the repository's tools/symmetry_selection.py, with
its criteria, its table and its rank statistics. Each checkpoint (the
reference-seed directory laligan-noise99-lv, tagged s43, and every
laligan-noise99-lv-sNN under --ckpt_root by default) is scored on 4096
held-out points of the LV val split (np.random.default_rng(0), without
replacement) with:

  truth-equiv  the reversed symmetry penalty (training/symmreg.py::symmreg_r)
               of the ground-truth field h*(x) = (-4/3 e^{x1} + 2/3, e^{x0} - 1)
  disp         sum over the group elements exp(0.01 sigma L) of
               E||g(x) - x||^2, g acting through the autoencoder
  discrim      the truth's penalty over the median of five wrong fields'
  sep          the median penalty of plain SINDy's wrong solutions
               (<results_root>/sindy2-noise99-lv) over the truth's
  AE recon     E||decode(encode(x)) - x||^2 / E||x||^2
  closure, ortho, norm   the generator's regularisers

beside the downstream sweep's joint/eq0/eq1 successes (the first of
symreg2-noise99-lv-<tag>, symreg25-noise99-lv-<tag> under --results_root
with at least 25 seeds; symreg2-noise99-lv or bench-symreg for s43) and the
Spearman correlation of each criterion with the joint successes over seeds
0-24 (NaN for a criterion that is NaN on some checkpoint). The last line
is one JSON object: the device, its name, and each checkpoint's criteria
and downstream counts.

Runs on ``cuda`` unless --device says otherwise; nothing is written.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from .. import resolve_device

N_POINTS = 4096
MIN_SEEDS = 25
BASE = "laligan-noise99-lv"
CONFIG = "lv/noise99_eq_isymreg.cfg"
PLAIN_SWEEP = "sindy2-noise99-lv"
LABELS = (("truth-equiv penalty magnitude", "pen"), ("transformation displacement", "disp"),
          ("discrim (pen/median wrong)", "discr"), ("sep (plain-wrong/truth)", "sep"),
          ("AE recon (lower=better)", "recon"))


def tag_of(name: str) -> str:
    """s43 for the reference-seed checkpoint, else the name's -sNN suffix."""
    return "s43" if name == BASE else name.rsplit("-", 1)[-1]


def sweep_dirs(name: str) -> list:
    """The downstream sweeps of a checkpoint, in the order they are tried."""
    if name == BASE:
        return ["symreg2-noise99-lv", "bench-symreg"]
    tag = tag_of(name)
    return [f"symreg2-noise99-lv-{tag}", f"symreg25-noise99-lv-{tag}"]


def discover_ckpts(ckpt_root: str) -> list:
    """laligan-noise99-lv and every laligan-noise99-lv-s* under ckpt_root."""
    return [BASE] + [os.path.basename(d) for d in
                     sorted(glob.glob(os.path.join(ckpt_root, f"{BASE}-s*")))]


def truth_h(x: torch.Tensor) -> torch.Tensor:
    """The ground-truth LV field in the protocol's log coordinates."""
    return torch.stack([-4.0 / 3.0 * torch.exp(x[:, 1]) + 2.0 / 3.0,
                        torch.exp(x[:, 0]) - 1.0], dim=1)


def wrong_fields(xs: torch.Tensor) -> list:
    """Five plausible wrong fields: the components swapped, the sign
    flipped, the least-squares linear fit of h* on xs (numpy's lstsq on the
    host), h* scaled by 1.5 and h* + 0.5 x."""
    A, *_ = np.linalg.lstsq(xs.cpu().numpy(), truth_h(xs).cpu().numpy(), rcond=None)
    A = torch.as_tensor(A, dtype=xs.dtype, device=xs.device)
    return [lambda x: truth_h(x).flip(1), lambda x: -truth_h(x), lambda x: x @ A,
            lambda x: 1.5 * truth_h(x), lambda x: truth_h(x) + 0.5 * x]


def field_of(C, device) -> callable:
    """The field Theta(x) C^T of a (2, 8) coefficient matrix on the poly2 +
    exp library [1, x0, x1, x0^2, x0 x1, x1^2, e^x0, e^x1]; C rounded to
    float32, then taken in x's dtype."""
    Ct = torch.as_tensor(np.asarray(C), dtype=torch.float32, device=device)

    def h(x):
        feats = torch.stack([torch.ones_like(x[:, 0]), x[:, 0], x[:, 1], x[:, 0] ** 2,
                             x[:, 0] * x[:, 1], x[:, 1] ** 2, torch.exp(x[:, 0]),
                             torch.exp(x[:, 1])], dim=1)
        return feats @ Ct.to(x.dtype).T
    return h


def plain_wrong_coefficients(results_root: str) -> list:
    """The coefficients of the seeds plain SINDy got wrong in
    <results_root>/sindy2-noise99-lv."""
    out = []
    for f in sorted(glob.glob(os.path.join(results_root, PLAIN_SWEEP, "seed*.npz"))):
        with np.load(f) as z:
            if not np.all(z["correct_form"] > 0):
                out.append(np.array(z["coefficients"]))
    return out


def downstream(dirs, results_root: str, min_seeds: int = MIN_SEEDS):
    """(dir, n, joint, eq0, eq1, joint over seeds 0-24) of the first sweep of
    ``dirs`` under results_root with at least min_seeds seeds, or all None."""
    for d in dirs:
        fs = sorted(glob.glob(os.path.join(results_root, d, "seed*.npz")),
                    key=lambda f: int(f.rsplit("seed", 1)[1].split(".")[0]))
        if len(fs) >= min_seeds:
            cf = np.stack([np.load(f)["correct_form"] for f in fs])
            n25 = min(25, len(fs))
            return (d, len(fs), int(np.all(cf > 0, axis=1).sum()), int((cf[:, 0] > 0).sum()),
                    int((cf[:, 1] > 0).sum()), int(np.all(cf[:n25] > 0, axis=1).sum()))
    return None, None, None, None, None, None


def spearman(a, b) -> float:
    """Spearman's rank correlation, ties given their average rank."""
    def ranks(v):
        v = np.asarray(v, float)
        order = np.argsort(v)
        r = np.empty(len(v))
        sv = v[order]
        i = 0
        while i < len(v):
            j = i
            while j + 1 < len(v) and sv[j + 1] == sv[i]:
                j += 1
            r[order[i:j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        return r

    ra, rb = ranks(a), ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    den = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / den) if den else float("nan")


def held_out(val_x: np.ndarray) -> np.ndarray:
    """The 4096 held-out points: rows of the flattened val split drawn by
    np.random.default_rng(0) without replacement."""
    xv = np.asarray(val_x, np.float32).reshape(-1, 2)
    return xv[np.random.default_rng(0).choice(len(xv), N_POINTS, replace=False)]


def load_model(name: str, ckpt_root: str, device):
    """(autoencoder in eval mode, GeneratorSpec, GeneratorState) of the
    checkpoint ckpt_root/name, built from lv/noise99_eq_isymreg.cfg."""
    from ..convert import laligan_from_npz
    from ..utils.config import get_args
    from .main import build_models

    args = dict(vars(get_args(["--config", CONFIG, "--load_laligan", name])), input_dim=2)
    ae, spec = build_models(args)
    sd, g_state = laligan_from_npz(os.path.join(ckpt_root, name), device)
    ae.load_state_dict(sd)
    return ae.to(device).eval().requires_grad_(False), spec, g_state


def criteria(ae, spec, g_state, xs: torch.Tensor, plain_coefs=()) -> dict:
    """The checkpoint-only criteria on the points xs; sep is NaN without
    plain SINDy's wrong solutions."""
    from ..models import lie_generator as lg
    from ..training.symmreg import _group_transform, symmreg_r

    with torch.no_grad():
        pen_of = lambda h: float(symmreg_r(ae, spec, g_state, xs, h))
        pen = pen_of(truth_h)
        disp = 0.0
        for g in lg.get_deterministic_group_elems(spec, g_state, scale=0.01):
            gx = _group_transform(ae, g, xs, normalize="global", z_mean=None)
            disp += float(((gx - xs) ** 2).mean())
        discr = pen / float(np.median([pen_of(w) for w in wrong_fields(xs)]))
        pens_plain = [pen_of(field_of(C, xs.device)) for C in plain_coefs]
        sep = float(np.median(pens_plain)) / pen if pens_plain else float("nan")
        xr = ae.decode(ae.encode(xs))
        recon = float(((xr - xs) ** 2).mean() / (xs ** 2).mean())
        return {"pen": pen, "disp": disp, "discr": discr, "sep": sep, "recon": recon,
                "closure": float(lg.reg_closure(spec, g_state)),
                "ortho": float(lg.reg_ortho(spec, g_state)),
                "norm": float(lg.reg_norm(spec, g_state))}


def run(val_x: np.ndarray, ckpts=None, ckpt_root: str = "saved_models",
        results_root: str = "eval_results", device=None) -> dict:
    """Each checkpoint's criteria and downstream counts (rows, in the order
    of ``ckpts``), E||h*||^2 on the held-out points and the Spearman
    correlations (None with fewer than three checkpoints with a sweep)."""
    device = resolve_device(device)
    xs = torch.as_tensor(held_out(val_x), device=device)
    plain = plain_wrong_coefficients(results_root)
    rows = []
    for name in ckpts or discover_ckpts(ckpt_root):
        ae, spec, g_state = load_model(name, ckpt_root, device)
        row = {"ckpt": tag_of(name), "name": name}
        row.update(criteria(ae, spec, g_state, xs, plain))
        keys = ("sweep", "n", "joint", "eq0", "eq1", "joint25")
        row.update(zip(keys, downstream(sweep_dirs(name), results_root)))
        rows.append(row)
    have = [r for r in rows if r["sweep"] is not None]
    rho = None
    if len(have) >= 3:
        y = [r["joint25"] for r in have]
        # a criterion NaN on some row (sep without plain SINDy's sweep) has
        # no ranks: NaN, where the tool ranks the NaNs as values
        rho = {key: spearman([r[key] for r in have], y)
               if all(np.isfinite(r[key]) for r in have) else float("nan")
               for _, key in LABELS}
    return {"hnorm": float((truth_h(xs) ** 2).mean()), "rows": rows, "n_ranked": len(have),
            "spearman": rho}


def format_table(out: dict) -> str:
    """The table and rank statistics in the layout of the tracked
    eval_results/symmetry-selection-n10.txt."""
    lines = [f"held-out: lv val noise99, {N_POINTS} points; E||h*||^2 = {out['hnorm']:.4f}",
             f"{'ckpt':5} {'truth-equiv':>11} {'disp':>9} {'discrim':>9} {'sep':>7} "
             f"{'AE recon':>9} {'closure':>8} {'ortho':>8} {'norm':>7}  "
             "downstream joint/eq0/eq1 (joint@25)"]
    for r in out["rows"]:
        ds = (f"{r['sweep']}: {r['joint']}/{r['n']} {r['eq0']}/{r['eq1']} ({r['joint25']}/25)"
              if r["sweep"] else "(no sweep)")
        lines.append(f"{r['ckpt']:5} {r['pen']:11.3e} {r['disp']:9.3e} {r['discr']:9.3f} "
                     f"{r['sep']:7.2f} {r['recon']:9.5f} {r['closure']:8.2e} {r['ortho']:8.2e} "
                     f"{r['norm']:7.3f}  {ds}")
    if out["spearman"] is not None:
        lines += ["", f"rank correlation vs downstream joint@25 (n={out['n_ranked']} "
                  "equilibria):"]
        lines += [f"  {label:32} rho = {out['spearman'][key]:+.3f}" for label, key in LABELS]
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--val_x", required=True,
                    help="a .npy of the LV val split, (n_ics, n_steps, 2) or (rows, 2)")
    ap.add_argument("--ckpt_root", default="saved_models")
    ap.add_argument("--ckpts", default=None,
                    help="comma-separated checkpoint names (default: every "
                         "laligan-noise99-lv[-sNN] under --ckpt_root)")
    ap.add_argument("--results_root", default="eval_results")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    out = run(np.load(a.val_x), a.ckpts.split(",") if a.ckpts else None, a.ckpt_root,
              a.results_root, device)
    print(format_table(out))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"device": str(device), "kind": kind, "hnorm": out["hnorm"],
                      "rows": out["rows"], "spearman": out["spearman"]}))
    return out


if __name__ == "__main__":
    main()
