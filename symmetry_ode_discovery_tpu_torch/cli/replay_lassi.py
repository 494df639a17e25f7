"""Replay of the JAX package's LaLiGAN training on its own init and draws.

    python -m symmetry_ode_discovery_tpu_torch.cli.replay_lassi \
        --draws build/chip_data/lassi-noise99-lv.npz [--device cpu]

Reads a file written by tools/dump_jax_draws.py --lassi (the first windows of
the JAX package's train split, the JAX trainer's init, each epoch's batch
permutation and each batch's coefficient draws, the JAX trainer's per-batch
and per-epoch components and final parameters; for a joint SINDy config the
windows' derivatives, the SINDy state and the JAX trainer's float64 run on
the same draws), runs the port's trainer from that init on those draws at
the config's full width, and prints one JSON line: batch 0's components
against the JAX trainer's (bar 1e-5 relative), each epoch's mean components
(bar 1e-3 relative), the per-batch drift curve (each batch's largest
relative difference over the components), the final parameters' relative
differences (a tensor's norm; the biases that feed a training-mode
BatchNorm, whose exact gradient is 0, apart), with the joint state the
final SINDy mask (bar: equal), Xi, the projector Q Q^T, L_prev, each
epoch's means against the JAX float64 run (the port's and the JAX f32
run's distances) and the singular values next to Q's cutoff, the epoch
walls and the card's name and power limit. ``replay_dp`` replays it data
parallel (parallel/dp.py) on a list of devices, every rank from the same
init on the same draws.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import resolve_device

BATCH0_REL = 1e-5
EPOCH_REL = 1e-3


def _tree(z, prefix: str) -> dict:
    """The subtree under ``prefix`` of a dump, nested (sequence indices as
    tuples)."""
    from ..convert import _nest

    flat = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    tree = _nest(flat)
    tree["g"] = {f: tuple(v[i] for i in sorted(v)) for f, v in tree["g"].items()}
    return tree


def _sindy_final(got: dict, want: dict) -> dict:
    """The port's joint SINDy state against the JAX trainer's final one."""
    rel_of = lambda a, b: float((a.double() - b.double()).norm()
                                / b.double().norm().clamp_min(1e-30))
    out = {"mask_equal": bool(torch.equal(got["mask"].cpu(), want["mask"].cpu())),
           "mask": got["mask"].cpu().tolist(), "jax_mask": want["mask"].cpu().tolist(),
           "Xi_rel": rel_of(got["Xi"].detach(), want["Xi"]),
           "Xi": got["Xi"].detach().cpu().tolist()}
    if "Q" in want:
        proj = lambda Q: Q.double() @ Q.double().T
        out["QQt_max_abs_diff"] = float((proj(got["Q"]) - proj(want["Q"])).abs().max())
        out["L_prev_rel"] = rel_of(got["L_prev"], want["L_prev"])
    return out


def _global_rel(got: dict, want: dict, keep) -> float:
    """||got - want|| over ||want|| across every tensor whose name ``keep``
    accepts (the parameters, or the BatchNorm running statistics)."""
    keys = [k for k in want if keep(k) and not k.endswith("num_batches_tracked")]
    flat = lambda d: torch.cat([d[k].detach().double().reshape(-1).cpu() for k in keys])
    if not keys:
        return 0.0
    return float((flat(got) - flat(want)).norm() / flat(want).norm().clamp_min(1e-30))


def _rel(a: float, b: float) -> float:
    return float(abs(a - b) / max(abs(b), 1e-12))


def replay(path: str, device=None, dtype: torch.dtype = torch.float32, dp=None) -> dict:
    """The replay's record (module docstring). With ``dtype`` float64 the
    port runs in float64 and is held to the JAX trainer's float64 run of a
    joint dump (batch64/, epoch64/, mask64) instead of its f32 one: the
    arithmetic, free of the rounding the f32 runs amplify. ``dp``: this
    rank of a data-parallel replay (``replay_dp``)."""
    from ..cli.main import build_trainer
    from ..convert import lassi_from_jax
    from ..models import lie_generator as lg
    from ..utils.config import get_args

    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        args = vars(get_args(["--config", str(z["config"])] + [str(f) for f in z["flags"]]))
        args["input_dim"] = int(z["x"].shape[-1])
        x = torch.as_tensor(z["x"], device=device, dtype=dtype)
        dx = torch.as_tensor(z["dx"], device=device, dtype=dtype) if "dx" in z.files else None
        perm, coef = z["perm"], z["coef"]
        init, final = _tree(z, "init/"), _tree(z, "final/")
        ref_batch = {k[len("batch/"):]: z[k] for k in z.files if k.startswith("batch/")}
        ref_epoch = {k[len("epoch/"):]: z[k] for k in z.files if k.startswith("epoch/")}
        ref_epoch64 = {k[len("epoch64/"):]: z[k] for k in z.files if k.startswith("epoch64/")}
        mask64 = z["mask64"] if "mask64" in z.files else None
        bit_equal = z["bit_equal"].tolist()
        if dtype == torch.float64:
            if mask64 is None:
                raise ValueError(f"{path} holds no float64 run of the JAX trainer")
            ref_batch = {k[len("batch64/"):]: z[k] for k in z.files if k.startswith("batch64/")}
            ref_epoch = dict(ref_epoch64)
    tr = build_trainer(args, device, steps_per_epoch=int(perm.shape[1]), dp=dp)
    spec, hp = tr.spec, tr.hp
    joint = "sindy_carry" in init
    tr.load_state(*lassi_from_jax(init, init["batch_stats"], device, dtype,
                                  sindy_carry=init.get("sindy_carry") if joint else None),
                  dtype=dtype)
    epochs, walls, drift, means = perm.shape[0], [], [], []
    for e in range(epochs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        mean, per = tr.epoch(x, perm=perm[e],
                             coef=torch.as_tensor(coef[e], device=device, dtype=dtype),
                             per_batch=True, dx_data=dx)
        per = {k: v.double().cpu().numpy() for k, v in per.items()}
        walls.append(time.perf_counter() - t0)
        if hp.gan_st_freq > 0 and (e + 1) % hp.gan_st_freq == 0:
            tr.set_threshold()
        if tr.sindy_adam and hp.st_freq > 0 and (e + 1) % hp.st_freq == 0:
            tr.set_sindy_threshold()
        means.append({k: float(v) for k, v in mean.items()})
        drift.append([max(_rel(per[k][b], ref_batch[k][e, b]) for k in per
                          if ref_batch[k][e, b] != 0.0 or per[k][b] != 0.0)
                      for b in range(perm.shape[1])])
        if e == 0:
            batch0 = {k: {"port": float(per[k][0]), "jax": float(ref_batch[k][0, 0]),
                          "rel": _rel(per[k][0], ref_batch[k][0, 0])} for k in per}
    epoch_rel = [{k: _rel(means[e][k], float(ref_epoch[k][e])) for k in means[e]
                  if ref_epoch[k][e] != 0.0 or means[e][k] != 0.0} for e in range(epochs)]
    want_ae, want_d, want_g, *want_s = lassi_from_jax(
        final, final["batch_stats"], device,
        sindy_carry=final.get("sindy_carry") if joint else None)
    rel_of = lambda got, want: float((got.double() - want.double()).norm()
                                     / want.double().norm().clamp_min(1e-30))
    got_ae, got_d = tr.ae.state_dict(), tr.disc.state_dict()
    # biases that feed a training-mode BatchNorm have an exact gradient of 0:
    # Adam moves them by up to lr a step on the sign of rounding, in either
    # package, so they are reported apart
    bn_fed = ({k for k in want_ae if k.startswith("encoder.dense.") and k.endswith(".bias")}
              | {"encoder.out.bias"}) if args["batch_norm"] else set()
    ae_rel = {k: rel_of(got_ae[k], v) for k, v in want_ae.items()
              if not k.endswith("num_batches_tracked")}
    final_rel = {
        "ae": max(v for k, v in ae_rel.items() if k not in bn_fed),
        "ae_worst": sorted(((k, v) for k, v in ae_rel.items() if k not in bn_fed),
                           key=lambda kv: -kv[1])[:3],
        "ae_bn_fed_bias_max_abs_diff": max(
            (float((got_ae[k] - want_ae[k]).abs().max()) for k in bn_fed), default=0.0),
        "d": max(rel_of(got_d[k], v) for k, v in want_d.items()),
        "Li": [rel_of(a.detach(), b) for a, b in zip(tr.g_state.Li, want_g.Li)],
        "masks_equal": all(bool(torch.equal(a, b)) for a, b in zip(tr.g_state.masks,
                                                                   want_g.masks)),
        # over all the tensors at once (tests/test_dp_lassi.py's measure)
        "ae_global": _global_rel(got_ae, want_ae, lambda k: "running" not in k),
        "bn_stats_global": _global_rel(got_ae, want_ae, lambda k: "running" in k)}
    b0 = max(v["rel"] for v in batch0.values())
    ep = max(max(r.values()) for r in epoch_rel)
    out = {"phase": "replay_lassi", "draws": path, "config": args["config"],
           "device": str(device), "windows": int(x.shape[0]),
           "batches_per_epoch": int(perm.shape[1]), "epochs": epochs,
           "dump_bit_equal": bit_equal, "batch0": batch0, "batch0_max_rel": b0,
           "batch0_ok": b0 <= BATCH0_REL, "epoch_means": means, "epoch_rel": epoch_rel,
           "epoch_max_rel": ep, "epoch_ok": ep <= EPOCH_REL, "drift_per_batch": drift,
           "final_rel": final_rel, "epoch_walls_s": walls,
           "Li": [L.detach().cpu().tolist() for L in lg.getLi(spec, tr.g_state)]}
    if joint:
        sf = _sindy_final(tr.sindy, want_s[0])
        if dtype == torch.float64:  # held to the float64 run's mask
            sf["mask_equal"] = bool(np.array_equal(tr.sindy["mask"].cpu().numpy(), mask64))
        if mask64 is not None:
            sf["mask_equal_jax_f64"] = bool(np.array_equal(tr.sindy["mask"].cpu().numpy(),
                                                           mask64))
        out.update(sindy_final=sf, mask_ok=sf["mask_equal"], q_sv=tr.q_sv_margin())
    if ref_epoch64:
        out["epoch_rel_jax_f64"] = [{k: _rel(means[e][k], float(ref_epoch64[k][e]))
                                     for k in means[e] if ref_epoch64[k][e] != 0.0}
                                    for e in range(epochs)]
        out["jax_f32_epoch_rel_jax_f64"] = [{k: _rel(float(ref_epoch[k][e]),
                                                     float(ref_epoch64[k][e]))
                                             for k in means[e] if ref_epoch64[k][e] != 0.0}
                                            for e in range(epochs)]
    if device.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    return out


def _replay_rank(dp, device, path: str, dtype) -> dict:
    return dict(replay(path, device, dtype, dp=dp), all_reduces=dp.all_reduces)


def replay_dp(path: str, devices, backend: str = None,
              dtype: torch.dtype = torch.float32) -> dict:
    """``replay`` data parallel, one process a device of ``devices`` (a
    device may repeat; parallel/dp.launch): rank 0's record, with the
    all-reduces it made."""
    from ..parallel.dp import launch

    return dict(launch(_replay_rank, devices, backend, (path, dtype)),
                dp_devices=[str(d) for d in devices])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", required=True, help="a tools/dump_jax_draws.py --lassi file")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--float64", action="store_true",
                    help="run in float64 against the JAX trainer's float64 run (a joint dump)")
    a = ap.parse_args(argv)
    dtype = torch.float64 if a.float64 else torch.float32
    print(json.dumps(dict(replay(a.draws, a.device, dtype), dtype=str(dtype))), flush=True)


if __name__ == "__main__":
    main()
