"""Success-vs-noise curves of the port: plain SINDy, EquivSINDy-c and
WSINDy over a system's noise levels, one K1 launch per L-BFGS curve.

    python -m symmetry_ode_discovery_tpu_torch.cli.noise_curve --system dosc \
        [--methods sindy esindy] [--n_seeds 50] [--levels 0 0.05 0.1 0.15 0.2] \
        [--eval_root eval_results] [--perms_dir DIR] [--device cpu] \
        [--mesh_devices N] [--no_save]

The counterpart of the JAX package's tools/noise_curve.py, with its
protocols (``make_protocol``, each the run_configs/{system}/ file it names)
and its outputs: ``{eval_root}/noisecurve-{system}-{method}-noise{NN}/
seed{K}.npz`` in the evaluation schema, a table of joint successes per level
and one JSON line. A SINDy or EquivSINDy-c curve is one stacked sweep
(training/sweep.py::sweep_sindy_lbfgs_stacked): levels x seeds lanes of the
whole L-BFGS protocol in one launch of csrc/lbfgs_sweep.cu (one a shard
with --mesh_devices). WSINDy (10 weak-form solves of one random window of
80% of a trajectory a seed) is one sweep_wsindy a level.

Data: each level's train split from the cache directory
($SODT_TORCH_DATA_PATH, data/datasets.py), which may hold the JAX package's
caches; a level without a cache is generated (the levels together in one
RK4 solve, data/generate.py::gen_data_levels, with the cache's seeds),
written there, and named on stderr.

Draws: the port's own (training/sweep.py), or, with --perms_dir, the files
of tools/dump_jax_draws.py for the method's run_configs file, named
``noisecurve-{system}-{method}-noise{NN}.npz`` for one level or
``noisecurve-{system}-{method}.npz`` for every level (the draws depend on
the row and trajectory counts only, which the levels share): ``idx`` and
``theta0`` for the L-BFGS methods, ``start`` and ``traj`` for WSINDy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ALL_LEVELS = [0.0, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.99]

# Fixed-group generators (reference gan.py construct_group_representation)
SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]], dtype=np.float32)
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]], dtype=np.float32)

WSINDY_EPOCHS = 10


def make_protocol(system, method):
    """(make_config kwargs, LBFGSHParams kwargs, lbfgs_subsample)."""
    if method == "sindy":
        if system == "lv":
            # run_configs/lv/noise99_eq_sindy_2.cfg
            return (dict(poly_order=2, include_exp=True, threshold=0.15),
                    dict(num_epochs=100, lr_sindy=0.1, st_freq=20,
                         threshold=0.15), 0.01)
        if system == "selkov":
            # run_configs/selkov/noise20_eq_sindy.cfg: poly3, 7.5e-2
            return (dict(poly_order=3, threshold=7.5e-2),
                    dict(num_epochs=200, lr_sindy=1.0, st_freq=50,
                         threshold=7.5e-2), 0.5)
        lr = 0.1 if system == "dosc" else 1.0
        # run_configs/{dosc,growth}/noise*_sindy.cfg
        return (dict(poly_order=2, threshold=5e-2),
                dict(num_epochs=200, lr_sindy=lr, st_freq=50,
                     threshold=5e-2), 0.5)
    if method == "esindy":
        if system == "dosc":
            # run_configs/dosc/noise20_esindy.cfg: (1,so2), threshold 1e-2
            return (dict(poly_order=2, L_list=[SO2], threshold=1e-2),
                    dict(num_epochs=100, lr_sindy=1.0, st_freq=100,
                         threshold=1e-2), 0.5)
        if system == "growth":
            # run_configs/growth/noise05_esindy.cfg: scaling2 + const column
            return (dict(poly_order=2, L_list=[SCALING2],
                         constrain_constant=True, threshold=5e-2),
                    dict(num_epochs=100, lr_sindy=1.0, st_freq=100,
                         threshold=5e-2), 0.5)
        raise SystemExit(f"no fixed-group esindy protocol for {system} "
                         "(the reference constrains only dosc/growth)")
    if method == "wsindy":
        # run_configs/*/noise*_wsindy.cfg
        if system == "lv":
            return (dict(poly_order=2, include_exp=True, threshold=0.15),
                    dict(w_sindy_reg=0.0, threshold=0.15), None)
        if system == "selkov":
            return (dict(poly_order=3, threshold=7.5e-2),
                    dict(w_sindy_reg=0.0, threshold=7.5e-2), None)
        reg = 0.05 if system == "growth" else 0.0
        return (dict(poly_order=2, threshold=5e-2),
                dict(w_sindy_reg=reg, threshold=5e-2), None)
    raise SystemExit(f"unknown method {method}")


def level_tag(nl: float) -> str:
    return f"noise{int(100 * nl):02d}"


def gen_levels(system: str, levels, device):
    """[(x, dx)] of ``system``'s GP-smoothed train split at each level,
    generated in one RK4 solve, each level with its cache seed: (n_ics,
    n_steps, dim) float32 on ``device``."""
    import torch

    from ..data import SYSTEMS
    from ..data.datasets import cache_seed
    from ..data.generate import gen_data_levels

    sys_ = SYSTEMS[system]
    gens = [torch.Generator(device=device).manual_seed(cache_seed("train", nl))
            for nl in levels]
    return gen_data_levels(sys_, gens, list(levels),
                           multiplicative_noise=sys_.multiplicative_noise,
                           smoothing="gp", device=device)


def load_levels(system: str, levels, device):
    """gen_levels' splits read from the cache directory, or generated (the
    missing levels together) and written there. Returns (data, generated
    levels)."""
    from ..data.datasets import _cache_stem, data_path, load_or_generate, save_cache

    path = data_path()
    cached = {nl: os.path.exists(os.path.join(path, _cache_stem(system, "train", nl, "gp")
                                              + "-x.npy")) for nl in levels}
    missing = [nl for nl in levels if not cached[nl]]
    data = {nl: load_or_generate(system, "train", nl, "gp", device=device)
            for nl in levels if cached[nl]}
    if missing:
        print(f"noise_curve: generating {system} levels {missing} (no cache in {path})",
              file=sys.stderr)
        for nl, (x, dx) in zip(missing, gen_levels(system, missing, device)):
            save_cache(os.path.join(path, _cache_stem(system, "train", nl, "gp")), x, dx)
            data[nl] = (x, dx)
    return [data[nl] for nl in levels], missing


def load_draws(perms_dir: str, system: str, method: str, level: float, seeds) -> dict:
    """The rows of ``seeds`` in the draws file of (system, method) at
    ``level``: that level's file, else the one for every level."""
    stem = os.path.join(perms_dir, f"noisecurve-{system}-{method}")
    for path in (f"{stem}-{level_tag(level)}.npz", f"{stem}.npz"):
        if os.path.exists(path):
            with np.load(path) as z:
                dump_seeds = [int(s) for s in z["seeds"]]
                missing = [s for s in seeds if s not in dump_seeds]
                if missing:
                    raise ValueError(f"{path}: no draws for seeds {missing}")
                rows = [dump_seeds.index(s) for s in seeds]
                return {k: np.asarray(z[k])[rows] for k in z.files
                        if k not in ("seeds", "branch")}
    raise FileNotFoundError(f"no draws for {system} {method} at {level}: "
                            f"{stem}-{level_tag(level)}.npz or {stem}.npz")


def run_method(system: str, method: str, levels, data, seeds, device, perms_dir=None,
               n_mesh_devices=None):
    """One curve: a SweepResult per level."""
    from ..data.datasets import ode_dt_dict
    from ..evaluation.eval_eq import sindy_truth
    from ..models.sindy import make_config
    from ..training.siged import LBFGSHParams
    from ..training.sweep import sweep_sindy_lbfgs_stacked, sweep_wsindy

    cfg_kw, hp_kw, subsample = make_protocol(system, method)
    cfg, Q = make_config(2, **cfg_kw)
    truth = sindy_truth[system]
    draws = [None if perms_dir is None else load_draws(perms_dir, system, method, nl, seeds)
             for nl in levels]
    if method == "wsindy":
        return [sweep_wsindy(cfg, x, ode_dt_dict[system], truth, seeds,
                             w_sindy_reg=hp_kw["w_sindy_reg"], threshold=hp_kw["threshold"],
                             num_epochs=WSINDY_EPOCHS,
                             windows=None if d is None else np.stack([d["start"], d["traj"]], 1),
                             device=device, n_mesh_devices=n_mesh_devices)
                for (x, _), d in zip(data, draws)]
    hp = LBFGSHParams(w_sindy_x=1.0, w_sindy_reg=0.0, sindy_reg_type="l1", **hp_kw)
    xs = [x.reshape(-1, x.shape[-1]) for x, _ in data]
    dxs = [dx.reshape(-1, dx.shape[-1]) for _, dx in data]
    given = perms_dir is not None
    return sweep_sindy_lbfgs_stacked(
        cfg, Q, xs, dxs, truth, hp, seeds, lbfgs_subsample=subsample,
        subsample_idx=[d["idx"] for d in draws] if given else None,
        theta0=[d["theta0"] for d in draws] if given else None,
        device=device, n_mesh_devices=n_mesh_devices)


def run(opts) -> dict:
    """The curves of ``opts`` (the parsed flags); returns the JSON record."""
    import torch

    from .. import resolve_device
    from ..evaluation.eval_eq import save_eval_results
    from ..ops import lbfgs_sweep

    device = resolve_device(opts.device)
    levels = list(opts.levels)
    data, generated = load_levels(opts.system, levels, device)
    seeds = list(range(opts.n_seeds))
    summary, walls, launches = {}, {}, {}
    for method in opts.methods:
        def curve():
            return run_method(opts.system, method, levels, data, seeds, device,
                              opts.perms_dir, opts.mesh_devices)

        if device.type == "cuda":
            curve()  # the kernel's build and first launch
            torch.cuda.synchronize(device)
        before = lbfgs_sweep.launches
        t0 = time.perf_counter()
        results = curve()
        walls[method] = time.perf_counter() - t0
        launches[method] = lbfgs_sweep.launches - before
        rows = {}
        for nl, res in zip(levels, results):
            rows[f"{nl:.2f}"] = int(np.all(res.correct_form > 0, axis=1).sum())
            if not opts.no_save:
                for s, r in zip(seeds, res.results_list()):
                    save_eval_results(r, f"noisecurve-{opts.system}-{method}-{level_tag(nl)}",
                                      s, root=opts.eval_root)
        summary[method] = rows

    print(f"\n  {opts.system}: joint success /{opts.n_seeds} vs noise")
    print(f"  {'noise':>6} " + " ".join(f"{m:>8}" for m in opts.methods))
    for nl in levels:
        k = f"{nl:.2f}"
        print(f"  {k:>6} " + " ".join(f"{summary[m][k]:>8}" for m in opts.methods))
    print()
    rec = {
        "metric": f"{opts.system}_noise_curve",
        "n_seeds": opts.n_seeds, "levels": [f"{nl:.2f}" for nl in levels],
        "generated_levels": [f"{nl:.2f}" for nl in generated],
        "draws": "port" if opts.perms_dir is None else opts.perms_dir,
        "success_by_noise": summary,
        "wall_s": walls,
        "lbfgs_sweep_launches": launches,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
    }
    print(json.dumps(rec), flush=True)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--system", required=True, choices=["dosc", "growth", "lv", "selkov"])
    ap.add_argument("--methods", nargs="+", default=["sindy", "esindy"],
                    choices=["sindy", "esindy", "wsindy"])
    ap.add_argument("--n_seeds", type=int, default=50)
    ap.add_argument("--levels", nargs="+", type=float, default=ALL_LEVELS,
                    help="noise levels (default: all thirteen)")
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--eval_root", default="eval_results")
    ap.add_argument("--perms_dir", default=None,
                    help="tools/dump_jax_draws.py files, one per method (and level)")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    ap.add_argument("--mesh_devices", type=int, default=None,
                    help="shard the seeds over this many CUDA devices")
    return ap.parse_args(argv)


def main(argv=None):
    from ..utils.watchdog import probe_first_dispatch

    opts = parse_args(argv)
    # a stalled first CUDA dispatch: relaunch once, then exit 42 (0 s on the CPU)
    probe_first_dispatch(opts.device)
    run(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
