"""Weak SINDy entry point of the port, driven by the same run_configs/*.cfg
files as the JAX package's cli/main_wsindy.py.

    python -m symmetry_ode_discovery_tpu_torch.cli.main_wsindy \
        --config lv/noise99_eq_wsindy.cfg --n_seeds 50 --seed 0 --subsample_rng ref

Per seed: one trajectory and a window of 80% of its steps, num_epochs
weak-form solves with the threshold, scored against the task's ground
truth; all seeds in one batched solve. The windows:
- --subsample_rng ref: the reference's own draws (numpy's RandomState(seed),
  recomputed on the host);
- --subsample_rng jax (the default's name): the port's own torch draws, not
  the JAX package's;
- --subsample_perms <file>: a file keyed by seed (``seeds``, ``start``,
  ``traj``), e.g. the JAX package's draws from tools/dump_jax_draws.py.
Eval npz files go under --eval_root, the first seed's regressor.npz (Xi,
mask) under --save_root/<save_dir>. --mesh_devices shards the seeds as
cli/main_sindy.py does.
"""

from __future__ import annotations

import time

import numpy as np


def load_windows(path: str, seeds) -> np.ndarray:
    """(n_seeds, 2) (start, trajectory) of ``seeds`` from a draws file
    keyed by seed (``seeds``, ``start``, ``traj``)."""
    with np.load(path) as z:
        dump_seeds = [int(s) for s in z["seeds"]]
        rows = [dump_seeds.index(s) for s in seeds]
        return np.stack([np.asarray(z["start"])[rows], np.asarray(z["traj"])[rows]], axis=1)


def run(args: dict, train_data=None, device=None) -> dict:
    """WSINDy for the parsed flags ``args`` on ``device`` (the card unless
    given); ``train_data`` (x, dx), x (n_ics, n_steps, dim), replaces the
    cached or generated training split. Returns the per-seed result dicts,
    Xi, mask and the windows."""
    import torch

    from .. import resolve_device
    from ..data.datasets import get_dataset, ode_dt_dict
    from ..evaluation.eval_eq import sindy_truth
    from ..models.sindy import make_config
    from ..training.sweep import sweep_wsindy, wsindy_windows
    from .main_sindy import save_outputs

    t_start = time.perf_counter()
    device = resolve_device(device)
    if train_data is None:
        train_ds, args = get_dataset(args, device)
        x = train_ds.trajs_x
    else:
        x = torch.as_tensor(train_data[0], dtype=torch.float32, device=device)
        args["input_dim"] = x.shape[-1]
    cfg, _ = make_config(args["input_dim"], poly_order=args["poly_order"],
                         include_sine=args["include_sine"], include_exp=args["include_exp"],
                         threshold=args["threshold"])
    seeds = list(range(args["seed"], args["seed"] + args.get("n_seeds", 1)))
    n_ics, n_steps = x.shape[0], x.shape[1]
    if args.get("subsample_perms"):
        windows = load_windows(args["subsample_perms"], seeds)
    else:
        windows = wsindy_windows(seeds, n_ics, n_steps, int(0.8 * n_steps),
                                 args.get("subsample_rng", "jax"))
    res = sweep_wsindy(cfg, x, ode_dt_dict[args["task"]], sindy_truth[args["task"]], seeds,
                       w_sindy_reg=args["w_sindy_reg"], threshold=args["threshold"],
                       num_epochs=args["num_epochs"], windows=windows, device=device,
                       n_mesh_devices=args.get("mesh_devices", 0))
    results = save_outputs(args, res, seeds, t_start)
    if len(seeds) == 1:
        print(f"MSE (any): {results[0]['mse']}")
    return {"results": results, "Xi": res.Xi, "mask": res.mask, "windows": windows}


def main(argv=None):
    from ..utils.config import get_args
    from ..utils.watchdog import probe_first_dispatch

    args = vars(get_args(argv))
    probe_first_dispatch()  # a stalled first CUDA dispatch: relaunch once, then exit 42
    return run(args)


if __name__ == "__main__":
    main()
