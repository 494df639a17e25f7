"""Direct-STLSQ SINDy entry point of the port, driven by the same
run_configs/*.cfg files as the JAX package's cli/main_sindy.py.

    python -m symmetry_ode_discovery_tpu_torch.cli.main_sindy \
        --config dosc/noise20_sindy.cfg --n_seeds 50 --seed 0

Per seed: all training rows in the seed's own order (torch.Generator(device)
seeded 2s, training/sweep.py), then max(5, num_epochs // 20) iterations of
the masked ridge least-squares solve and the threshold, scored against the
task's ground truth. The configuration is built without generators, as the
JAX CLI builds it, so the sweep is unconstrained. --subsample_perms replaces
the row orders with a file keyed by seed (``seeds``, ``idx``). Eval npz
files go under --eval_root, the first seed's regressor.npz (Xi, mask) under
--save_root/<save_dir>. --mesh_devices shards the seeds over that many CUDA
devices (0: every one when the sweep runs on the card; ValueError when
fewer exist), as training/sweep.py sets out.
"""

from __future__ import annotations

import os
import time

import numpy as np


def save_root(args: dict) -> str:
    """--save_root, else $SODT_TORCH_SAVE_PATH, else
    ~/.cache/symmetry_ode_discovery_tpu_torch/saved_models."""
    return args.get("save_root") or os.environ.get(
        "SODT_TORCH_SAVE_PATH",
        os.path.join(os.path.expanduser("~"), ".cache", "symmetry_ode_discovery_tpu_torch",
                     "saved_models"))


def save_outputs(args: dict, res, seeds, t_start: float) -> list:
    """Each seed's eval npz, the first seed's regressor.npz, and the JAX
    CLIs' closing lines; returns the per-seed result dicts."""
    from ..evaluation.eval_eq import save_eval_results

    eval_root, save_dir = args.get("eval_root", "eval_results"), args["save_dir"]
    results = res.results_list()
    for r, s in zip(results, seeds):
        save_eval_results(r, save_dir, int(s), eval_root)
    out = os.path.join(save_root(args), save_dir)
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "regressor.npz"), Xi=res.Xi[0], mask=res.mask[0])
    if len(seeds) == 1:
        print("\n=== Evaluation ===\n")
        print(f"Correct form: {results[0]['correct_form']}")
        print(f"MSE: {np.where(results[0]['correct_form'], results[0]['mse'], 0.0)}")
    else:
        print(f"Swept {len(seeds)} seeds in {time.perf_counter() - t_start:.1f} s "
              f"-> {eval_root}/{save_dir}")
    return results


def run(args: dict, train_data=None, device=None) -> dict:
    """STLSQ for the parsed flags ``args`` (a dict, as from
    ``vars(get_args(argv))``) on ``device`` (the card unless given);
    ``train_data`` (x, dx) replaces the cached or generated training
    split. Returns the per-seed result dicts and the sweep's Xi and mask."""
    import torch

    from .. import resolve_device
    from ..data.datasets import get_dataset
    from ..evaluation.eval_eq import sindy_truth
    from ..models.sindy import make_config
    from ..training.sweep import sweep_sindy_stlsq
    from .main import load_draws

    t_start = time.perf_counter()
    device = resolve_device(device)
    if train_data is None:
        train_ds, args = get_dataset(args, device)
        x, dx = train_ds.x, train_ds.dx
    else:
        x, dx = (torch.as_tensor(a, dtype=torch.float32, device=device).reshape(-1, a.shape[-1])
                 for a in train_data)
        args["input_dim"] = x.shape[-1]
    cfg, Q = make_config(args["input_dim"], poly_order=args["poly_order"],
                         include_sine=args["include_sine"], include_exp=args["include_exp"],
                         threshold=args["threshold"])
    seeds = list(range(args["seed"], args["seed"] + args.get("n_seeds", 1)))
    idx = load_draws(args["subsample_perms"], seeds)[0] if args.get("subsample_perms") else None
    res = sweep_sindy_stlsq(cfg, Q, x, dx, sindy_truth[args["task"]], seeds,
                            w_sindy_reg=args["w_sindy_reg"], threshold=args["threshold"],
                            max_iter=max(5, args["num_epochs"] // 20), subsample_idx=idx,
                            device=device, n_mesh_devices=args.get("mesh_devices", 0))
    return {"results": save_outputs(args, res, seeds, t_start), "Xi": res.Xi, "mask": res.mask}


def main(argv=None):
    from ..utils.config import get_args

    return run(vars(get_args(argv)))


if __name__ == "__main__":
    main()
