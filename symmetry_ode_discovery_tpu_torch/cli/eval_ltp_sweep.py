"""Long-term-prediction (LTP) evaluation of a completed discovery sweep.

The port's counterpart of symmetry_ode_discovery_tpu/cli/eval_ltp_sweep.py:
load every seed's discovered coefficient matrix from
``<eval_root>/<save_dir>/seed{N}.npz``, roll the discovered dynamics out with
RK4 from the clean validation trajectories' initial states, and report the
long-term prediction error against the ground-truth trajectories, split by
form-correct and wrong-form seeds, with the ground-truth coefficients rolled
out the same way as the attainable floor (RK4 at the sample spacing against
the generator's finer steps).

All seeds and the truth roll out in one batched RK4 over an (S, n_ics, d)
state: one batched product of the library with each row's coefficients a
stage. Rows are independent, so a seed that diverges goes inf/NaN in its
own row only; the summary counts it out of the median.

The clean validation trajectories (noise 0, no smoothing) are the port's
cache under $SODT_TORCH_DATA_PATH, or generated there on a miss; a
directory holding the JAX package's caches gives its trajectories.

    python -m symmetry_ode_discovery_tpu_torch.cli.eval_ltp_sweep \
        --config lv/noise99_eq_sindy_2.cfg [--eval_root DIR]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device


def ltp_sweep_errors(cfg, coefs, x, dt, device=None) -> torch.Tensor:
    """Relative LTP error for a stack of coefficient matrices.

    coefs: (S, d, p) masked coefficient matrices; x: (n_ics, n_steps, d)
    ground-truth trajectories (tensors keep their device; arrays go to
    ``device``), both taken in float32. Returns (S, n_ics, n_steps - 1):
    the per-step squared error averaged over dims, over the trajectory's
    time-variance averaged over dims."""
    from ..ops.integrators import odeint

    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = torch.as_tensor(np.array(x) if not isinstance(x, torch.Tensor) else x,
                        dtype=torch.float32, device=dev)
    A = torch.as_tensor(np.array(coefs) if not isinstance(coefs, torch.Tensor) else coefs,
                        dtype=torch.float32, device=dev).mT  # (S, p, d)
    n_ics, n_steps, d = x.shape
    scale = x.var(dim=1, unbiased=False).mean(dim=-1)  # (n_ics,)
    lib = cfg.library
    x0 = x[:, 0].expand(A.shape[0], n_ics, d)
    with torch.no_grad():
        x_pred = odeint(lambda q: lib(q) @ A, x0, (n_steps - 1) * dt, dt, method="rk4",
                        full_traj=True, num_steps=n_steps - 1)  # (n_steps-1, S, n_ics, d)
        err = ((x[None, :, 1:] - x_pred.permute(1, 2, 0, 3)) ** 2).mean(dim=-1)
        return err / scale[:, None]


def _summ(rel, label):
    """Per-seed time-mean relative error -> robust summary line."""
    # plain mean: any non-finite step (diverged rollout) marks the whole
    # seed non-finite, and the median is taken over the surviving seeds
    per_seed = rel.reshape(rel.shape[0], -1).mean(axis=1) if rel.size else np.array([])
    finite = np.isfinite(per_seed)
    med = float(np.median(per_seed[finite])) if finite.any() else float("nan")
    print(f"  {label}: n={len(per_seed)}, finite={int(finite.sum())}, "
          f"median rel. MSE={med:.4g}")
    return {"n": len(per_seed), "finite": int(finite.sum()), "median": med,
            "per_seed": per_seed}


def load_coefs(run_dir: str):
    """(coefs, a list of (d, p), correct (S,) bool) of every seed{N}.npz
    under ``run_dir``, in the JAX CLI's (sorted file name) order."""
    coefs, correct = [], []
    for fn in sorted(os.listdir(run_dir) if os.path.isdir(run_dir) else []):
        if not (fn.startswith("seed") and fn.endswith(".npz")):
            continue
        with np.load(os.path.join(run_dir, fn)) as z:
            coefs.append(z["coefficients"])
            correct.append(bool(np.all(z["correct_form"] > 0)))
    return coefs, np.asarray(correct)


def run(args: dict, device=None, x_val=None) -> dict:
    """LTP summary of the sweep ``<eval_root>/<save_dir>`` for the parsed
    flags ``args``: 'all', 'correct_form', 'wrong_form' and (where the task
    has one) 'truth_floor', each {'n', 'finite', 'median', 'per_seed'}, and
    'seconds' (the rollout's wall). ``x_val`` (n_ics, n_steps, d) replaces
    the clean validation trajectories."""
    from ..data.datasets import ODEDataset, ode_dt_dict
    from ..evaluation.eval_eq import sindy_truth
    from ..models.sindy import make_config

    device = resolve_device(device)
    task = args["task"]
    run_name = args["save_dir"]
    eval_root = args.get("eval_root", "eval_results")
    if x_val is None:
        x_val = ODEDataset.make(task, "val", noise=0.0, smoothing=None,
                                device=device).trajs_x
    x = torch.as_tensor(np.array(x_val) if not isinstance(x_val, torch.Tensor) else x_val,
                        dtype=torch.float32, device=device)
    dt = ode_dt_dict[task]

    # the coefficients are in the unconstrained layout of the run's library
    # (the seed npz holds Xi * mask); the constraint only reparameterises
    cfg, _ = make_config(args["latent_dim"], poly_order=args["poly_order"],
                         include_sine=args["include_sine"], include_exp=args["include_exp"],
                         threshold=args["threshold"])
    coefs, correct = load_coefs(os.path.join(eval_root, run_name))
    if not coefs:
        raise SystemExit(f"no seed npz under {eval_root}/{run_name}")
    coefs = np.stack(coefs)
    if coefs.shape[-1] != cfg.n_terms:
        raise SystemExit(
            f"library mismatch: run has p={coefs.shape[-1]}, config builds "
            f"p={cfg.n_terms} — pass the run's own --config")
    truth = sindy_truth.get(task)
    if truth is not None and truth.shape != coefs.shape[1:]:
        raise SystemExit(
            f"truth table for {task!r} is {truth.shape} but the run's "
            f"coefficients are {coefs.shape[1:]} — the run used a different "
            f"library than the task's evaluation basis")
    stack = np.concatenate([coefs, truth[None]], axis=0) if truth is not None else coefs
    t0 = time.perf_counter()
    rel = ltp_sweep_errors(cfg, stack, x, dt).cpu().numpy()
    seconds = time.perf_counter() - t0
    rel_seeds, rel_truth = (rel[:-1], rel[-1:]) if truth is not None else (rel, None)

    print(f"LTP — {run_name}: {len(coefs)} seeds x {x.shape[0]} clean val "
          f"trajectories x {x.shape[1] - 1} steps (dt={dt}), {seconds:.3f} s")
    out = {
        "all": _summ(rel_seeds, "all seeds"),
        "correct_form": _summ(rel_seeds[correct], "correct-form seeds"),
        "wrong_form": _summ(rel_seeds[~correct], "wrong-form seeds"),
    }
    if rel_truth is not None:
        out["truth_floor"] = _summ(rel_truth, "ground-truth floor")
    out["seconds"] = seconds
    return out


def main(argv=None):
    from ..utils.config import get_args

    return run(vars(get_args(argv)))


if __name__ == "__main__":
    main()
