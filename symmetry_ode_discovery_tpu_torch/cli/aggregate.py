"""Success rates and RMSE of a sweep's per-seed eval npz files.

    python -m symmetry_ode_discovery_tpu_torch.cli.aggregate esindy-noise20-dosc --max_seed 50

Prints what the JAX package's cli/aggregate.py prints for the same run
directory (evaluation/eval_eq.py::aggregate_run). --impute_nan is the
notebook variant: NaN RMSE entries are replaced by the largest RMSE seen
before averaging.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from ..evaluation.eval_eq import aggregate_run, load_seed_results

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("run_name")
    parser.add_argument("--min_seed", type=int, default=0)
    parser.add_argument("--max_seed", type=int, default=100)
    parser.add_argument("--mse_multiplier", type=float, default=1.0)
    parser.add_argument("--result_dir", type=str, default="eval_results")
    parser.add_argument("--impute_nan", action="store_true",
                        help="notebook variant: impute NaN RMSE with the max")
    args = parser.parse_args(argv)

    if not args.impute_nan:
        aggregate_run(args.run_name, args.min_seed, args.max_seed, args.mse_multiplier,
                      args.result_dir)
        return

    cf, mse, cf_all, mse_all = load_seed_results(
        os.path.join(args.result_dir, args.run_name), args.min_seed, args.max_seed)
    cf = np.stack(cf)
    n = cf.shape[0]
    print(f"Loaded results from {n} runs.")
    for i in range(cf.shape[1]):
        print(f"Equation {i} success rate = {int(cf[:, i].sum())}/{n}")
    print(f"Joint success rate = {int(np.sum(cf_all))}/{n}")
    mm = args.mse_multiplier
    rmse = np.sqrt(np.stack(mse))
    rmse[np.isnan(rmse)] = np.max(rmse[~np.isnan(rmse)])
    for i in range(rmse.shape[1]):
        sel = np.where(cf[:, i])
        print(f"Equation {i} RMSE = {np.mean(rmse[sel, i]) * mm:.4f} "
              f"({np.std(rmse[sel, i]) * mm:.4f})")
        print(f"Equation {i} RMSE (any) = {np.mean(rmse[:, i]) * mm:.4f} "
              f"({np.std(rmse[:, i]) * mm:.4f})")
    rmse_all = np.sqrt(np.asarray(mse_all))
    rmse_all[np.isnan(rmse_all)] = np.max(rmse_all[~np.isnan(rmse_all)])
    sel = np.where(cf_all)
    print(f"All equations RMSE = {np.mean(rmse_all[sel]) * mm:.4f} "
          f"({np.std(rmse_all[sel]) * mm:.4f})")
    print(f"All equations RMSE (any) = {np.mean(rmse_all) * mm:.4f} "
          f"({np.std(rmse_all) * mm:.4f})")


if __name__ == "__main__":
    main()
