"""Equation-discovery evaluation: form recovery, coefficient MSE and the
multi-seed summary.

The port's own copy of symmetry_ode_discovery_tpu/evaluation/eval_eq.py
(ground-truth tables, per-seed metric, aggregation), in numpy.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

# Ground-truth coefficient matrices in the library's term order. lv uses
# poly2+exp ([1, z0, z1, z0z0, z0z1, z1z1, exp(z0), exp(z1)]); dosc and
# growth use poly2 (6 columns); selkov poly3 (10 columns).
sindy_truth: Dict[str, np.ndarray] = {
    "lv": np.array([
        [2 / 3, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -4 / 3],
        [-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    ]),
    "selkov": np.array([
        [0.75, -0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0],
        [0.0, 0.1, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    ]),
    "dosc": np.array([
        [0.0, -0.1, -1, 0.0, 0.0, 0.0],
        [0.0, 1, -0.1, 0.0, 0.0, 0.0],
    ]),
    "growth": np.array([
        [0.0, -0.3, 0.0, 0.0, 0.0, 0.1],
        [0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
    ]),
}


def eval_sindy_coefficients(coef: np.ndarray, mask: np.ndarray, truth: np.ndarray):
    """Score one fitted coefficient matrix against the ground truth.

    Correct form is an exact support match per equation; the MSE is taken
    over the truth's support whether or not the form is right.
    """
    coef = np.asarray(coef)
    mask = np.asarray(mask).astype(bool)
    coef = np.where(mask, coef, 0.0)
    truth_mask = truth != 0
    n_eqs = coef.shape[0]
    correct_form = np.zeros(n_eqs)
    mse = np.ones(n_eqs) * -1.0
    for i in range(n_eqs):
        correct_form[i] = np.all(mask[i, :] == truth_mask[i, :])
        mse[i] = np.mean((coef[i, truth_mask[i, :]] - truth[i, truth_mask[i, :]]) ** 2)
    return {
        "coefficients": coef,
        "correct_form": correct_form,
        "mse": mse,
        "correct_form_all": np.all(correct_form),
        "mse_all": np.mean(mse),
    }


def aggregate_results(results_list: list, mse_multiplier: float = 1.0,
                      verbose: bool = True) -> dict:
    """Success rates and RMSE statistics over per-seed result dicts (the
    schema of ``eval_sindy_coefficients`` and ``SweepResult.results_list``)."""
    cf = np.stack([r["correct_form"] for r in results_list])
    mse = [r["mse"] for r in results_list]
    cf_all = np.asarray([r["correct_form_all"] for r in results_list])
    mse_all = [r["mse_all"] for r in results_list]

    n = len(results_list)
    cf_sum = np.sum(cf, axis=0).astype(int)
    cf_all_sum = int(np.sum(cf_all))
    rmse = np.sqrt(np.stack(mse))
    rmse_all = np.sqrt(np.asarray(mse_all))

    summary = {
        "n_runs": n,
        "success_per_eq": cf_sum,
        "success_joint": cf_all_sum,
        "rmse_valid": [], "rmse_valid_std": [],
        "rmse_any": [], "rmse_any_std": [],
    }
    for i in range(cf.shape[1]):
        sel = np.where(cf[:, i])
        summary["rmse_valid"].append(float(np.mean(rmse[sel, i])) * mse_multiplier if len(sel[0]) else float("nan"))
        summary["rmse_valid_std"].append(float(np.std(rmse[sel, i])) * mse_multiplier if len(sel[0]) else float("nan"))
        summary["rmse_any"].append(float(np.mean(rmse[:, i])) * mse_multiplier)
        summary["rmse_any_std"].append(float(np.std(rmse[:, i])) * mse_multiplier)
    sel = np.where(cf_all)
    summary["rmse_all_valid"] = float(np.mean(rmse_all[sel])) * mse_multiplier if len(sel[0]) else float("nan")
    summary["rmse_all_valid_std"] = float(np.std(rmse_all[sel])) * mse_multiplier if len(sel[0]) else float("nan")
    summary["rmse_all_any"] = float(np.mean(rmse_all)) * mse_multiplier
    summary["rmse_all_any_std"] = float(np.std(rmse_all)) * mse_multiplier

    if verbose:
        for i, s in enumerate(cf_sum):
            print(f"Equation {i} success rate = {s}/{n}")
        print(f"Joint success rate = {cf_all_sum}/{n}")
        for i in range(cf.shape[1]):
            print(f"Equation {i} RMSE = {summary['rmse_valid'][i]:.4f} ({summary['rmse_valid_std'][i]:.4f})")
            print(f"Equation {i} RMSE (any) = {summary['rmse_any'][i]:.4f} ({summary['rmse_any_std'][i]:.4f})")
        print(f"All equations RMSE = {summary['rmse_all_valid']:.4f} ({summary['rmse_all_valid_std']:.4f})")
        print(f"All equations RMSE (any) = {summary['rmse_all_any']:.4f} ({summary['rmse_all_any_std']:.4f})")
    return summary


def load_seed_results(directory: str, min_seed: int = 0, max_seed: int = 100):
    """The per-seed results of a run directory, in directory order: lists of
    correct_form, mse, correct_form_all and mse_all from each seed{N}.npz
    with min_seed <= N < max_seed (other files are skipped)."""
    cf, mse, cf_all, mse_all = [], [], [], []
    for filename in os.listdir(directory):
        stem = filename[4:-4] if filename.startswith("seed") and filename.endswith(".npz") else ""
        if not stem.isdigit() or not min_seed <= int(stem) < max_seed:
            continue
        with np.load(os.path.join(directory, filename)) as res:
            cf.append(res["correct_form"])
            mse.append(res["mse"])
            cf_all.append(res["correct_form_all"])
            mse_all.append(res["mse_all"])
    return cf, mse, cf_all, mse_all


def aggregate_run(run_name: str, min_seed: int = 0, max_seed: int = 100,
                  mse_multiplier: float = 1.0, result_dir: str = "eval_results",
                  verbose: bool = True) -> dict:
    """``aggregate_results`` over the seed{N}.npz files of
    ``result_dir``/``run_name`` (the JAX package's directory form of
    aggregate_results, with its "Loaded results" line)."""
    cf, mse, cf_all, mse_all = load_seed_results(os.path.join(result_dir, run_name),
                                                 min_seed, max_seed)
    if verbose:
        print(f"Loaded results from {len(cf)} runs.")
    results = [{"correct_form": c, "mse": m, "correct_form_all": ca, "mse_all": ma}
               for c, m, ca, ma in zip(cf, mse, cf_all, mse_all)]
    return aggregate_results(results, mse_multiplier, verbose)


def save_eval_results(results: dict, save_dir: str, seed: int, root: str = "eval_results"):
    """Write {root}/{save_dir}/seed{seed}.npz in the evaluation schema."""
    out = os.path.join(root, save_dir)
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"seed{seed}.npz"), **results)
