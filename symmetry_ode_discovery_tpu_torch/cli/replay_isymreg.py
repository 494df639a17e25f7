"""Replay of recorded EquivSINDy-r draws through the port's stepper.

    SODT_TORCH_DATA_PATH=<directory with the JAX package's LV noise-0.99 cache> \\
    python -m symmetry_ode_discovery_tpu_torch.cli.replay_isymreg \\
        --ref_dir eval_results/ref-isymreg-reduced --seeds 0,1,2,3 \\
        [--symmpen_pallas] [--lbfgs_dir_backend pallas]

The reference directory holds, per seed, the reference implementation's
recorded run of the flagship protocol at a reduced budget (seed<N>_traj.npz:
the subsample permutation ``perm``, the initial coefficients ``xi0``, Xi after
every epoch, the mask before each epoch's thresholding ``mask_after`` and the
final mask), its evaluation (seed<N>_ref_eval.npz) and the JAX package's
replay of the same draws (seed<N>_ours.npz: Xi and mask after every epoch).
The draws index the JAX package's LV noise-0.99 training split, which is not
tracked: $SODT_TORCH_DATA_PATH must hold its cache files
(lv-train-noise99-gp-{x,dx}.npy, written by the JAX package's
data/datasets.py::load_or_generate).

All seeds run as the lanes of one host-stepped fit of lv/noise99_eq_isymreg.cfg
at the recorded budget (--epochs, --st_freq). Any other argument is a flag of
the main CLI and is passed on: the flagship runs with --symmpen_pallas (K2,
K3) and --lbfgs_dir_backend pallas (K4); without them the penalty is autodiff
through the plain AutoEncoder and the direction the plain two-loop, which
separates the kernels from the stepper. Printed per seed and epoch: max
|dXi| against the JAX replay and the reference, and whether the masks agree
(the reference's mask_after[e + 1] is the mask after epoch e; a record that
stopped early is held at its last state); then each seed's outcome against
the reference's (support and largest surviving-coefficient difference), and
one JSON summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def replay(ref_dir: str, seeds, epochs: int = 10, st_freq: int = 4, device=None,
           ckpt_root: str = "saved_models", flags=()) -> dict:
    """Run the recorded draws of ``seeds`` with the main CLI's ``flags`` and
    compare; returns the summary."""
    from ..evaluation.eval_eq import eval_sindy_coefficients, sindy_truth
    from ..training.siged import make_lbfgs_stepper
    from ..utils.config import get_args
    from .main import build_fit

    args = vars(get_args(["--config", "lv/noise99_eq_isymreg.cfg", "--ae_dtype", "f32"]
                         + list(flags)))
    fit = build_fit(args, device=device, ckpt_root=ckpt_root)
    hp = dataclasses.replace(fit["hp"], num_epochs=epochs, st_freq=st_freq)
    init, step, extract = make_lbfgs_stepper(fit["cfg"], fit["Q"], hp, fit["sym_reg_fn"],
                                             fit["sym_reg_prep"], epochs_per_call=1)
    load = lambda name, s: np.load(os.path.join(ref_dir, f"seed{s}_{name}.npz"))
    trajs = [load("traj", s) for s in seeds]
    k = int(fit["x"].shape[0] * args["lbfgs_subsample"])
    idx = torch.as_tensor(np.stack([t["perm"][:k] for t in trajs]), device=fit["device"])
    theta0 = torch.as_tensor(np.stack([t["xi0"].reshape(-1) for t in trajs]),
                             dtype=torch.float32, device=fit["device"])
    carry = init(fit["x"][idx], fit["dx"][idx], theta0)
    xis, masks = [], []
    for e in range(epochs):
        carry = step(carry, e)
        Xi, mask = extract(carry)
        xis.append(Xi.detach().cpu().numpy())
        masks.append(mask.cpu().numpy())

    truth = sindy_truth["lv"]
    per_seed = []
    print(f"{'seed':>4} {'epoch':>5} {'|dXi| jax':>10} {'|dXi| ref':>10} mask==jax mask==ref")
    for i, (s, traj) in enumerate(zip(seeds, trajs)):
        ours_path = os.path.join(ref_dir, f"seed{s}_ours.npz")
        jax_rec = np.load(ours_path) if os.path.exists(ours_path) else None
        rec = {"seed": s, "mask_equal_jax": [], "mask_equal_ref": [],
               "max_dxi_jax": [], "max_dxi_ref": []}
        for e in range(epochs):
            # a record that stopped early (NaN, convergence) keeps its last state
            m_ref = (traj["mask_after"][e + 1] if e + 1 < len(traj["mask_after"])
                     else traj["mask_final"])
            xi_ref = traj["xi"][min(e, len(traj["xi"]) - 1)]
            rec["mask_equal_ref"].append(bool((masks[e][i] == m_ref).all()))
            rec["max_dxi_ref"].append(float(np.abs(xis[e][i] - xi_ref).max()))
            if jax_rec is not None:
                e_j = min(e, len(jax_rec["xi"]) - 1)
                rec["mask_equal_jax"].append(bool((masks[e][i] == jax_rec["mask"][e_j]).all()))
                rec["max_dxi_jax"].append(float(np.abs(xis[e][i] - jax_rec["xi"][e_j]).max()))
            dj = rec["max_dxi_jax"][-1] if jax_rec is not None else float("nan")
            mj = rec["mask_equal_jax"][-1] if jax_rec is not None else None
            print(f"{s:>4} {e:>5} {dj:>10.3e} {rec['max_dxi_ref'][-1]:>10.3e} "
                  f"{str(mj):>9} {rec['mask_equal_ref'][-1]}")
        ours = eval_sindy_coefficients(xis[-1][i], masks[-1][i], truth)
        rec["correct_form"] = ours["correct_form"].tolist()
        ref_eval = os.path.join(ref_dir, f"seed{s}_ref_eval.npz")
        if os.path.exists(ref_eval):
            with np.load(ref_eval) as z:
                rec["ref_correct_form"] = z["correct_form"].tolist()
                # the surviving (masked) coefficients, as the evaluation keeps them
                rec["max_coef_diff_ref"] = float(np.abs(ours["coefficients"]
                                                        - z["coefficients"]).max())
        print(f"seed {s}: correct_form {rec['correct_form']}, reference "
              f"{rec.get('ref_correct_form')}, max |coefficient diff| "
              f"{rec.get('max_coef_diff_ref')}")
        per_seed.append(rec)
    summary = {"seeds": list(seeds), "epochs": epochs, "st_freq": st_freq,
               "symmpen_pallas": bool(args["symmpen_pallas"]),
               "lbfgs_dir_backend": args["lbfgs_dir_backend"],
               "masks_equal_jax_every_epoch": sum(bool(r["mask_equal_jax"])
                                                  and all(r["mask_equal_jax"])
                                                  for r in per_seed),
               "masks_equal_ref_every_epoch": sum(all(r["mask_equal_ref"]) for r in per_seed),
               "outcome_equal_ref": sum(r.get("ref_correct_form") == r["correct_form"]
                                        for r in per_seed),
               "per_seed": per_seed}
    print(json.dumps({k: v for k, v in summary.items() if k != "per_seed"}))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref_dir", default="eval_results/ref-isymreg-reduced")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--st_freq", type=int, default=4)
    a, flags = ap.parse_known_args(argv)
    return replay(a.ref_dir, [int(s) for s in a.seeds.split(",")], a.epochs, a.st_freq,
                  flags=flags)


if __name__ == "__main__":
    main()
