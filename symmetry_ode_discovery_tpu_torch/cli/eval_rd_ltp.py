"""Quantitative latent-equation evaluation for the reaction-diffusion cell.

The port's counterpart of symmetry_ode_discovery_tpu/cli/eval_rd_ltp.py:
the discovered latent dynamics of a joint rd checkpoint (rd/sym_eq.cfg:
the autoencoder, the generator and regressor.npz) are rolled out with RK4
from the first held-out snapshot's latent state and decoded back to
fields, then scored as relative field MSE against the true held-out
snapshots.

Reported series (each per step):
  rel_rollout  decode(RK4 rollout of Theta(z) Xi^T) against the true fields
  rel_latent   the same rollout against encode(true fields): the equation's
               error without the decoder's
  rel_recon    decode(encode(x)) against x: the autoencoder's floor
  pow_rollout, pow_recon  the rollout's and the floor's MSE over the field's
               power (mean x^2) instead of its time-variance
The rel_ series are relative to the held-out trajectory's time-variance
(the convention of cli/eval_ltp_sweep.py). --rd_eval_split traintail rolls
out over the last 20 train snapshots instead of the val split.

    python -m symmetry_ode_discovery_tpu_torch.cli.eval_rd_ltp \
        --config rd/sym_eq.cfg --load_laligan laligan-sindy-rd-2 [--eval_root DIR]

The checkpoint is read from ``saved_models/<load_laligan>`` (an absolute
path as it is); ``rollout.npz`` goes to
``<eval_root>/rd-ltp-<name>[-<split>]/``, the JAX CLI's layout.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device


def _rel_err(pred, true):
    """Per-step relative squared error: MSE over pixels over the
    trajectory's time-variance (population variance, averaged over
    pixels)."""
    scale = true.var(dim=0, unbiased=False).mean()
    return ((pred - true) ** 2).mean(dim=-1) / scale


def _rel_err_pow(pred, true):
    """The same MSE over the field's power (mean true^2)."""
    return ((pred - true) ** 2).mean(dim=-1) / (true ** 2).mean()


def run(args: dict, device=None, ckpt_root: str = "saved_models") -> dict:
    """The rollout series of the checkpoint ``<ckpt_root>/<load_laligan>``
    (else ``<save_dir>``) on the split ``args['rd_eval_split']`` (val, or
    the last 20 train snapshots for any other value), written as
    rollout.npz under ``args['eval_root']``; returns them as numpy arrays
    with 'seconds' (the evaluation's wall, reading excluded)."""
    from ..convert import laligan_from_npz
    from ..data.datasets import ReactionDiffusionDataset, _load_rd
    from ..ops.integrators import odeint
    from ..ops.library import FunctionLibrary
    from ..utils.checkpoint import load_regressor
    from .main import build_models

    device = resolve_device(device)
    data = _load_rd(device=device)
    split = args.get("rd_eval_split", "val")
    if split == "val":
        ds = ReactionDiffusionDataset(data, mode="val", device=device)
        x_val, t_axis = ds.x, ds.t
    else:
        # in-distribution control: the last 20 train snapshots
        ds = ReactionDiffusionDataset(data, mode="train", device=device)
        x_val, t_axis = ds.x[-20:], ds.t[-20:]
    dt = float(t_axis[1] - t_axis[0])
    args = dict(args, input_dim=ds.input_dim)

    ae, _ = build_models(args)
    load_dir = args.get("load_laligan") or args["save_dir"]
    ckpt = os.path.join(ckpt_root, load_dir)
    sd, _ = laligan_from_npz(ckpt, device)
    ae.load_state_dict(sd)
    ae = ae.to(device).eval().requires_grad_(False)
    lib = FunctionLibrary(args["latent_dim"], args["poly_order"])
    Xi_raw, mask = load_regressor(ckpt, device)
    Xi = Xi_raw * (mask > 0)

    t0 = time.perf_counter()
    with torch.no_grad():
        n_steps = x_val.shape[0] - 1
        z_true = ae.encode(x_val)
        z_pred = odeint(lambda z: lib(z) @ Xi.T, z_true[:1], n_steps * dt, dt, method="rk4",
                        full_traj=True, num_steps=n_steps)[:, 0]  # (T-1, d_lat)
        x_pred = ae.decode(z_pred)
        xhat = ae.decode(z_true)
        series = {
            "rel_rollout": _rel_err(x_pred, x_val[1:]),
            "rel_latent": _rel_err(z_pred, z_true[1:]),
            "rel_recon": _rel_err(xhat, x_val),
            "pow_rollout": _rel_err_pow(x_pred, x_val[1:]),
            "pow_recon": _rel_err_pow(xhat, x_val),
            "z_pred": z_pred, "z_true": z_true, "Xi": Xi,
        }
        out = {"t": np.asarray(t_axis[1:])}
        out.update({k: v.cpu().numpy() for k, v in series.items()})
    seconds = time.perf_counter() - t0
    name = os.path.basename(os.path.normpath(load_dir))
    eval_root = args.get("eval_root", "eval_results")
    dst = os.path.join(eval_root, f"rd-ltp-{name}" if split == "val"
                       else f"rd-ltp-{name}-{split}")
    os.makedirs(dst, exist_ok=True)
    np.savez(os.path.join(dst, "rollout.npz"), **out)
    print(f"RD latent-equation LTP over {n_steps} held-out steps (dt={dt:.3g}), "
          f"{seconds:.3f} s:")
    print(f"  rollout field rel. MSE (time-mean): {float(np.mean(out['rel_rollout'])):.4g}")
    print(f"  latent rollout rel. MSE:            {float(np.mean(out['rel_latent'])):.4g}")
    print(f"  AE recon floor rel. MSE:            {float(np.mean(out['rel_recon'])):.4g}")
    print(f"  (field-power-normalized: rollout {float(np.mean(out['pow_rollout'])):.4g}, "
          f"recon floor {float(np.mean(out['pow_recon'])):.4g})")
    print(f"  -> saved {dst}/rollout.npz")
    return dict(out, seconds=seconds)


def main(argv=None):
    from ..utils.config import get_args

    return run(vars(get_args(argv)))


if __name__ == "__main__":
    main()
