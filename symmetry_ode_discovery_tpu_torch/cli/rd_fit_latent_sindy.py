"""Post-hoc constrained latent SINDy on a frozen reaction-diffusion LaLiGAN.

    python -m symmetry_ode_discovery_tpu_torch.cli.rd_fit_latent_sindy \
        --src laligan-rd-nonjoint-s42-ep90 [--epoch N] [--dst NAME] \
        [--ckpt_root saved_models] [--save_root DIR] [--device cpu]
    python -m symmetry_ode_discovery_tpu_torch.cli.eval_rd_ltp --config rd/sym_eq.cfg \
        --load_laligan <save_root>/<dst>

The port's counterpart of the repository's tools/rd_fit_latent_sindy.py. It
runs the joint trainer's constrained least-squares fixpoint
(training/lassi.py::LassiTrainer._sindy_lstsq_update: Q from the loaded
generator, five masked minimum-norm solves and thresholds) once, over every
train window, with the autoencoder frozen in eval mode, and writes a
complete checkpoint (autoencoder.npz, discriminator.npz, generator.npz,
generator_mask.npz and regressor.npz, the JAX package's layout) that
cli/eval_rd_ltp.py evaluates.

  --src        the LaLiGAN checkpoint under --ckpt_root (an absolute path as
               it is)
  --epoch      fit on the trainer state of the port's snapshot
               <src>/train_state_ep<epoch>.npz instead of the final artifacts
  --dst        the output's name under --save_root (default
               <src>-sindy[-ep<epoch>]); --save_root defaults to
               $SODT_TORCH_SAVE_PATH, else
               ~/.cache/symmetry_ode_discovery_tpu_torch/saved_models

The fit's hyper-parameters (eq_constraint, threshold, w_sindy_reg,
poly_order) and the models' shapes are rd/sym_eq.cfg's, with any further
flags of utils/config.py given after the options above; the data is
reaction_diffusion.mat in $SODT_TORCH_DATA_PATH, simulated there on first
use. The discriminator is the trainer's initialisation from the config's
seed unless a snapshot gives it. Runs on ``cuda`` unless --device says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import resolve_device


def build(args: dict, device):
    """The LaLiGAN trainer of the flags with lr_sindy 0, initialised from
    the config's seed (its joint state fresh)."""
    from .main import build_trainer

    trainer = build_trainer(dict(args, lr_sindy=0.0), device=device)
    trainer.init(args["seed"])
    return trainer


def load_source(trainer, src: str, ckpt_root: str = "saved_models", epoch=None):
    """Set the trainer's autoencoder and generator from the checkpoint
    ckpt_root/src, or with ``epoch`` every model from the port's snapshot
    train_state_ep<epoch>.npz there; the joint state starts fresh."""
    from ..utils import checkpoint as ckpt

    if epoch is None:
        sd, g_state = ckpt.load_laligan(src, ckpt_root, trainer.device)
        trainer.load_state(sd, trainer.disc.state_dict(), g_state)
        return
    path = ckpt.train_state_path(src, epoch, ckpt_root)
    state = ckpt.load_pytree(path, {"trainer": trainer.state()})["trainer"]
    trainer.restore(state)
    fresh = trainer._fresh_sindy(trainer.g_state)
    trainer.sindy = {k: v.to(trainer.device) for k, v in fresh.items()}


def fit(trainer, x: torch.Tensor, dx: torch.Tensor) -> dict:
    """One least-squares fixpoint over all windows x, dx (W, n_comps, N),
    eval mode, the epoch's last batch (Q computed from the generator):
    the latent residual, Xi, its mask and the masked Xi."""
    trainer.ae.eval()
    with torch.no_grad():
        resid, new = trainer._sindy_lstsq_update(x, dx, None, is_last=True, train=False)
    return {"resid": float(resid), "Xi": new["Xi"], "mask": new["mask"],
            "Xi_masked": new["Xi"] * new["mask"]}


def run(src: str, epoch=None, dst=None, ckpt_root: str = "saved_models", save_root=None,
        extra=(), device=None) -> dict:
    """Fit ``src`` (module docstring) and write the checkpoint under
    ``save_root``/``dst``; ``extra``: flags after --config rd/sym_eq.cfg.
    Returns the fit (numpy), the windows' count and the output
    directory."""
    from ..data.datasets import get_dataset
    from ..utils import checkpoint as ckpt
    from ..utils.config import get_args
    from .main_sindy import save_root as default_root

    device = resolve_device(device)
    args = vars(get_args(["--config", "rd/sym_eq.cfg"] + list(extra)))
    train_ds, args = get_dataset(args, device)
    x, dx = train_ds.materialize()
    trainer = build(args, device)
    load_source(trainer, src, ckpt_root, epoch)
    out = fit(trainer, x, dx)
    root = save_root or default_root({})
    name = dst or (os.path.basename(os.path.normpath(src)) + "-sindy"
                   + (f"-ep{epoch}" if epoch else ""))
    directory = ckpt.save_laligan(name, trainer, root)
    ckpt.save_regressor(directory, out["Xi"], out["mask"])
    res = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
    return dict(res, windows=int(x.shape[0]), dir=directory)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="laligan-rd-nonjoint-s42")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--dst", default=None)
    ap.add_argument("--ckpt_root", default="saved_models")
    ap.add_argument("--save_root", default=None)
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    a, extra = ap.parse_known_args(argv)
    out = run(a.src, a.epoch, a.dst, a.ckpt_root, a.save_root, extra, a.device)
    print(f"fit on {out['windows']} windows: latent residual {out['resid']:.4g}")
    print("Xi (masked):")
    print(np.array2string(out["Xi_masked"], precision=4, suppress_small=True))
    print(f"-> {out['dir']} (autoencoder/generator/regressor npzs)")
    print(json.dumps({"src": a.src, "epoch": a.epoch, "windows": out["windows"],
                      "resid": out["resid"], "Xi": out["Xi"].tolist(),
                      "mask": out["mask"].tolist(), "dir": out["dir"]}))
    return out


if __name__ == "__main__":
    main()
