"""The reaction-diffusion autoencoder's reconstruction floor.

    python -m symmetry_ode_discovery_tpu_torch.evaluation.rd_floor \
        --ckpt saved_models/laligan-rd-nonjoint-s42 [--device cpu]

decode(encode(x)) in eval mode on the snapshots of reaction_diffusion.mat
(the un-jittered uf, flattened over the grid; simulated under
``data_path()`` when missing), with the metrics of the repository's
tools/rd_ae_floor.py: per snapshot the MSE over the grid, then ``rel`` its
mean over the split's mean per-point variance in time and ``pow`` its mean
over the split's mean x^2 (the field's power), for the train (the first
80%) and val (the next 10%) snapshots. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import resolve_device


def rd_snapshots(data: dict) -> tuple:
    """(xs (T, N) float32, train indices, val indices) of the .mat arrays."""
    from ..data.datasets import _rd_split

    n_samples, n = data["t"].size, data["x"].size
    xs = data["uf"].reshape((n * n, -1)).T.astype(np.float32)
    return xs, _rd_split(n_samples, "train"), _rd_split(n_samples, "val")


def floor_metrics(xhat: np.ndarray, x: np.ndarray) -> tuple:
    """(rel, pow) of the reconstruction xhat of the snapshots x (T, N)."""
    mse = np.mean((xhat - x) ** 2, axis=-1)
    return (float(np.mean(mse / np.mean(np.var(x, axis=0)))),
            float(np.mean(mse / np.mean(x ** 2))))


@torch.no_grad()
def ae_floor(ae, data: dict, device=None) -> dict:
    """{"train_rel", "train_pow", "val_rel", "val_pow"} of the autoencoder
    ``ae`` (eval mode) on the .mat arrays ``data``."""
    device = resolve_device(device)
    xs, tr, va = rd_snapshots(data)
    ae = ae.to(device).eval()
    xhat = ae.decode(ae.encode(torch.as_tensor(xs, device=device))).cpu().numpy()
    out = {}
    for split, idx in (("train", tr), ("val", va)):
        out[f"{split}_rel"], out[f"{split}_pow"] = floor_metrics(xhat[idx], xs[idx])
    return out


def main(argv=None):
    from ..cli.main import build_models
    from ..convert import laligan_from_npz
    from ..data.datasets import _load_rd
    from ..utils.config import get_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a LaLiGAN checkpoint directory")
    ap.add_argument("--config", default="rd/sym.cfg", help="the architecture's config")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    data = _load_rd(device=device)
    args = vars(get_args(["--config", a.config]))
    args["input_dim"] = int(data["x"].size) ** 2
    ae = build_models(args)[0]
    ae.load_state_dict(laligan_from_npz(a.ckpt, device)[0])
    print(json.dumps(dict(ckpt=a.ckpt, device=str(device), **ae_floor(ae, data, device))))


if __name__ == "__main__":
    main()
