"""Statistics of a smoothed training split against its clean trajectories.

    python -m symmetry_ode_discovery_tpu_torch.cli.split_stats \\
        --config lv/noise99_eq_isymreg.cfg [--ref_dir DIR]

Makes the port's training split of the config's task, noise and smoothing on
the device, as the CLI's data loader would, and its clean counterpart: the
same generator seed, so the same initial conditions, integrated without
noise. Prints one JSON line with, per split, each statistic per state
dimension:

  x_err    RMS(x - x_clean) / std(x_clean): what smoothing left of the noise;
  dx_err   RMS(dx - dx_clean) / RMS(dx_clean): the smoothed derivative's error;
  eq_err   RMS(dx - f(x)) / RMS(dx_clean): the equation error of the true
           vector field at the smoothed states, the residual that the true
           coefficients leave in the SINDy loss;
  ae_err   RMS(decode(encode(x)) - x) / std(x) of the config's frozen LaLiGAN
           (--load_laligan under --ckpt_root), when the config names one.

--ref_dir names another implementation's split of the same task and noise as
four .npy files, each (n_ics, n_steps, dim): its cache ({stem}-x.npy,
{stem}-dx.npy, the cache stem of data/datasets.py) and its clean counterpart
({stem}-clean-x.npy, {stem}-clean-dx.npy). The same statistics are reported
for it, so that two noise realisations (and two draws of initial conditions)
stand side by side. Any other argument is a flag of the main CLI.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import resolve_device


def split_stats(x, dx, x_clean, dx_clean, f, ae=None, chunk: int = 1 << 18) -> dict:
    """The statistics above for one split; every array (N, dim) on one device."""
    rms = lambda a: a.square().mean(0).sqrt()
    dx_scale = rms(dx_clean)
    out = {"rows": int(x.shape[0]),
           "x_err": (rms(x - x_clean) / x_clean.std(0)).tolist(),
           "dx_err": (rms(dx - dx_clean) / dx_scale).tolist(),
           "eq_err": (rms(dx - f(x)) / dx_scale).tolist()}
    if ae is not None:
        with torch.no_grad():
            rec = torch.cat([ae.decode(ae.encode(c)) for c in x.split(chunk)])
        out["ae_err"] = (rms(rec - x) / x.std(0)).tolist()
    return out


def compare(args: dict, ref_dir=None, device=None, ckpt_root: str = "saved_models",
            **cut) -> dict:
    """{"port": stats[, "ref": stats]} for the training split of the flags
    ``args``; ``cut`` (n_ics, num_steps) cuts the port's split, which is
    otherwise the system's protocol."""
    from ..convert import laligan_from_npz
    from ..data.datasets import _cache_stem, cache_seed
    from ..data.generate import gen_data
    from ..data.systems import SYSTEMS
    from .main import build_models

    device = resolve_device(device)
    system = SYSTEMS[args["task"]]
    noise, smoothing = args["noise"], args["smoothing"]

    def draw(level, smooth):
        gen = torch.Generator(device=device).manual_seed(cache_seed("train", noise))
        x, dx = gen_data(system, gen, noise=level,
                         multiplicative_noise=system.multiplicative_noise,
                         smoothing=smooth, device=device, **cut)
        return x.reshape(-1, system.dim), dx.reshape(-1, system.dim)

    ae = None
    if args.get("load_laligan"):
        args["input_dim"] = system.dim
        ae, _ = build_models(args)
        sd, _ = laligan_from_npz(os.path.join(ckpt_root, args["load_laligan"]), device)
        ae.load_state_dict(sd)
        ae = ae.to(device).eval().requires_grad_(False)
    out = {"task": args["task"], "noise": noise, "smoothing": smoothing,
           "port": split_stats(*draw(noise, smoothing), *draw(0.0, None), system.f, ae)}
    if ref_dir is not None:
        stem = os.path.join(ref_dir, _cache_stem(args["task"], "train", noise, smoothing))
        arrays = [torch.as_tensor(np.load(f"{stem}{part}.npy"), dtype=torch.float32,
                                  device=device).reshape(-1, system.dim)
                  for part in ("-x", "-dx", "-clean-x", "-clean-dx")]
        out["ref"] = split_stats(*arrays, system.f, ae)
    return out


def main(argv=None):
    from ..utils.config import get_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref_dir", default=None)
    ap.add_argument("--ckpt_root", default="saved_models")
    a, flags = ap.parse_known_args(argv)
    out = compare(vars(get_args(flags)), a.ref_dir, ckpt_root=a.ckpt_root)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
