"""The data-generation CLI: write a system's cached splits ahead of a run.

    python -m symmetry_ode_discovery_tpu_torch.data.gen --system lv --noise 0.99 --smoothing gp
    python -m symmetry_ode_discovery_tpu_torch.data.gen --system dosc --noise 0.2 \
        --smoothing gp --torch

The flags of the JAX package's data/gen.py, plus --device (default the
card). Each split is drawn from the generator that data/datasets.py's
``load_or_generate`` seeds on a cache miss (``cache_seed``), and written
under the same stem, so a cache this CLI writes is the one a run would
generate. --save_dir defaults to ``data_path()``. --torch also writes
``{stem}-x.pt`` and ``{stem}-dx.pt``, the reference codebase's cache
format, which ``load_or_generate`` reads when there is no ``.npy`` pair.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--system", required=True, choices=["lv", "dosc", "growth", "selkov"])
    parser.add_argument("--modes", nargs="+", default=["train", "val"])
    parser.add_argument("--noise", type=float, default=0.0)
    parser.add_argument("--smoothing", type=str, default=None)
    parser.add_argument("--n_ics", type=int, default=None,
                        help="override train IC count (val uses the system default)")
    parser.add_argument("--num_steps", type=int, default=None)
    parser.add_argument("--dt", type=float, default=None)
    parser.add_argument("--subsample_rate", type=int, default=None)
    parser.add_argument("--gp_sigma_in", type=float, default=None)
    parser.add_argument("--save_dir", type=str, default=None,
                        help="cache directory (default: data_path())")
    parser.add_argument("--torch", action="store_true",
                        help="also export .pt tensors in the reference codebase's format")
    parser.add_argument("--device", type=str, default=None,
                        help="cpu to generate on the CPU (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from .. import resolve_device
    from .datasets import _cache_stem, cache_seed, data_path, default_n_ics, save_cache
    from .generate import gen_data
    from .systems import SYSTEMS

    device = resolve_device(args.device)
    system = SYSTEMS[args.system]
    path = args.save_dir or data_path()
    os.makedirs(path, exist_ok=True)
    for mode in args.modes:
        n_ics = (args.n_ics if args.n_ics is not None and "train" in mode
                 else default_n_ics(system, mode))
        gen = torch.Generator(device=device).manual_seed(cache_seed(mode, args.noise))
        x, dx = gen_data(system, gen, n_ics=n_ics, dt=args.dt, num_steps=args.num_steps,
                         subsample_rate=args.subsample_rate, noise=args.noise,
                         multiplicative_noise=system.multiplicative_noise,
                         smoothing=args.smoothing, gp_sigma_in=args.gp_sigma_in, device=device)
        stem = os.path.join(path, _cache_stem(args.system, mode, args.noise, args.smoothing))
        save_cache(stem, x, dx)
        print(f"wrote {stem}-{{x,dx}}.npy  shape={tuple(x.shape)}")
        if args.torch:
            torch.save(x.cpu().contiguous(), f"{stem}-x.pt")
            torch.save(dx.cpu().contiguous(), f"{stem}-dx.pt")
            print(f"wrote {stem}-{{x,dx}}.pt")


if __name__ == "__main__":
    main()
