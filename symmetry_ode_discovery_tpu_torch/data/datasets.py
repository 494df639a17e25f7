"""Cached trajectory datasets: load, or generate and cache.

Caches are ``{stem}-x.npy`` and ``{stem}-dx.npy`` with the stem
``{name}-{mode}-noise{int(100*noise):02d}[-{smoothing}]``, the JAX package's
convention and format. The port draws its data with torch's generators, so
its caches hold other draws than the JAX package's: they live in their own
directory, ``$SODT_TORCH_DATA_PATH``, by default
``~/.cache/symmetry_ode_discovery_tpu_torch/data``. A JAX cache can still be
read by passing its directory as ``path``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .systems import SYSTEMS

__all__ = ["ODEDataset", "cache_seed", "data_path", "get_dataset", "load_or_generate",
           "ode_dt_dict"]

# the sample spacing of the cached datasets: each system's dt times its
# subsample rate (the JAX package's table)
ode_dt_dict = {
    "lv": 0.002,
    "selkov": 0.002,
    "dosc": 0.2,
    "growth": 0.02,
    "rd": 0.05,
}


def data_path() -> str:
    """The cache directory: $SODT_TORCH_DATA_PATH, read at each call."""
    return os.environ.get(
        "SODT_TORCH_DATA_PATH",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "symmetry_ode_discovery_tpu_torch", "data"))


def _cache_stem(name: str, mode: str, noise: float, smoothing) -> str:
    s = f"-{smoothing}" if smoothing is not None else ""
    return f"{name}-{mode}-noise{int(100 * noise):02d}{s}"


def cache_seed(mode: str, noise: float) -> int:
    """Generator seed of a cached draw: one per (split, noise level)."""
    return (0 if "train" in mode else 1000) + int(100 * noise)


def load_or_generate(name: str, mode: str, noise: float = 0.0, smoothing=None,
                     path: str = None, n_ics: int = None, device=None):
    """(x, dx), each (n_ics, n_steps, dim) float32 on ``device``, read from
    the cache under ``path`` (default ``data_path()``) or generated with the
    system's protocol and written there."""
    device = resolve_device(device)
    path = data_path() if path is None else path
    stem = os.path.join(path, _cache_stem(name, mode, noise, smoothing))
    if os.path.exists(f"{stem}-x.npy") and os.path.exists(f"{stem}-dx.npy"):
        x = np.load(f"{stem}-x.npy")
        dx = np.load(f"{stem}-dx.npy")
        return (torch.as_tensor(x, dtype=torch.float32, device=device),
                torch.as_tensor(dx, dtype=torch.float32, device=device))

    from .generate import gen_data

    system = SYSTEMS[name]
    if n_ics is None:
        n_ics = system.default_n_train if "train" in mode else system.default_n_val
    gen = torch.Generator(device=device).manual_seed(cache_seed(mode, noise))
    x, dx = gen_data(system, gen, n_ics=n_ics, noise=noise,
                     multiplicative_noise=system.multiplicative_noise,
                     smoothing=smoothing, device=device)
    os.makedirs(path, exist_ok=True)
    np.save(f"{stem}-x.npy", x.cpu().numpy())
    np.save(f"{stem}-dx.npy", dx.cpu().numpy())
    return x, dx


class ODEDataset:
    """Flattened (n_ics * n_steps, dim) samples of one system's trajectories."""

    def __init__(self, x: torch.Tensor, dx: torch.Tensor):
        self.n_ics, self.n_steps, self.input_dim = x.shape
        self.trajs_x, self.trajs_dx = x, dx
        self.x = x.reshape(-1, self.input_dim)
        self.dx = dx.reshape(-1, self.input_dim)

    @classmethod
    def make(cls, name: str, mode: str = "train", noise: float = 0.0,
             smoothing=None, path: str = None, n_ics: int = None, device=None):
        return cls(*load_or_generate(name, mode, noise, smoothing, path, n_ics,
                                     device))

    def __len__(self):
        return self.x.shape[0]

    def __getitem__(self, idx):
        return self.x[idx], self.dx[idx]


def get_dataset(args: dict, device=None):
    """(train_ds, args) for an ODE system task, read from the cache or
    generated; sets args["input_dim"]. The validation split is not made:
    equation discovery does not read it. The other tasks (rd, mt_*) are
    still to port."""
    task = args["task"]
    if task not in SYSTEMS:
        raise NotImplementedError(
            f"task {task!r}: only the ODE systems {sorted(SYSTEMS)} are ported "
            "(ROADMAP items 9 and 11)")
    noise, smoothing = args.get("noise", 0.0), args.get("smoothing")
    train_ds = ODEDataset.make(task, "train", noise, smoothing, device=device)
    args["input_dim"] = train_ds.input_dim
    return train_ds, args
