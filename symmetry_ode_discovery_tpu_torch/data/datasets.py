"""Cached trajectory datasets: load, or generate and cache.

Caches are ``{stem}-x.npy`` and ``{stem}-dx.npy`` with the stem
``{name}-{mode}-noise{int(100*noise):02d}[-{smoothing}]``, the JAX package's
convention and format. The port draws its data with torch's generators, so
its caches hold other draws than the JAX package's: they live in their own
directory, ``$SODT_TORCH_DATA_PATH``, by default
``~/.cache/symmetry_ode_discovery_tpu_torch/data``. A JAX cache can still be
read by passing its directory as ``path``, and so can the reference
codebase's torch caches (``{stem}-x.pt``, ``{stem}-dx.pt``) when there is
no ``.npy`` pair.

The reaction-diffusion tasks read ``reaction_diffusion.mat`` from the same
directory, or simulate it there on the device (data/rd_solver.py): 201
snapshots of the 100 x 100 grid, a 1e-6 jitter drawn by numpy (the JAX
package's draws, bit for bit), split 80/10/10 in time order. ``rd`` gives
the snapshots, ``mt_rd`` windows of two consecutive ones.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .systems import SYSTEMS

__all__ = ["MTODEDataset", "MultiTimestepReactionDiffusionDataset", "ODEDataset",
           "ReactionDiffusionDataset", "cache_seed", "data_path", "default_n_ics",
           "get_dataset", "load_or_generate", "ode_dt_dict", "save_cache"]

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


def default_n_ics(system, mode: str) -> int:
    return system.default_n_train if "train" in mode else system.default_n_val


def save_cache(stem: str, x: torch.Tensor, dx: torch.Tensor) -> None:
    os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
    np.save(f"{stem}-x.npy", x.cpu().numpy().astype(np.float32))
    np.save(f"{stem}-dx.npy", dx.cpu().numpy().astype(np.float32))


def load_or_generate(name: str, mode: str, noise: float = 0.0, smoothing=None,
                     path: str = None, n_ics: int = None, device=None):
    """(x, dx), each (n_ics, n_steps, dim) float32 on ``device``, read from
    the cache under ``path`` (default ``data_path()``): the ``.npy`` pair,
    else the reference's ``.pt`` pair; or generated with the system's
    protocol and written there as ``.npy``. The data/gen.py CLI writes the
    same draws."""
    device = resolve_device(device)
    path = data_path() if path is None else path
    stem = os.path.join(path, _cache_stem(name, mode, noise, smoothing))
    if os.path.exists(f"{stem}-x.npy") and os.path.exists(f"{stem}-dx.npy"):
        x = np.load(f"{stem}-x.npy")
        dx = np.load(f"{stem}-dx.npy")
        return (torch.as_tensor(x, dtype=torch.float32, device=device),
                torch.as_tensor(dx, dtype=torch.float32, device=device))
    xd = _load_pt_cache(stem)
    if xd is not None:
        return tuple(a.to(device) for a in xd)

    from .generate import gen_data

    system = SYSTEMS[name]
    if n_ics is None:
        n_ics = default_n_ics(system, mode)
    gen = torch.Generator(device=device).manual_seed(cache_seed(mode, noise))
    x, dx = gen_data(system, gen, n_ics=n_ics, noise=noise,
                     multiplicative_noise=system.multiplicative_noise,
                     smoothing=smoothing, device=device)
    save_cache(stem, x, dx)
    return x, dx


def _load_pt_cache(stem: str):
    """(x, dx) float32 CPU tensors from the reference codebase's torch cache
    files ``{stem}-x.pt`` and ``{stem}-dx.pt`` (tensors only:
    ``weights_only``), or None when either is missing or unreadable."""
    if not (os.path.exists(f"{stem}-x.pt") and os.path.exists(f"{stem}-dx.pt")):
        return None
    out = []
    for part in ("x", "dx"):
        try:
            t = torch.load(f"{stem}-{part}.pt", map_location="cpu", weights_only=True)
        except Exception:  # a truncated or foreign file: generate instead
            return None
        if not isinstance(t, torch.Tensor):
            return None
        out.append(t.detach().to(torch.float32))
    return tuple(out)


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


class MTODEDataset(ODEDataset):
    """Multi-timestep windows x[i, j : j + n_timesteps * interval : interval]
    of each trajectory, n_steps - n_timesteps * interval of them per
    trajectory (the JAX package's count)."""

    def __init__(self, x: torch.Tensor, dx: torch.Tensor, n_timesteps: int = 2,
                 interval: int = 10):
        super().__init__(x, dx)
        if n_timesteps < 2:
            raise ValueError("n_timesteps must be greater than 1")
        self.n_timesteps, self.interval = n_timesteps, interval
        self.n_windows = self.n_steps - n_timesteps * interval

    @classmethod
    def make(cls, name: str, mode: str = "train", noise: float = 0.0, smoothing=None,
             path: str = None, n_ics: int = None, device=None, n_timesteps: int = 2,
             interval: int = 10):
        x, dx = load_or_generate(name, mode, noise, smoothing, path, n_ics, device)
        return cls(x, dx, n_timesteps=n_timesteps, interval=interval)

    def _windows(self, a: torch.Tensor) -> torch.Tensor:
        a = a.contiguous()
        s0, s1, s2 = a.stride()
        view = a.as_strided((self.n_ics, self.n_windows, self.n_timesteps, self.input_dim),
                            (s0, s1, s1 * self.interval, s2))
        return view.reshape(self.n_ics * self.n_windows, self.n_timesteps, self.input_dim)

    def materialize(self):
        """(x, dx) windows (n_ics * n_windows, n_timesteps, dim), on the
        trajectories' device: one strided view and one copy each."""
        return self._windows(self.trajs_x), self._windows(self.trajs_dx)

    def __len__(self):
        return self.n_ics * self.n_windows


def _rd_split(n_samples: int, mode: str) -> np.ndarray:
    """The consecutive 80/10/10 split of the time samples."""
    if mode == "train":
        return np.arange(int(0.8 * n_samples))
    if mode == "val":
        return np.arange(int(0.8 * n_samples), int(0.9 * n_samples))
    if mode == "test":
        return np.arange(int(0.9 * n_samples), n_samples)
    raise ValueError(f"unknown RD split mode {mode!r}")


def _load_rd(device=None) -> dict:
    """The arrays of ``reaction_diffusion.mat`` under ``data_path()``,
    simulated on ``device`` and written there first when the file is
    missing."""
    import scipy.io as sio

    path = os.path.join(data_path(), "reaction_diffusion.mat")
    if not os.path.exists(path):
        from .rd_solver import generate_rd_mat

        print(f"{path} absent; simulating the reaction-diffusion data (data/rd_solver.py)...")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        generate_rd_mat(path, device=device)
    return sio.loadmat(path)


def _rd_snapshots(data: dict, mode: str):
    """(xs, dxs, samples, N): the split's snapshots (n_sel, N) in time
    order, float64, after the 1e-6 jitter that numpy's default_rng(0) draws
    over the whole of uf and then of duf (for every split alike)."""
    n_samples = data["t"].size
    n = data["x"].size
    N = n * n
    rng = np.random.default_rng(0)
    uf = data["uf"] + 1e-6 * rng.standard_normal(data["uf"].shape)
    duf = data["duf"] + 1e-6 * rng.standard_normal(data["duf"].shape)
    samples = _rd_split(n_samples, mode)
    xs = uf[:, :, samples].reshape(N, -1).T
    dxs = duf[:, :, samples].reshape(N, -1).T
    return xs, dxs, samples, N


class ReactionDiffusionDataset:
    """The split's snapshots: x and dx (n_sel, N) float32, the fields
    flattened over the grid."""

    def __init__(self, data: dict, mode: str = "train", device=None):
        device = resolve_device(device)
        xs, dxs, samples, N = _rd_snapshots(data, mode)
        self.t = data["t"].reshape(-1)[samples]
        self.x = torch.as_tensor(xs, dtype=torch.float32, device=device)
        self.dx = torch.as_tensor(dxs, dtype=torch.float32, device=device)
        self.input_dim = N

    def __len__(self):
        return self.x.shape[0]


class MultiTimestepReactionDiffusionDataset:
    """Windows samples[i - n_timesteps:i] of consecutive snapshots for i in
    [n_timesteps, n_sel): x and dx (W, n_timesteps, N) float32 (158 train
    and 18 val windows of two)."""

    def __init__(self, data: dict, mode: str = "train", n_timesteps: int = 2, device=None):
        device = resolve_device(device)
        xs, dxs, samples, N = _rd_snapshots(data, mode)
        self.n_timesteps = n_timesteps
        idx = np.arange(n_timesteps, len(samples))
        win = np.stack([xs[i - n_timesteps:i] for i in idx])
        dwin = np.stack([dxs[i - n_timesteps:i] for i in idx])
        self.x = torch.as_tensor(win, dtype=torch.float32, device=device)
        self.dx = torch.as_tensor(dwin, dtype=torch.float32, device=device)
        self.input_dim = N

    def materialize(self):
        return self.x, self.dx

    def __len__(self):
        return self.x.shape[0]


def get_dataset(args: dict, device=None, with_val: bool = False):
    """(train_ds, args), or (train_ds, val_ds, args) with ``with_val``, read
    from the cache or generated; sets args["input_dim"]. An ODE system task
    gives ODEDataset; "mt_<system>" gives MTODEDataset windows (interval 50
    for selkov, else 10) and sets args["mt_data"]; "rd" gives
    ReactionDiffusionDataset snapshots (args["flatten"] False) and "mt_rd"
    MultiTimestepReactionDiffusionDataset windows (args["mt_data"])."""
    task = args["task"]
    name = task[3:] if task.startswith("mt_") else task
    if task in ("rd", "mt_rd"):
        data = _load_rd(device=device)
        if task == "rd":
            make = lambda mode: ReactionDiffusionDataset(data, mode, device=device)
            args["flatten"] = False
        else:
            make = lambda mode: MultiTimestepReactionDiffusionDataset(data, mode, device=device)
            args["mt_data"] = True
        train_ds = make("train")
        args["input_dim"] = train_ds.input_dim
        return (train_ds, make("val"), args) if with_val else (train_ds, args)
    if name not in SYSTEMS:
        raise NotImplementedError(f"unknown task {task!r}")
    noise, smoothing = args.get("noise", 0.0), args.get("smoothing")
    if task.startswith("mt_"):
        kw = dict(device=device, interval=50 if name == "selkov" else 10)
        make = MTODEDataset.make
        args["mt_data"] = True
    else:
        kw, make = dict(device=device), ODEDataset.make
    train_ds = make(name, "train", noise, smoothing, **kw)
    args["input_dim"] = train_ds.input_dim
    if with_val:
        return train_ds, make(name, "val", noise, smoothing, **kw), args
    return train_ds, args
