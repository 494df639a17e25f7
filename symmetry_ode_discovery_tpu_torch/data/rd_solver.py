"""The lambda-omega reaction-diffusion system, simulated on the device.

    u_t = (1 - A^2) u + beta A^2 v + d1 lap(u)
    v_t = -beta A^2 u + (1 - A^2) v + d2 lap(v),   A^2 = u^2 + v^2

with d1 = d2 = 0.1, beta = 1 on the periodic square [-10, 10]^2 and the
spiral initial condition u = tanh(r) cos(theta - r), v = tanh(r) sin(theta -
r), sampled at t = 0:0.05:10 (201 samples): the SINDy-AE reaction-diffusion
example whose ``reaction_diffusion.mat`` the rd datasets read.

The port's copy of symmetry_ode_discovery_tpu/data/rd_solver.py. The
Laplacian is spectral (``torch.fft.fft2`` and ``ifft2`` on the given
device), each sample is ``substeps`` RK4 steps in real space, and ``duf`` is
the exact right-hand side at each sample, not a finite difference. Like the
JAX solver, which runs without x64 and so in float32 throughout (its
wavenumbers, grid and scan state are f32, its FFTs complex64), everything
here is float32 and complex64; the arithmetic follows the JAX solver's
order. FFT libraries sum in different orders (pocketfft in XLA's CPU path,
torch's CPU FFT, cuFFT), so the fields agree to about f32 rounding grown
over the 804 RK4 steps (tests/test_torch_rd.py states the bounds).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device

__all__ = ["generate_rd_mat", "save_rd_mat", "simulate_rd"]


def _rhs(uv: torch.Tensor, k2: torch.Tensor, d: torch.Tensor, beta: float) -> torch.Tensor:
    """(du, dv) stacked (2, n, n) for the state (u, v) stacked the same way."""
    u, v = uv[0], uv[1]
    A2 = u * u + v * v
    lap = torch.fft.ifft2(-k2 * torch.fft.fft2(uv)).real
    du = (1.0 - A2) * u + beta * A2 * v + d[0] * lap[0]
    dv = -beta * A2 * u + (1.0 - A2) * v + d[1] * lap[1]
    return torch.stack([du, dv])


def simulate_rd(n: int = 100, T: float = 10.0, dt: float = 0.05, L: float = 20.0,
                d1: float = 0.1, d2: float = 0.1, beta: float = 1.0, substeps: int = 4,
                device=None):
    """(t, x, y, uf, duf): t, x and y float64 numpy grids; uf and duf
    (n, n, n_samples) float32 tensors on ``device``, sampled every ``dt``
    (duf the exact right-hand side at the sample). ``substeps`` RK4 steps a
    sample keep the explicit scheme inside its stability region for the
    spectral Laplacian."""
    device = resolve_device(device)
    n_samples = int(round(T / dt)) + 1
    t = np.arange(n_samples) * dt
    x = np.linspace(-L / 2, L / 2, n, endpoint=False)
    y = x.copy()

    f32 = dict(dtype=torch.float32, device=device)
    # fftfreq(n, d=1/n) is the integer frequencies times 1 / (d n) = 1
    freq = torch.as_tensor(np.fft.fftfreq(n, d=1.0 / n).astype(np.float32), **f32)
    k = 2.0 * math.pi / L * freq
    k2 = k[:, None] ** 2 + k[None, :] ** 2

    xg = torch.as_tensor(x.astype(np.float32), **f32)
    X, Y = torch.meshgrid(xg, xg, indexing="ij")
    r = torch.sqrt(X ** 2 + Y ** 2)
    theta = torch.atan2(Y, X)
    uv = torch.stack([torch.tanh(r) * torch.cos(theta - r),
                      torch.tanh(r) * torch.sin(theta - r)])
    d = torch.tensor([d1, d2], **f32)
    h = dt / substeps

    uf = torch.empty((n_samples, n, n), **f32)
    duf = torch.empty((n_samples, n, n), **f32)
    for i in range(n_samples):
        uf[i] = uv[0]
        duf[i] = _rhs(uv, k2, d, beta)[0]
        for _ in range(substeps):
            k1 = _rhs(uv, k2, d, beta)
            k2_ = _rhs(uv + 0.5 * h * k1, k2, d, beta)
            k3 = _rhs(uv + 0.5 * h * k2_, k2, d, beta)
            k4 = _rhs(uv + h * k3, k2, d, beta)
            uv = uv + h / 6.0 * (k1 + 2 * k2_ + 2 * k3 + k4)
    # (n_samples, n, n) -> (n, n, n_samples), the .mat layout
    return t, x, y, uf.permute(1, 2, 0).contiguous(), duf.permute(1, 2, 0).contiguous()


def save_rd_mat(path: str, t, x, y, uf, duf) -> str:
    """Write simulate_rd's output as ``reaction_diffusion.mat`` (keys t, x,
    y as columns, uf and duf (n, n, n_samples) float32: the layout the rd
    datasets index); returns ``path``."""
    import scipy.io as sio

    as_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    sio.savemat(path, {"t": t.reshape(-1, 1), "x": x.reshape(-1, 1), "y": y.reshape(-1, 1),
                       "uf": as_np(uf), "duf": as_np(duf)})
    return path


def generate_rd_mat(path: str, n: int = 100, T: float = 10.0, dt: float = 0.05,
                    device=None, **kwargs) -> str:
    """save_rd_mat of simulate_rd on ``device``; returns ``path``."""
    return save_rd_mat(path, *simulate_rd(n=n, T=T, dt=dt, device=device, **kwargs))
