"""The trajectories the benchmark hands to the program, made again by plain
PyTorch: initial conditions drawn from a seeded torch.Generator with the
Lotka-Volterra rejection window, RK4 recording x and the exact dx at every
step, additive noise scaled by the clean signal's per-dimension standard
deviation, and Gaussian-process smoothing and differentiation through one
Cholesky factor (the float32 engine at noise >= 0.15, float64 below). The
draws and the order of every operation are the recipe's, so the same seed
on the same device gives the program's data bit for bit."""

from __future__ import annotations

import torch


def lv_field(x, a=2.0 / 3.0, b=4.0 / 3.0, c=1.0, d=1.0):
    """Lotka-Volterra in canonical (log) coordinates."""
    return torch.stack([a - b * torch.exp(x[..., 1]), c * torch.exp(x[..., 0]) - d], dim=-1)


def lv_hamiltonian(x, a=2.0 / 3.0, b=4.0 / 3.0, c=1.0, d=1.0):
    return c * torch.exp(x[..., 0]) - d * x[..., 0] + b * torch.exp(x[..., 1]) - a * x[..., 1]


def lv_ics(gen: torch.Generator, n: int, h_min=3.0, h_max=4.5):
    """log(U(0,1)^2) redrawn, all still-invalid rows together, until the
    Hamiltonian lies in [h_min, h_max]."""
    x0 = torch.zeros((n, 2), device=gen.device)
    ok = torch.zeros(n, dtype=torch.bool, device=gen.device)
    while not bool(ok.all()):
        u = torch.rand((n, 2), generator=gen, device=gen.device)
        cand = torch.log(u * (1.0 - 1e-12) + 1e-12)
        h = lv_hamiltonian(cand)
        good = (h >= h_min) & (h <= h_max)
        x0 = torch.where((~ok & good)[:, None], cand, x0)
        ok = ok | good
    return x0


SYSTEMS = {"lv": (lv_field, lv_ics)}


def rk4_record(f, x0, dt: float, num_steps: int):
    """(x, dx), each (num_steps, *x0.shape): x at every step and dx = f(x)."""
    xs = torch.empty((num_steps,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    dxs = torch.empty_like(xs)
    x = x0
    for i in range(num_steps):
        dx = f(x)
        xs[i] = x
        dxs[i] = dx
        k1 = dt * dx
        k2 = dt * f(x + 0.5 * k1)
        k3 = dt * f(x + 0.5 * k2)
        k4 = dt * f(x + k3)
        x = x + (k1 + 2 * k2 + 2 * k3 + k4) / 6
    return xs, dxs


def gp_smooth(x, dt: float, noise: float, sigma_in: float):
    """(dx, x) smoothed: x (T, n, dim) -> both (T, n, dim) float32."""
    T, n, dim = x.shape
    dtype = torch.float32 if noise >= 0.15 else torch.float64
    t = torch.arange(T, dtype=dtype, device=x.device) * dt
    Y = x.reshape(T, n * dim).to(dtype)
    if dtype == torch.float64:
        K = torch.exp(-(t[:, None] - t[None, :]) ** 2 / (2 * sigma_in ** 2))
        K2 = torch.exp(-((t + 1e-3)[:, None] - t[None, :]) ** 2 / (2 * sigma_in ** 2))
    else:
        K = 1.0 ** 2 * torch.exp(-1.0 / (2 * sigma_in ** 2) * (t[:, None] - t[None, :]) ** 2)
        K2 = 1.0 ** 2 * torch.exp(-1.0 / (2 * sigma_in ** 2) * ((t + 1e-3)[:, None] - t[None, :]) ** 2)
    D = (K2 - K) / 1e-3
    del K2
    L = torch.linalg.cholesky(K + noise ** 2 * torch.eye(T, dtype=dtype, device=x.device))
    Z = torch.linalg.solve_triangular(L, Y, upper=False)
    Z = torch.linalg.solve_triangular(L.mT, Z, upper=True)
    xs, dxs = (K @ Z).reshape(T, n, dim), (D @ Z).reshape(T, n, dim)
    return dxs.to(torch.float32), xs.to(torch.float32)


def trajectories(data: dict, seed: int, device):
    """(x, dx), each (n_ics, num_steps, dim) float32: the configuration's
    ``data`` section drawn from torch.Generator(device).manual_seed(seed),
    the initial conditions first and then the noise."""
    f, ics = SYSTEMS[data["system"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x0 = ics(gen, data["n_ics"]).to(device)
    x, dx = rk4_record(f, x0, data["dt"], data["num_steps"])
    noise = data["noise"]
    if noise > 0:
        x_std = torch.std(x, dim=(0, 1), correction=0)
        eps = torch.randn(x.shape, generator=gen, device=gen.device).to(device)
        x = x + eps * noise * x_std
        if data["smoothing"] != "gp":
            raise ValueError(f"smoothing {data['smoothing']!r} is not in the reference")
        dx, x = gp_smooth(x, data["dt"], noise, data["gp_sigma_in"])
    return x.transpose(0, 1).contiguous(), dx.transpose(0, 1).contiguous()


def windows(x, n_timesteps: int, interval: int):
    """(n_ics * n_windows, n_timesteps, dim): x[i, j : j + n_timesteps *
    interval : interval] for j < n_steps - n_timesteps * interval."""
    n_ics, n_steps, dim = x.shape
    n_win = n_steps - n_timesteps * interval
    idx = torch.arange(n_win, device=x.device)[:, None] + interval * torch.arange(
        n_timesteps, device=x.device)[None, :]
    return x[:, idx].reshape(n_ics * n_win, n_timesteps, dim)

