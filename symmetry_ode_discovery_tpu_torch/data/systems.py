"""ODE systems: vector fields, initial-condition samplers and per-system
generation defaults.

The vector fields are plain functions on tensors; the samplers draw from an
explicit ``torch.Generator`` on that generator's device. The Lotka-Volterra
sampler rejects initial conditions outside the Hamiltonian window by
redrawing every still-invalid row together until all rows are valid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

__all__ = ["System", "SYSTEMS", "lv", "dosc", "growth", "selkov", "H_lv"]


def lv(x, a=2.0 / 3.0, b=4.0 / 3.0, c=1.0, d=1.0):
    """Lotka-Volterra in canonical (log) coordinates."""
    dx0 = a - b * torch.exp(x[..., 1])
    dx1 = c * torch.exp(x[..., 0]) - d
    return torch.stack([dx0, dx1], dim=-1)


def dosc(x, a=0.1):
    """Damped harmonic oscillator."""
    dx0 = -a * x[..., 0] - x[..., 1]
    dx1 = x[..., 0] - a * x[..., 1]
    return torch.stack([dx0, dx1], dim=-1)


def growth(x, a=0.1, b=0.3):
    """Growth system."""
    dx0 = a * x[..., 1] ** 2 - b * x[..., 0]
    dx1 = x[..., 1]
    return torch.stack([dx0, dx1], dim=-1)


def selkov(x, a=0.75, b=0.1, c=0.1):
    """Selkov glycolytic oscillator."""
    dx0 = a - b * x[..., 0] - x[..., 0] * x[..., 1] ** 2
    dx1 = -x[..., 1] + c * x[..., 0] + x[..., 0] * x[..., 1] ** 2
    return torch.stack([dx0, dx1], dim=-1)


def H_lv(x, a=2.0 / 3.0, b=4.0 / 3.0, c=1.0, d=1.0):
    """Lotka-Volterra Hamiltonian in canonical coordinates."""
    return (c * torch.exp(x[..., 0]) - d * x[..., 0]
            + b * torch.exp(x[..., 1]) - a * x[..., 1])


def _uniform(gen: torch.Generator, shape, low: float, high: float):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (high - low) + low


def sample_ics_lv(gen: torch.Generator, n: int, h_min=3.0, h_max=4.5):
    """log(U(0,1)^2) restricted to H in [h_min, h_max]."""
    x0 = torch.zeros((n, 2), device=gen.device)
    ok = torch.zeros(n, dtype=torch.bool, device=gen.device)
    while not bool(ok.all()):
        cand = torch.log(_uniform(gen, (n, 2), 1e-12, 1.0))
        h = H_lv(cand)
        cand_ok = (h >= h_min) & (h <= h_max)
        x0 = torch.where((~ok & cand_ok)[:, None], cand, x0)
        ok = ok | cand_ok
    return x0


def sample_ics_dosc(gen: torch.Generator, n: int, r_min=0.5, r_max=2.0):
    """Uniform radius in [0.5, 2], uniform angle."""
    r = _uniform(gen, (n,), r_min, r_max)
    theta = _uniform(gen, (n,), 0.0, 2.0 * math.pi)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_ics_growth(gen: torch.Generator, n: int):
    """U(0.2, 1)^2."""
    return _uniform(gen, (n, 2), 0.2, 1.0)


def sample_ics_selkov(gen: torch.Generator, n: int):
    """U(0.5, 1)^2."""
    return _uniform(gen, (n, 2), 0.5, 1.0)


@dataclass(frozen=True)
class System:
    """One ODE system: vector field, IC sampler and generation protocol.
    dt, num_steps and subsample_rate describe the raw simulation; cached
    datasets are spaced dt * subsample_rate apart."""

    name: str
    f: Callable = field(repr=False)
    sample_ics: Callable = field(repr=False)
    dim: int = 2
    default_dt: float = 0.002
    default_num_steps: int = 10000
    default_subsample_rate: int = 1
    default_gp_sigma_in: float = 0.1
    default_n_train: int = 200
    default_n_val: int = 20
    multiplicative_noise: bool = False


SYSTEMS = {
    "lv": System("lv", lv, sample_ics_lv, default_n_train=200, default_n_val=20),
    "dosc": System("dosc", dosc, sample_ics_dosc, default_subsample_rate=100,
                   default_n_train=50, default_n_val=5),
    "growth": System("growth", growth, sample_ics_growth,
                     default_num_steps=1000, default_subsample_rate=10,
                     default_gp_sigma_in=0.05, default_n_train=100,
                     default_n_val=10, multiplicative_noise=True),
    "selkov": System("selkov", selkov, sample_ics_selkov,
                     default_n_train=10, default_n_val=2),
}
