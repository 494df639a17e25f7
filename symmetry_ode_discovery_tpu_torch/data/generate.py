"""Trajectory generation: integrate, corrupt with noise, smooth and
differentiate, subsample.

1. integrate the batch of ICs with RK4, recording the exact dx at every sample;
2. optional noise: additive, scaled by the per-dimension std of the clean
   signal, or multiplicative (the growth protocol);
3. derivative recovery: forward finite differences when no smoothing is asked
   for (the last row keeps the clean dx), or GP smoothing of x and dx ('gp');
4. stride subsample, then transpose to (n_ics, num_steps, dim).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..ops.gp_smoothing import num_diff_gp
from ..ops.integrators import solve_ode_batch
from .systems import System

__all__ = ["gen_data"]


def gen_data(
    system: System,
    generator: torch.Generator,
    n_ics: Optional[int] = None,
    dt: Optional[float] = None,
    num_steps: Optional[int] = None,
    subsample_rate: Optional[int] = None,
    noise: float = 0.0,
    multiplicative_noise: bool = False,
    smoothing: Optional[str] = None,
    gp_sigma_in: Optional[float] = None,
    gp_engine: str = "auto",
    device=None,
):
    """(x, dx), each (n_ics, num_steps // subsample_rate, dim) float32 on
    ``device``. Arguments default to the system's protocol. ``generator``
    draws the ICs and then the noise, on the generator's own device."""
    device = resolve_device(device)
    n_ics = system.default_n_train if n_ics is None else n_ics
    dt = system.default_dt if dt is None else dt
    num_steps = system.default_num_steps if num_steps is None else num_steps
    if subsample_rate is None:
        subsample_rate = system.default_subsample_rate
    if gp_sigma_in is None:
        gp_sigma_in = system.default_gp_sigma_in

    x0 = system.sample_ics(generator, n_ics).to(device)
    x, dx = solve_ode_batch(system.f, x0, dt=dt, num_steps=num_steps)
    # (num_steps, n_ics, dim), dx exact at every sample

    if noise > 0:
        x_std = torch.std(x, dim=(0, 1), correction=0)
        eps = torch.randn(x.shape, generator=generator,
                          device=generator.device).to(device)
        if multiplicative_noise:
            x = x * (1.0 + eps * noise)
        else:
            x = x + eps * noise * x_std
        if smoothing is None:
            dx[:-1] = torch.diff(x, dim=0) / dt
        elif smoothing == "gp":
            dx, x = num_diff_gp(x, dt, noise_level=noise, std_base=x_std,
                                sigma_in=gp_sigma_in, engine=gp_engine)
        else:
            raise ValueError(f"unknown smoothing mode: {smoothing!r}")

    x = x[::subsample_rate].transpose(0, 1).contiguous()
    dx = dx[::subsample_rate].transpose(0, 1).contiguous()
    return x, dx
