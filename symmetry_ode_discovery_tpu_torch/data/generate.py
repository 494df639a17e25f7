"""Trajectory generation: integrate, corrupt with noise, smooth and
differentiate, subsample.

1. integrate the batch of ICs with RK4, recording the exact dx at every sample;
2. optional noise: additive, scaled by the per-dimension std of the clean
   signal, or multiplicative (the growth protocol);
3. derivative recovery: forward finite differences when no smoothing is asked
   for (the last row keeps the clean dx), or GP smoothing of x and dx ('gp');
4. stride subsample, then transpose to (n_ics, num_steps, dim).

``gen_data_levels`` does this for several generators and noise levels with
one RK4 solve over all their ICs: the solve is elementwise and
launch-bound, so each level's result is gen_data's alone, bit for bit, in
the time of one level's solve.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import resolve_device
from ..ops.gp_smoothing import num_diff_gp
from ..ops.integrators import solve_ode_batch
from .systems import System

__all__ = ["gen_data", "gen_data_levels"]


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
    return gen_data_levels(system, [generator], [noise], n_ics, dt, num_steps, subsample_rate,
                           multiplicative_noise, smoothing, gp_sigma_in, gp_engine, device)[0]


def gen_data_levels(
    system: System,
    generators: Sequence[torch.Generator],
    noises: Sequence[float],
    n_ics: Optional[int] = None,
    dt: Optional[float] = None,
    num_steps: Optional[int] = None,
    subsample_rate: Optional[int] = None,
    multiplicative_noise: bool = False,
    smoothing: Optional[str] = None,
    gp_sigma_in: Optional[float] = None,
    gp_engine: str = "auto",
    device=None,
) -> List[tuple]:
    """gen_data(system, generators[i], noise=noises[i], ...) for every i, as
    a list of (x, dx), with one RK4 solve over all the generators' ICs
    (each generator draws its ICs, then its noise, as gen_data does)."""
    device = resolve_device(device)
    n_ics = system.default_n_train if n_ics is None else n_ics
    dt = system.default_dt if dt is None else dt
    num_steps = system.default_num_steps if num_steps is None else num_steps
    if subsample_rate is None:
        subsample_rate = system.default_subsample_rate
    if gp_sigma_in is None:
        gp_sigma_in = system.default_gp_sigma_in

    x0 = torch.cat([system.sample_ics(g, n_ics).to(device) for g in generators])
    xs, dxs = solve_ode_batch(system.f, x0, dt=dt, num_steps=num_steps)
    # (num_steps, levels * n_ics, dim), dx exact at every sample
    out = []
    for i, (generator, noise) in enumerate(zip(generators, noises)):
        rows = slice(i * n_ics, (i + 1) * n_ics)
        x, dx = xs[:, rows].contiguous(), dxs[:, rows].contiguous()
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
        out.append((x[::subsample_rate].transpose(0, 1).contiguous(),
                    dx[::subsample_rate].transpose(0, 1).contiguous()))
    return out
