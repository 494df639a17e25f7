"""RK4 integration of a batch of initial conditions (data generation).

The JAX package writes the step loop as a ``lax.scan``; here it is a Python
loop over steps on the device, writing into preallocated outputs.
"""

from __future__ import annotations

from typing import Callable

import torch


def _rk4_step(f: Callable, x: torch.Tensor, dt: float) -> torch.Tensor:
    k1 = f(x)
    k2 = f(x + dt / 2 * k1)
    k3 = f(x + dt / 2 * k2)
    k4 = f(x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def solve_ode_batch(
    ode: Callable,
    x0: torch.Tensor,
    dt: float = 0.002,
    num_steps: int = 2000,
):
    """RK4 over a batch of initial conditions, recording x and the exact dx
    at every sample: dx[i] = ode(x[i]), and the last step does not advance x.
    Returns (x, dx), each (num_steps, *x0.shape), on x0's device and dtype."""
    xs = torch.empty((num_steps,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    dxs = torch.empty_like(xs)
    x = x0
    for i in range(num_steps):
        dx = ode(x)
        xs[i] = x
        dxs[i] = dx
        k1 = dt * dx
        k2 = dt * ode(x + 0.5 * k1)
        k3 = dt * ode(x + 0.5 * k2)
        k4 = dt * ode(x + k3)
        x = x + (k1 + 2 * k2 + 2 * k3 + k4) / 6
    return xs, dxs
