"""Long-term prediction accuracy of a discovered equation.

The port's counterpart of symmetry_ode_discovery_tpu/evaluation/eval_ltp.py:
roll the learned dynamics out with RK4 from each trajectory's initial state
(optionally through the autoencoder's latent space) and report the per-step
MSE against the ground-truth trajectories. The rollout is
``ops.integrators.odeint`` over all initial conditions at once.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.datasets import ode_dt_dict
from ..ops.integrators import odeint


def eval_ltp_accuracy(
    forward_fn: Callable,
    x,
    task: str,
    dt: Optional[float] = None,
    encode: Optional[Callable] = None,
    decode: Optional[Callable] = None,
    device=None,
) -> dict:
    """x: (n_ics, n_steps, n_dim) ground-truth trajectories, a tensor (the
    rollout runs on its device) or an array (moved to ``device``, the card
    unless the caller passes "cpu").

    forward_fn: the learned vector field (dz/dt or dx/dt) on (n_ics, dim)
    states. encode/decode: optional autoencoder maps for latent-space
    dynamics: encode the initial states, roll out in z, decode each step.

    Returns {'x_pred' (n_ics, n_steps - 1, n_dim), 't' (n_steps - 1,),
    'error' (n_ics, n_steps - 1)} as numpy arrays, the JAX package's schema.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x), dtype=torch.float32, device=resolve_device(device))
    x0 = x[:, 0]
    n_ics, n_steps, n_dim = x.shape
    n_steps -= 1
    if dt is None:
        dt = ode_dt_dict[task.split("_")[-1]]
    t_max = n_steps * dt

    with torch.no_grad():
        if encode is not None:
            z_pred = odeint(forward_fn, encode(x0), t_max, dt, method="rk4",
                            full_traj=True, num_steps=n_steps)
            # (n_steps, n_ics, latent) -> decode each step
            x_pred = decode(z_pred.reshape(-1, z_pred.shape[-1]))
            x_pred = x_pred.reshape(n_steps, n_ics, n_dim).transpose(0, 1)
        else:
            x_pred = odeint(forward_fn, x0, t_max, dt, method="rk4", full_traj=True,
                            num_steps=n_steps).transpose(0, 1)
        error = ((x[:, 1:] - x_pred) ** 2).mean(dim=-1)
    return {
        "x_pred": x_pred.cpu().numpy(),
        "t": np.arange(1, n_steps + 1) * dt,
        "error": error.cpu().numpy(),
    }
