"""Conversion of the JAX package's parameters (as numpy arrays) into the
port's tensors.

Nothing here imports JAX: a JAX array or state is read through
``np.asarray`` on its fields. Both packages store Q in the row-major vec(Xi)
convention and theta as [beta, const], so conversion is a change of
container, dtype and device; these functions pin that layout down.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.sindy import SINDyState

_STATE_FIELDS = ("Xi", "mask", "beta", "const", "Q")


def _f32(a, device) -> torch.Tensor:
    # a row-major copy: JAX arrays read through np.asarray are read-only, and
    # Q from the SVD is a column-major slice
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)


def sindy_state(jax_state, device=None) -> SINDyState:
    """The port's SINDyState from the JAX package's (Xi, mask, beta, const, Q
    fields), such that the port's get_Xi equals the JAX one."""
    device = resolve_device(device)
    return SINDyState(**{f: _f32(getattr(jax_state, f), device) for f in _STATE_FIELDS})


def q_matrix(Q, device=None) -> torch.Tensor:
    """Q (d*p, r), row-major vec(Xi) convention, as float32."""
    Q = _f32(Q, resolve_device(device))
    if Q.ndim != 2:
        raise ValueError(f"Q must be 2-D, got shape {tuple(Q.shape)}")
    return Q


def theta0(th0, device=None) -> torch.Tensor:
    """Initial parameters (lanes, n_params) = [beta, const] per lane, as float32."""
    th0 = _f32(th0, resolve_device(device))
    if th0.ndim != 2:
        raise ValueError(f"theta0 must be (lanes, n_params), got {tuple(th0.shape)}")
    return th0
