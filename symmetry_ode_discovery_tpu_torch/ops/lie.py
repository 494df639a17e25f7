"""Lie-algebra primitives: the so(n) basis and the batched matrix exponential.

The port's copy of symmetry_ode_discovery_tpu/ops/lie.py. The exponential of
the 2x2 blocks that LaLiGAN's group sampling builds is the JAX package's
closed form (expm2x2), written with the same branches so that its value and
its gradient round as the reference's do; ``torch.linalg.matrix_exp`` is
used only for larger blocks, where the JAX package falls back to a Pade
approximant.
"""

from __future__ import annotations

import numpy as np
import torch


def so(n: int) -> np.ndarray:
    """so(n) basis (n(n-1)/2, n, n): for each i, each j < i, L[i, j] = 1 and
    L[j, i] = -1."""
    L = np.zeros((n * (n - 1) // 2, n, n), dtype=np.float32)
    k = 0
    for i in range(n):
        for j in range(i):
            L[k, i, j] = 1.0
            L[k, j, i] = -1.0
            k += 1
    return L


def expm2x2(A: torch.Tensor) -> torch.Tensor:
    """exp of 2x2 matrices (..., 2, 2) in closed form. With M = aI + B, B
    traceless and B^2 = delta I: exp(M) = e^a (C I + S B), C = cosh(r), S =
    sinh(r)/r for delta = r^2 >= 0 and cos/sin for delta < 0. Below |delta|
    1e-6 the second-order Taylor terms C = 1 + delta/2, S = 1 + delta/6 are
    taken, and the closed form is evaluated on a safe delta there (the double
    where), so value and gradient stay finite at delta = 0."""
    a = 0.5 * (A[..., 0, 0] + A[..., 1, 1])
    b00 = A[..., 0, 0] - a
    b01 = A[..., 0, 1]
    b10 = A[..., 1, 0]
    delta = b00 * b00 + b01 * b10
    small = delta.abs() < 1e-6
    one = torch.ones_like(delta)
    delta_safe = torch.where(small, one, delta)
    r = torch.sqrt(delta_safe.abs())
    pos = delta_safe >= 0
    C_big = torch.where(pos, torch.cosh(r), torch.cos(r))
    S_big = torch.where(pos, torch.sinh(r), torch.sin(r)) / r
    C = torch.where(small, 1.0 + delta / 2.0, C_big)
    S = torch.where(small, 1.0 + delta / 6.0, S_big)
    ea = torch.exp(a)
    e00 = ea * (C + S * b00)
    e01 = ea * S * b01
    e10 = ea * S * b10
    e11 = ea * (C - S * b00)
    return torch.stack([torch.stack([e00, e01], -1), torch.stack([e10, e11], -1)], -2)


def expm(A: torch.Tensor) -> torch.Tensor:
    """Matrix exponential batched over the leading axes: the closed form for
    2x2 blocks, ``torch.linalg.matrix_exp`` for larger ones."""
    if A.shape[-2:] == (2, 2):
        return expm2x2(A)
    return torch.linalg.matrix_exp(A)
