"""Fixed-shape masked least squares for sparse regression (STLSQ, WSINDy).

Masked library columns are zeroed instead of pruned, and the system is
solved for its minimum-norm least-squares solution: a zero column lies in
the null space, so its coefficient comes out exactly 0 and the others equal
the pruned system's. A is therefore rank-deficient on purpose, which
``torch.linalg.lstsq`` on CUDA (the ``gels`` driver, full rank assumed)
does not handle. The solve is a reduced QR of A followed by an SVD
pseudo-inverse of the small triangular factor, with numpy's lstsq cutoff:
singular values at or below eps * max(m, n) times the largest are dropped.
QR and SVD sign conventions differ between LAPACK and cuSOLVER; the
min-norm solution does not depend on them.

Every function takes leading batch dimensions (seeds, output dims):
``torch.linalg.qr`` and ``torch.linalg.svd`` factor a batch at once.
"""

from __future__ import annotations

from typing import Optional

import torch


def min_norm_lstsq(A: torch.Tensor, b: torch.Tensor,
                   rcond: Optional[float] = None) -> torch.Tensor:
    """Minimum-norm least-squares solution of A x = b for A (..., m, n) and
    b (..., m) or (..., m, k), with the singular-value cutoff
    ``rcond`` * max(s) (default eps * max(m, n))."""
    q, r = torch.linalg.qr(A)                  # reduced: q (..., m, n), r (..., n, n)
    vec = b.ndim == A.ndim - 1
    c = q.mT @ (b.unsqueeze(-1) if vec else b)
    u, s, vt = torch.linalg.svd(r, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    cutoff = rcond * s.amax(dim=-1, keepdim=True)
    s_inv = torch.where(s > cutoff, 1.0 / torch.where(s > 0, s, 1.0), 0.0)
    x = vt.mT @ (s_inv.unsqueeze(-1) * (u.mT @ c))
    return x.squeeze(-1) if vec else x


def ridge_augment(theta: torch.Tensor, y: torch.Tensor, gamma: float):
    """([theta; gamma I], [y; 0]) over the last two dims: a penalty of
    gamma^2 |w|^2 (gamma, not its square root, as the reference stacks it)."""
    p = theta.shape[-1]
    eye = gamma * torch.eye(p, dtype=theta.dtype, device=theta.device)
    A = torch.cat([theta, eye.expand(theta.shape[:-2] + (p, p))], dim=-2)
    zeros = torch.zeros(y.shape[:-2] + (p, y.shape[-1]), dtype=y.dtype, device=y.device)
    return A, torch.cat([y, zeros], dim=-2)


def masked_lstsq_per_dim(A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """For each output dim j, min |A diag(mask[j]) w - B[:, j]|^2 with the
    masked coefficients pinned to 0. A (..., m, p), B (..., m, d), mask
    (..., d, p) in {0, 1}; returns Xi (..., d, p). One batched solve over
    the leading dims and the output dims."""
    m = mask.to(A.dtype)
    Am = A.unsqueeze(-3) * m.unsqueeze(-2)     # (..., d, m, p)
    Xi = min_norm_lstsq(Am, B.mT)              # (..., d, p)
    return Xi * m
