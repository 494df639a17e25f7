"""Equivariance constraint for SINDy coefficients (EquivSINDy-c), host-side.

The constraint is L_i Xi = Xi M_i for each Lie-algebra basis element L_i,
where M_i is the representation of L_i on the polynomial library. For a
monomial theta_t(z) = z^{E_t},

    M_i[t, u] = sum over (m, j) with E_t - e_m + e_j = E_u of E_{tm} * L_i[m, j],

exact integer combinatorics on the exponent table. The null space Q of the
stacked constraint matrix comes from an SVD with the 5e-3 trailing
singular-value cutoff. ``get_Q`` is numpy in float64, computed once per
configuration, as in the JAX package.

Joint SINDy-in-latent training recomputes Q on the device as the generator
drifts (training/lassi.py): ``m_weight_tensor`` is the integer tensor W with
M(L) = einsum('tumj,mj->tu', W, L), built once, and ``get_Q_padded`` the
null space of the stacked constraints of L as a (d*p, d*p) matrix whose
non-null columns are zero, in torch on L's device and dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .library import FunctionLibrary, poly_exponent_table


def get_M_list(library: FunctionLibrary, L_list: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Representation matrices M_i of each L_i on the polynomial library."""
    if library.include_sine or library.include_exp:
        raise ValueError("the equivariance constraint supports the polynomial library only")
    E = poly_exponent_table(library.dim, library.poly_order)
    p, d = E.shape
    index = {tuple(row): t for t, row in enumerate(E.tolist())}
    M_list = []
    for L in L_list:
        L = np.asarray(L, dtype=np.float64)
        M = np.zeros((p, p), dtype=np.float64)
        for t in range(p):
            for m in range(d):
                if E[t, m] == 0:
                    continue
                for j in range(d):
                    v = E[t].copy()
                    v[m] -= 1
                    v[j] += 1
                    M[t, index[tuple(v)]] += E[t, m] * L[m, j]
        M_list.append(M)
    return M_list


def get_Q(
    library: FunctionLibrary,
    L_list: Sequence[np.ndarray],
    sv_cutoff: float = 5e-3,
) -> Tuple[np.ndarray, bool]:
    """Null-space basis Q (d*p, r) of the stacked constraints and whether the
    Kronecker (row-major vec) branch was taken for the last L.

    Per L: det(L) >= 1e-5 uses kron(L^-1, M^T) - I on the row-major vec of Xi,
    otherwise the Sylvester form kron(-M^T, I) + kron(I, L) on the
    column-major vec. A full-rank constraint (no singular value under the
    cutoff) keeps all of V, i.e. leaves Xi unconstrained.
    """
    M_list = get_M_list(library, L_list)
    d = library.dim
    p = M_list[0].shape[0]
    C_list = []
    use_kron = False
    for L, M in zip(L_list, M_list):
        L = np.asarray(L, dtype=np.float64)
        if np.linalg.det(L) < 1e-5:
            use_kron = False
            C = np.kron(-M.T, np.eye(d)) + np.kron(np.eye(p), L)
        else:
            use_kron = True
            C = np.kron(np.linalg.inv(L), M.T) - np.eye(d * p)
        C_list.append(C)
    _, Sigma, Vt = np.linalg.svd(np.concatenate(C_list, axis=0))
    V = Vt.T
    r = 0
    for r in range(len(Sigma)):
        if abs(Sigma[-1 - r]) > sv_cutoff:
            break
    Q = V if r == 0 else V[:, V.shape[1] - r:]
    return np.asarray(Q, dtype=np.float32), use_kron


def q_row_major(Q: np.ndarray, d: int, p: int, use_kron: bool) -> np.ndarray:
    """Re-index the rows of Q to the row-major vec(Xi) convention (the
    Sylvester branch produces column-major rows)."""
    if use_kron:
        return Q
    perm = np.arange(d * p).reshape(p, d).T.reshape(-1)
    return Q[perm]


def m_weight_tensor(library: FunctionLibrary) -> np.ndarray:
    """W (p, p, d, d) float32 with M(L) = einsum('tumj,mj->tu', W, L): M is
    linear in L with the integer weights E_tm of get_M_list."""
    E = poly_exponent_table(library.dim, library.poly_order)
    p, d = E.shape
    index = {tuple(row): t for t, row in enumerate(E.tolist())}
    W = np.zeros((p, p, d, d), dtype=np.float32)
    for t in range(p):
        for m in range(d):
            if E[t, m] == 0:
                continue
            for j in range(d):
                v = E[t].copy()
                v[m] -= 1
                v[j] += 1
                W[t, index[tuple(v)], m, j] += E[t, m]
    return W


def _kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # torch.kron views its operands: a transposed or column-major one fails
    return torch.kron(a.contiguous(), b.contiguous())


def get_Q_padded(W: torch.Tensor, L: torch.Tensor, sv_cutoff: float = 5e-3,
                 return_s: bool = False):
    """Q (d*p, d*p) in the row-major vec(Xi) convention: the null space of
    the stacked constraints of L (one (d, d) generator or a (c, d, d) stack)
    in the columns whose singular value is at most ``sv_cutoff``, the other
    columns zero; all of V when no singular value is (a full-rank
    constraint leaves Xi unconstrained). Per channel, det(L_i) >= 1e-5
    takes the Kronecker form kron(L_i^-1, M_i^T) - I, otherwise the
    Sylvester form kron(-M_i^T, I) + kron(I, L_i) on the column-major vec;
    the last channel's branch sets the convention, so a Sylvester last
    channel has its rows permuted to row-major. The branches are chosen on
    the host. With ``return_s``, also the singular values (descending)."""
    if L.ndim == 2:
        L = L[None]
    p, d = W.shape[0], L.shape[-1]
    W = W.to(L.dtype)
    eye_d = torch.eye(d, dtype=L.dtype, device=L.device)
    eye_p = torch.eye(p, dtype=L.dtype, device=L.device)
    eye_dp = torch.eye(d * p, dtype=L.dtype, device=L.device)
    pieces, use_kron = [], False
    for Li in L:
        MT = torch.einsum("tumj,mj->ut", W, Li)
        use_kron = bool(torch.linalg.det(Li) >= 1e-5)
        if use_kron:
            pieces.append(_kron(torch.linalg.inv(Li), MT) - eye_dp)
        else:
            pieces.append(_kron(-MT, eye_d) + _kron(eye_p, Li))
    _, S, Vh = torch.linalg.svd(torch.cat(pieces, dim=0), full_matrices=False)
    null = S <= sv_cutoff
    col_mask = null.to(L.dtype) if bool(null.any()) else torch.ones_like(S)
    Q = Vh.mT * col_mask[None, :]
    if not use_kron:
        Q = Q[torch.arange(d * p).reshape(p, d).T.reshape(-1).to(Q.device)]
    return (Q, S) if return_s else Q
