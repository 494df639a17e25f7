"""Equivariance constraint for SINDy coefficients (EquivSINDy-c), host-side.

The constraint is L_i Xi = Xi M_i for each Lie-algebra basis element L_i,
where M_i is the representation of L_i on the polynomial library. For a
monomial theta_t(z) = z^{E_t},

    M_i[t, u] = sum over (m, j) with E_t - e_m + e_j = E_u of E_{tm} * L_i[m, j],

exact integer combinatorics on the exponent table. The null space Q of the
stacked constraint matrix comes from an SVD with the 5e-3 trailing
singular-value cutoff. Everything here is numpy in float64, computed once per
configuration, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

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
