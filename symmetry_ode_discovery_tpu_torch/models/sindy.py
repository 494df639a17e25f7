"""SINDy configuration and state.

For the unconstrained path Xi itself is the free parameter; for the
equivariance-constrained path (EquivSINDy-c) beta (and optionally one
constant per equation) are free and Xi = unvec_row_major(Q beta) [+ const].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.constraint import get_Q, q_row_major
from ..ops.library import FunctionLibrary


@dataclasses.dataclass(frozen=True)
class SINDyConfig:
    """Static configuration. Under the constraint sine/exp terms are
    disabled and ``allow_constant`` is the negation of ``constrain_constant``.
    ``dangling_const`` keeps const as a parameter that never reaches Xi but
    still feeds the L1 term and the convergence delta."""

    latent_dim: int
    poly_order: int = 2
    include_sine: bool = False
    include_exp: bool = False
    constraint: bool = False
    use_kron_product: bool = True
    allow_constant: bool = True
    dangling_const: bool = False
    n_free: int = 0  # beta parameters (columns of Q); 0 if unconstrained
    threshold: float = 0.1

    @property
    def library(self) -> FunctionLibrary:
        return FunctionLibrary(
            dim=self.latent_dim,
            poly_order=self.poly_order,
            include_sine=self.include_sine and not self.constraint,
            include_exp=self.include_exp and not self.constraint,
        )

    @property
    def n_terms(self) -> int:
        return self.library.n_terms


@dataclasses.dataclass
class SINDyState:
    """Coefficient state. Xi (d, p) is the parameter when unconstrained;
    beta (q,), const (d, 1) and Q (d*p, q, row-major vec) when constrained."""

    Xi: torch.Tensor
    mask: torch.Tensor
    beta: torch.Tensor
    const: torch.Tensor
    Q: torch.Tensor


def make_config(
    latent_dim: int,
    poly_order: int = 2,
    include_sine: bool = False,
    include_exp: bool = False,
    L_list: Sequence[np.ndarray] = (),
    constrain_constant: bool = False,
    threshold: float = 0.1,
    dangling_const: bool = False,
) -> tuple[SINDyConfig, Optional[np.ndarray]]:
    """(config, Q in the row-major vec convention, or None when unconstrained)."""
    if len(L_list) == 0:
        cfg = SINDyConfig(latent_dim=latent_dim, poly_order=poly_order,
                          include_sine=include_sine, include_exp=include_exp,
                          constraint=False, threshold=threshold)
        return cfg, None
    lib = FunctionLibrary(latent_dim, poly_order, False, False)
    Q, use_kron = get_Q(lib, L_list)
    cfg = SINDyConfig(
        latent_dim=latent_dim,
        poly_order=poly_order,
        constraint=True,
        use_kron_product=use_kron,
        allow_constant=not constrain_constant,
        dangling_const=dangling_const and constrain_constant,
        n_free=Q.shape[1],
        threshold=threshold,
    )
    return cfg, q_row_major(Q, latent_dim, lib.n_terms, use_kron)


def get_Xi(cfg: SINDyConfig, state: SINDyState) -> torch.Tensor:
    """Current coefficient matrix (d, p)."""
    if not cfg.constraint:
        return state.Xi
    d, p = cfg.latent_dim, cfg.n_terms
    Xi = (state.Q @ state.beta).reshape(d, p)
    if cfg.allow_constant:
        Xi = Xi.clone()
        Xi[:, 0] = Xi[:, 0] + state.const.reshape(d)
    return Xi


def equation_strings(cfg: SINDyConfig, state: SINDyState, var: str = "z") -> List[str]:
    """One 'dz_i = c*term + ...' line per equation, masked terms left out."""
    Xi = get_Xi(cfg, state).detach().cpu().numpy()
    mask = state.mask.detach().cpu().numpy()
    names = cfg.library.term_names(var)
    eqs = []
    for i in range(cfg.latent_dim):
        eq = f"d{var}{i} ="
        for pos, name in enumerate(names):
            if mask[i, pos]:
                eq += f" {Xi[i, pos]:.3f}" + ("" if name == "1" else f"*{name}") + " +"
        eqs.append(eq)
    return eqs
