"""SINDy configuration, state and the direct STLSQ solvers.

For the unconstrained path Xi itself is the free parameter; for the
equivariance-constrained path (EquivSINDy-c) beta (and optionally one
constant per equation) are free and Xi = unvec_row_major(Q beta) [+ const].

STLSQ (``solve_sindy``) iterates a masked ridge least-squares solve and a
threshold for a fixed number of iterations: once the mask stops changing an
iteration repeats the last one, so this equals an early-breaking loop.
Every function here takes a state whose tensors may carry one leading
batch dimension (seeds), and solves the batch at once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.constraint import get_Q, q_row_major, xi_from_beta
from ..ops.library import FunctionLibrary
from ..ops.linalg import masked_lstsq_per_dim, min_norm_lstsq, ridge_augment


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


def init_sindy(gen: torch.Generator, cfg: SINDyConfig, Q: Optional[np.ndarray] = None,
               device=None) -> SINDyState:
    """Standard-normal initial state drawn from ``gen``: beta and const
    under the constraint, Xi otherwise; the mask all ones."""
    d, p = cfg.latent_dim, cfg.n_terms
    device = gen.device if device is None else device
    if cfg.constraint:
        assert Q is not None and Q.shape[1] == cfg.n_free
        beta = torch.randn(cfg.n_free, generator=gen, device=gen.device).to(device)
        const = torch.randn((d, 1), generator=gen, device=gen.device).to(device)
        Qt = torch.as_tensor(np.asarray(Q), dtype=torch.float32, device=device)
        st = SINDyState(Xi=torch.zeros((d, p), device=device), mask=torch.ones((d, p), device=device),
                        beta=beta, const=const, Q=Qt)
        st.Xi = get_Xi(cfg, st)
        return st
    Xi = torch.randn((d, p), generator=gen, device=gen.device).to(device)
    return SINDyState(Xi=Xi, mask=torch.ones((d, p), device=device),
                      beta=torch.zeros(0, device=device), const=torch.zeros((d, 1), device=device),
                      Q=torch.zeros((d * p, 0), device=device))


def get_Xi(cfg: SINDyConfig, state: SINDyState) -> torch.Tensor:
    """Current coefficient matrix (..., d, p)."""
    if not cfg.constraint:
        return state.Xi
    return xi_from_beta(state.Q, state.beta, state.const, cfg.latent_dim, cfg.n_terms,
                        cfg.allow_constant)


def sindy_forward(cfg: SINDyConfig, state: SINDyState, x: torch.Tensor) -> torch.Tensor:
    """dx_pred = Theta(x) (Xi * mask)^T, batched over leading dims."""
    return cfg.library(x) @ (get_Xi(cfg, state) * state.mask).mT


def set_threshold(cfg: SINDyConfig, state: SINDyState, threshold: float) -> SINDyState:
    """Monotone mask update: mask &= |Xi| > threshold."""
    Xi = get_Xi(cfg, state)
    mask = ((Xi.abs() > threshold) & (state.mask > 0)).to(state.mask.dtype)
    return dataclasses.replace(state, mask=mask)


def reset_mask(state: SINDyState) -> SINDyState:
    return dataclasses.replace(state, mask=torch.ones_like(state.mask))


def _augmented_Q(state: SINDyState, cfg: SINDyConfig) -> torch.Tensor:
    """Q with one free-constant column per equation appended: column
    n_free + i has a single 1 at row i * p, dim i's constant term."""
    d, p = cfg.latent_dim, cfg.n_terms
    cols = torch.zeros(state.Q.shape[:-1] + (d,), dtype=state.Q.dtype, device=state.Q.device)
    cols[..., torch.arange(d) * p, torch.arange(d)] = 1.0
    return torch.cat([state.Q, cols], dim=-1)


def solve_sindy_one_step(cfg: SINDyConfig, state: SINDyState, x: torch.Tensor, y: torch.Tensor,
                         w_sindy_reg: float, st_threshold: float):
    """One STLSQ iteration on rows x, y (..., m, d): the masked ridge
    least-squares solve (masked columns zeroed, see ops/linalg.py), then the
    threshold. Returns (state, residual (...,), converged (...,))."""
    d, p = cfg.latent_dim, cfg.n_terms
    theta = cfg.library(x)
    A, B = ridge_augment(theta, y, w_sindy_reg)
    if not cfg.constraint:
        new_state = dataclasses.replace(state, Xi=masked_lstsq_per_dim(A, B, state.mask))
    else:
        Qa = _augmented_Q(state, cfg) if cfg.allow_constant else state.Q
        mflat = state.mask.reshape(state.mask.shape[:-2] + (d * p,)).to(A.dtype)
        Qm = Qa * mflat.unsqueeze(-1)
        # block-diag(A) @ Qm without the block diagonal: dim j's rows are
        # A @ Qm[j p:(j + 1) p]
        Qm_blocks = Qm.reshape(Qm.shape[:-2] + (d, p, Qm.shape[-1]))
        AQ = (A.unsqueeze(-3) @ Qm_blocks).reshape(A.shape[:-2] + (d * A.shape[-2], Qm.shape[-1]))
        b = B.mT.reshape(B.shape[:-2] + (-1,))
        sol = min_norm_lstsq(AQ, b)
        if cfg.allow_constant:
            new_state = dataclasses.replace(
                state, beta=sol[..., :cfg.n_free],
                const=sol[..., cfg.n_free:].reshape(sol.shape[:-1] + (d, 1)))
        else:
            new_state = dataclasses.replace(state, beta=sol)
    Xi = get_Xi(cfg, new_state)
    resid = ((theta @ (Xi * state.mask).mT - y) ** 2).mean(dim=(-2, -1))
    new_state = set_threshold(cfg, new_state, st_threshold)
    converged = (new_state.mask == state.mask).flatten(-2).all(-1)
    return new_state, resid, converged


def solve_sindy(cfg: SINDyConfig, state: SINDyState, x: torch.Tensor, y: torch.Tensor,
                w_sindy_reg: float, st_threshold: float, max_iter: int = 5):
    """STLSQ from a fresh mask: ``max_iter`` iterations of
    ``solve_sindy_one_step``. Returns (state, last residual)."""
    state = reset_mask(state)
    resid = None
    for _ in range(max_iter):
        state, resid, _ = solve_sindy_one_step(cfg, state, x, y, w_sindy_reg, st_threshold)
    return state, resid


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


def print_equations(cfg: SINDyConfig, state: SINDyState, var: str = "z") -> None:
    for eq in equation_strings(cfg, state, var):
        print(eq)
