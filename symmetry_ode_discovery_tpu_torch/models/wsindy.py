"""Weak SINDy: trigonometric test functions and the weak-form regression.

The test-function matrices are built once; each solve is one masked ridge
least-squares solve per output dimension (ops/linalg.py), batched over
seeds when the trajectory carries a leading seed dimension.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.linalg import masked_lstsq_per_dim
from .sindy import SINDyConfig, SINDyState, set_threshold


@dataclasses.dataclass
class WSINDyMatrices:
    """Integration matrices V (test functions) and V_drv (their time
    derivatives), both (K, T) and premultiplied by dt."""

    V: torch.Tensor
    V_drv: torch.Tensor


def make_wsindy_matrices(t: torch.Tensor, t_max: float, num_test_funcs: int = 50,
                         test_func_family: str = "trig") -> WSINDyMatrices:
    """g_k(t) = sqrt(2 / t_max) sin(k pi t / t_max), k = 1..K, and their
    analytic derivatives, on the sample times t (T,)."""
    if test_func_family != "trig":
        raise NotImplementedError(f"test_func_family={test_func_family} not implemented")
    dt = t[1] - t[0]
    k = torch.arange(1, num_test_funcs + 1, dtype=torch.float32, device=t.device)[:, None]
    arg = k * math.pi * t[None, :] / t_max
    g = math.sqrt(2 / t_max) * torch.sin(arg)
    g_drv = math.sqrt(2 / t_max) * k * math.pi / t_max * torch.cos(arg)
    return WSINDyMatrices(V=dt * g, V_drv=dt * g_drv)


def wsindy_solve_step(cfg: SINDyConfig, state: SINDyState, mats: WSINDyMatrices,
                      x: torch.Tensor, w_sindy_reg: float, st_threshold: float):
    """One weak-form solve and threshold on the uniformly sampled trajectory
    x (..., T, dim). Returns (state, residual (...,), converged (...,))."""
    # this solver writes Xi directly; under the constraint get_Xi and
    # set_threshold would re-derive Xi from the untouched beta and report
    # the initial coefficients
    assert not cfg.constraint, (
        "wsindy_solve_step solves unconstrained Xi; the equivariance "
        "constraint (beta parameterization) is not supported on the "
        "weak-form path (the reference never combines them either)")
    theta = cfg.library(x)                     # (..., T, p)
    G = mats.V @ theta                         # (..., K, p)
    b = -mats.V_drv @ x                        # (..., K, dim)
    p = G.shape[-1]
    eye = (math.sqrt(w_sindy_reg) if w_sindy_reg > 0 else 0.0) * torch.eye(
        p, dtype=G.dtype, device=G.device)
    VtG = mats.V.mT @ G                        # (..., T, p)
    G_aug = torch.cat([VtG, eye.expand(VtG.shape[:-2] + (p, p))], dim=-2)
    Vtb = mats.V.mT @ b
    b_aug = torch.cat([Vtb, Vtb.new_zeros(Vtb.shape[:-2] + (p, Vtb.shape[-1]))], dim=-2)

    Xi = masked_lstsq_per_dim(G_aug, b_aug, state.mask)
    new_state = dataclasses.replace(state, Xi=Xi)
    resid = ((G_aug @ (Xi * state.mask).mT - b_aug) ** 2).mean(dim=(-2, -1))
    new_state = set_threshold(cfg, new_state, st_threshold)
    converged = (new_state.mask == state.mask).flatten(-2).all(-1)
    return new_state, resid, converged


def solve_wsindy(cfg: SINDyConfig, state: SINDyState, mats: WSINDyMatrices, x: torch.Tensor,
                 w_sindy_reg: float, st_threshold: float, num_epochs: int = 10):
    """``num_epochs`` weak solves, never breaking early (each one repeats
    the last once the mask is fixed). Returns (state, last residual)."""
    resid = None
    for _ in range(num_epochs):
        state, resid, _ = wsindy_solve_step(cfg, state, mats, x, w_sindy_reg, st_threshold)
    return state, resid
