"""Hyper-parameters of the L-BFGS discovery protocol."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LBFGSHParams:
    """Static hyper-parameters of the L-BFGS discovery loop: torch-style
    fixed-lr L-BFGS (no line search) with the inner-loop stall breaks, and
    sequential thresholding every ``st_freq`` epochs or on convergence
    (parameter delta below ``tol``)."""

    num_epochs: int = 100
    lr_sindy: float = 1.0
    w_sindy_x: float = 1.0
    w_sindy_reg: float = 0.0
    sindy_reg_type: str = "l1"  # 'l1' | 'none'
    st_freq: int = 100
    threshold: float = 1e-2
    tol: float = 1e-3
    inner_iters: int = 20  # torch LBFGS max_iter default
