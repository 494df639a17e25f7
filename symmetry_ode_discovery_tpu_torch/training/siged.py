"""Hyper-parameters of the L-BFGS discovery protocol, and the host-stepped
L-BFGS loop of the heavy (EquivSINDy-r) fits."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import lbfgs_dir


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
    w_sym_reg: float = 0.0
    st_freq: int = 100
    threshold: float = 1e-2
    tol: float = 1e-3
    inner_iters: int = 20  # torch LBFGS max_iter default
    # two-loop engine of the host-stepped fits, under the JAX package's flag
    # values: 'pallas' = the kernel csrc/lbfgs_dir.cu (K4) on the card,
    # 'xla' = its plain PyTorch version
    dir_backend: str = "xla"


# ---------------------------------------------------------------------------
# Host-stepped L-BFGS with convergence-triggered thresholding (the
# EquivSINDy-r fits), batched over a leading lane dimension.
# ---------------------------------------------------------------------------

TOL_CHANGE, TOL_GRAD = 1e-9, 1e-7
MEMORY_SIZE = 100  # torch.optim.LBFGS's history_size, what the reference runs
DIR_BACKENDS = ("xla", "pallas")  # the JAX package's flag values


def _make_param_fns(cfg, Q):
    """(n_params, groups, xi_of) for the free parameters of the regressor,
    flattened per lane as theta (lanes, n_params).

    Unconstrained: theta = vec(Xi) row-major, one parameter group.
    Constrained: theta = [beta, const] ([beta] without a constant), Xi from Q
    (row-major vec convention) plus the constant column; beta and const are
    separate groups, as the JAX package's parameter dict has them in its
    sorted-key order. ``groups`` are (start, stop) slices of theta."""
    d, p = cfg.latent_dim, cfg.n_terms
    if not cfg.constraint:
        def xi_of(theta):
            return theta.reshape(-1, d, p)

        return d * p, [(0, d * p)], xi_of
    if Q is None:
        raise ValueError("a constrained configuration needs Q")
    q = cfg.n_free
    has_const = cfg.allow_constant or cfg.dangling_const
    groups = [(0, q)] + ([(q, q + d)] if has_const else [])

    def xi_of(theta):
        Qt = torch.as_tensor(Q, dtype=theta.dtype, device=theta.device)
        Xi = (theta[:, :q] @ Qt.T).reshape(-1, d, p)
        if cfg.allow_constant:
            Xi = Xi + torch.nn.functional.pad(theta[:, q:q + d, None], (0, p - 1))
        return Xi

    return q + (d if has_const else 0), groups, xi_of


def _param_delta(a, b, groups):
    """Sum over parameter groups of the Euclidean norm of a - b, per lane."""
    return sum(torch.linalg.vector_norm(a[:, i:j] - b[:, i:j], dim=-1) for i, j in groups)


def _init_loop_state(theta0, mask0, hp: LBFGSHParams):
    lanes = theta0.shape[0]
    dev = theta0.device
    return dict(params=theta0, opt_state=lbfgs_dir.init_state(theta0, MEMORY_SIZE),
                prev=theta0, pprev=theta0,
                n_iters=torch.zeros(lanes, dtype=torch.int32, device=dev), mask=mask0,
                done=torch.zeros(lanes, dtype=torch.bool, device=dev),
                stop_epoch=torch.full((lanes,), hp.num_epochs, dtype=torch.int32, device=dev))


def _where(cond, new, old):
    """Per-lane select over tensors or dicts of tensors (cond: (lanes,) bool)."""
    if isinstance(new, dict):
        return {k: _where(cond, new[k], old[k]) for k in new}
    return torch.where(cond.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _lbfgs_epoch_update(hp: LBFGSHParams, xi_of, groups, value_and_grad, state, epoch,
                        kernel_dir: bool):
    """One outer epoch of the fixed-lr (no line search) protocol on every
    lane: inner_iters L-BFGS iterations at a fixed mask with torch's inner
    breaks, then the convergence, thresholding and NaN bookkeeping.

    value_and_grad(theta, mask, idx) -> (loss (len(idx),), grad) evaluates
    the lanes ``idx`` only: a lane that is done, or frozen for the rest of
    the epoch, changes no state, so it is not evaluated (the JAX package
    evaluates and discards it)."""
    lr = hp.lr_sindy
    params, opt_state, mask, done = (state["params"], state["opt_state"], state["mask"],
                                     state["done"])
    lanes = params.shape[0]
    dev = params.device
    prev_val = torch.full((lanes,), float("inf"), device=dev)
    prev_step = torch.full((lanes,), float("inf"), device=dev)
    frozen = done.clone()
    for i in range(hp.inner_iters):
        idx = torch.nonzero(~frozen).flatten()
        if idx.numel() == 0:
            break
        value = torch.zeros(lanes, device=dev)
        grad = torch.zeros_like(params)
        v_a, g_a = value_and_grad(params[idx], mask[idx], idx)
        value[idx] = v_a
        grad[idx] = g_a
        gmax = grad.abs().amax(-1)
        frozen = frozen | (gmax <= TOL_GRAD)
        if i > 0:
            frozen = frozen | (prev_step <= TOL_CHANGE) | ((value - prev_val).abs() < TOL_CHANGE)
        # torch commits the curvature pair and prev_loss before the gtd
        # break fires, so that break freezes only the parameter step
        stalled = frozen.clone()
        first = opt_state["count"] == 0
        g1 = grad.abs().sum(-1)
        t1 = torch.minimum(torch.ones_like(g1), 1.0 / g1)
        with torch.profiler.record_function("lbfgs_update"):
            updates, new_opt = lbfgs_dir.update(opt_state, grad, params, lr, kernel_dir)
        gg = (grad * grad).sum(-1)
        gtd = torch.where(first, -gg, (grad * updates).sum(-1) / lr)
        frozen = frozen | (gtd > -TOL_CHANGE)
        # torch's first step after a (re)start: d = -g, t = min(1, 1/|g|_1) lr
        updates = torch.where(first[:, None], -lr * t1[:, None] * grad, updates)
        step_max = updates.abs().amax(-1)
        params = _where(frozen, params, params + updates)
        opt_state = _where(stalled, opt_state, new_opt)
        prev_val = torch.where(stalled, prev_val, value)
        prev_step = torch.where(frozen, prev_step, step_max)
    new_params = _where(done, state["params"], params)

    nan = torch.isnan(new_params).any(-1)
    n_iters = state["n_iters"] + 1
    conv = _param_delta(new_params, state["prev"], groups) < hp.tol
    final_conv = conv & (_param_delta(new_params, state["pprev"], groups) < hp.tol)
    if hp.st_freq > 0:
        st_hit = n_iters % hp.st_freq == 0
    else:
        st_hit = torch.zeros_like(conv)
    # a NaN lane stops before thresholding (|NaN| > thr would zero its mask)
    thresh = ~done & ~nan & ~final_conv & (conv | st_hit)
    Xi = xi_of(new_params)
    new_mask = _where(thresh, ((Xi.abs() > hp.threshold) & (mask > 0)).to(mask.dtype), mask)
    opt_state = _where(thresh, lbfgs_dir.init_state(new_params, MEMORY_SIZE), opt_state)
    pprev = _where(thresh & conv, new_params, state["pprev"])
    n_iters = torch.where(thresh, 0, n_iters)
    newly_done = ~done & (final_conv | nan)
    return dict(params=new_params, opt_state=opt_state, prev=new_params, pprev=pprev,
                n_iters=n_iters, mask=new_mask, done=done | newly_done,
                stop_epoch=torch.where(newly_done, epoch, state["stop_epoch"]))


def make_lbfgs_stepper(cfg, Q, hp: LBFGSHParams, sym_reg_fn=None, sym_reg_prep=None,
                       epochs_per_call: int = 1):
    """Host-stepped L-BFGS discovery on a leading lane dimension:

        init, step, extract = make_lbfgs_stepper(cfg, Q, hp, pen, prep)
        carry = init(x, dx, theta0)          # x, dx (lanes, k, dim)
        for e in range(0, hp.num_epochs, epochs_per_call):
            carry = step(carry, e)
            if bool(carry["done"].all()): break
        Xi, mask = extract(carry)

    The protocol of the JAX package's make_lbfgs_stepper: loss per lane
    w_x mean((Theta(x) (Xi m)^T - dx)^2) [+ w_sym pen(Xi m, x, ctx)]
    [+ w_reg |theta|_1]; optax-order fixed-lr L-BFGS with 100 pairs; torch's
    inner breaks; thresholding with an optimizer reset; the NaN stop; epochs
    past the budget are no-ops. ``sym_reg_fn(XiM (lanes, d, p), x, ctx)``
    returns the per-lane penalty (the fused-rollout penalty of
    ``training.symmreg.make_symmreg_i_fast``); ``sym_reg_prep(x) -> ctx``
    runs once in init. ``hp.dir_backend``: 'pallas' runs the two-loop kernel
    (K4) on CUDA tensors, 'xla' its plain version.
    """
    if hp.dir_backend not in DIR_BACKENDS:
        raise ValueError(f"dir_backend must be one of {DIR_BACKENDS}, got {hp.dir_backend!r}")
    if sym_reg_fn is not None and not getattr(sym_reg_fn, "wants_coefs", False):
        raise NotImplementedError(
            "only the fused-rollout penalty (wants_coefs) is ported (ROADMAP item 7)")
    n_params, groups, xi_of = _make_param_fns(cfg, Q)
    has_sym = sym_reg_fn is not None and hp.w_sym_reg > 0.0
    if hp.sindy_reg_type not in ("l1", "none"):
        raise ValueError(f"Unknown regularization type: {hp.sindy_reg_type}")

    def make_value_and_grad(carry):
        x, dx, theta_x = carry["x"], carry["dx"], carry["theta_x"]
        ctx = carry.get("srctx")

        def value_and_grad(theta, mask, idx):
            theta = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                XiM = xi_of(theta) * mask
                pred = theta_x[idx] @ XiM.mT
                loss = hp.w_sindy_x * ((pred - dx[idx]) ** 2).mean(dim=(1, 2))
                if has_sym:
                    sub = {k: v[idx] for k, v in ctx.items()}
                    loss = loss + hp.w_sym_reg * sym_reg_fn(XiM, x[idx], sub)
                if hp.sindy_reg_type == "l1":
                    loss = loss + hp.w_sindy_reg * sum(
                        theta[:, i:j].abs().sum(-1) for i, j in groups)
                (grad,) = torch.autograd.grad(loss.sum(), theta)
            return loss.detach(), grad

        return value_and_grad

    def init(x, dx, theta0):
        if theta0.shape[-1] != n_params:
            raise ValueError(f"theta0 has {theta0.shape[-1]} parameters, expected {n_params}")
        lanes = x.shape[0]
        mask0 = torch.ones((lanes, cfg.latent_dim, cfg.n_terms), device=x.device)
        carry = dict(x=x, dx=dx, theta_x=cfg.library(x),
                     **_init_loop_state(theta0.to(torch.float32), mask0, hp))
        if has_sym and sym_reg_prep is not None:
            with torch.no_grad():
                carry["srctx"] = sym_reg_prep(x)
        return carry

    def step(carry, epoch0):
        aux = {k: carry[k] for k in ("x", "dx", "theta_x", "srctx") if k in carry}
        state = {k: v for k, v in carry.items() if k not in aux}
        vg = make_value_and_grad(carry)
        for e in range(epoch0, epoch0 + epochs_per_call):
            if e >= hp.num_epochs:
                break  # past the budget: a no-op epoch
            state = _lbfgs_epoch_update(hp, xi_of, groups, vg, state, e,
                                        kernel_dir=hp.dir_backend == "pallas")
            if bool(state["done"].all()):
                break  # every later epoch of this call is a no-op
        return dict(**aux, **state)

    def extract(carry):
        return xi_of(carry["params"]), carry["mask"]

    return init, step, extract
