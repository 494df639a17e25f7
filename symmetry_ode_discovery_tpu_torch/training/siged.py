"""Hyper-parameters of the L-BFGS discovery protocol, the host-stepped
L-BFGS loop (the EquivSINDy-r fits, the latent-space fit and its
distillation to data space), and the composed symmetry-penalty hook.

The port's counterpart of symmetry_ode_discovery_tpu/training/siged.py. The
JAX package runs the latent fit and the distillation as one fused
``lax.scan`` (``train_sindy_lbfgs``); here they run on the same
host-stepped epochs as the symmetry-regularized fits, with the JAX
package's losses: the normal-equation reduction for a data-space fit on a
fixed batch without a penalty, and w_z mean((dz_pred - dz)^2) + w_x
mean((J_dec(z) dz_pred - dx)^2) in the latent space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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


@dataclasses.dataclass(frozen=True)
class LatentCtx:
    """The latent-space fit's frozen autoencoder pushforward:
    ``decode_jvp(z, dz_pred)`` returns J_dec(z) dz_pred (e.g.
    ``AutoEncoder.compute_dx``), the data-space derivative prediction."""

    decode_jvp: Callable
    w_sindy_z: float = 0.0


@dataclasses.dataclass
class LBFGSResult:
    Xi: torch.Tensor          # (lanes, d, p)
    mask: torch.Tensor        # (lanes, d, p)
    stop_epoch: torch.Tensor  # (lanes,)


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
    prev_val = torch.full((lanes,), float("inf"), dtype=params.dtype, device=dev)
    prev_step = torch.full((lanes,), float("inf"), dtype=params.dtype, device=dev)
    frozen = done.clone()
    for i in range(hp.inner_iters):
        idx = torch.nonzero(~frozen).flatten()
        if idx.numel() == 0:
            break
        value = torch.zeros(lanes, dtype=params.dtype, device=dev)
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
                       epochs_per_call: int = 1, latent: Optional[LatentCtx] = None,
                       normal_eq: bool = False):
    """Host-stepped L-BFGS discovery on a leading lane dimension:

        init, step, extract = make_lbfgs_stepper(cfg, Q, hp, pen, prep)
        carry = init(x, dx, theta0)          # x, dx (lanes, k, dim)
        for e in range(0, hp.num_epochs, epochs_per_call):
            carry = step(carry, e)
            if bool(carry["done"].all()): break
        Xi, mask = extract(carry)

    The protocol of the JAX package's make_lbfgs_stepper: loss per lane
    w_x mean((Theta(x) (Xi m)^T - dx)^2) [+ w_sym pen] [+ w_reg |theta|_1];
    optax-order fixed-lr L-BFGS with 100 pairs; torch's inner breaks;
    thresholding with an optimizer reset; the NaN stop; epochs past the
    budget are no-ops. The penalty, by what ``sym_reg_fn`` is:
    - ``wants_coefs`` (the fused-rollout penalty of
      ``training.symmreg.make_symmreg_i_fast``): ``sym_reg_fn(XiM (lanes, d,
      p), x, ctx)``;
    - with ``sym_reg_prep`` (its closure form): ``sym_reg_fn(forward_fn, x,
      ctx)``, forward_fn the lanes' candidate fields;
    - otherwise a composed penalty of one lane (``make_sym_reg_fn``):
      ``sym_reg_fn(forward_fn, x_lane)``, called lane by lane.
    ``sym_reg_prep(x) -> ctx`` runs once in init. ``normal_eq``: the loss
    through S = Theta^T Theta, b = Theta^T dx and q = sum dx^2, computed once
    (the JAX package's train_sindy_lbfgs on a fixed batch without a
    penalty). ``latent``: x is the encoded z, init takes dx = dz and
    ``dx_data``, and the loss is w_z mean((pred - dz)^2) + w_x
    mean((decode_jvp(z, pred) - dx_data)^2) [+ w_reg |theta|_1].
    ``hp.dir_backend``: 'pallas' runs the two-loop kernel (K4) on CUDA
    tensors, 'xla' its plain version.
    """
    if hp.dir_backend not in DIR_BACKENDS:
        raise ValueError(f"dir_backend must be one of {DIR_BACKENDS}, got {hp.dir_backend!r}")
    n_params, groups, xi_of = _make_param_fns(cfg, Q)
    has_sym = sym_reg_fn is not None and hp.w_sym_reg > 0.0
    if has_sym and (latent is not None or normal_eq):
        raise ValueError("the symmetry penalty applies to the data-space fit only")
    wants_coefs = bool(getattr(sym_reg_fn, "wants_coefs", False))
    if hp.sindy_reg_type not in ("l1", "none"):
        raise ValueError(f"Unknown regularization type: {hp.sindy_reg_type}")
    lib = cfg.library

    def mse(a, b):
        return ((a - b) ** 2).mean(dim=(1, 2))

    def penalty(XiM, x, ctx):
        if wants_coefs:
            return sym_reg_fn(XiM, x, ctx)
        if sym_reg_prep is not None:
            return sym_reg_fn(lambda q: lib(q) @ XiM.mT, x, ctx)
        return torch.stack([sym_reg_fn(lambda q, A=XiM[l]: lib(q) @ A.T, x[l])
                            for l in range(XiM.shape[0])])

    def make_value_and_grad(carry):
        x, dx, theta_x = carry["x"], carry["dx"], carry.get("theta_x")
        ctx = carry.get("srctx")

        def value_and_grad(theta, mask, idx):
            theta = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                XiM = xi_of(theta) * mask
                if normal_eq:
                    S, B, q, ne = (carry[k][idx] for k in ("S", "B", "q", "n_elems"))
                    loss = hp.w_sindy_x * (torch.einsum("lip,lpq,liq->l", XiM, S, XiM)
                                           - 2.0 * (XiM * B).sum(dim=(1, 2)) + q) / ne
                else:
                    pred = theta_x[idx] @ XiM.mT
                    if latent is not None:
                        dx_pred = latent.decode_jvp(x[idx], pred)
                        loss = (latent.w_sindy_z * mse(pred, dx[idx])
                                + hp.w_sindy_x * mse(dx_pred, carry["dx_data"][idx]))
                    else:
                        loss = hp.w_sindy_x * mse(pred, dx[idx])
                    if has_sym:
                        sub = None if ctx is None else {k: v[idx] for k, v in ctx.items()}
                        loss = loss + hp.w_sym_reg * penalty(XiM, x[idx], sub)
                if hp.sindy_reg_type == "l1":
                    loss = loss + hp.w_sindy_reg * sum(
                        theta[:, i:j].abs().sum(-1) for i, j in groups)
                (grad,) = torch.autograd.grad(loss.sum(), theta)
            return loss.detach(), grad

        return value_and_grad

    def init(x, dx, theta0, dx_data=None):
        if theta0.shape[-1] != n_params:
            raise ValueError(f"theta0 has {theta0.shape[-1]} parameters, expected {n_params}")
        if (latent is not None) != (dx_data is not None):
            raise ValueError("dx_data is the latent fit's data-space target, and only its")
        lanes = x.shape[0]
        mask0 = torch.ones((lanes, cfg.latent_dim, cfg.n_terms), dtype=x.dtype, device=x.device)
        carry = dict(x=x, dx=dx, **_init_loop_state(theta0.to(x.dtype), mask0, hp))
        th = lib(x)
        if normal_eq:
            carry.update(S=th.mT @ th, B=(th.mT @ dx).mT.contiguous(),
                         q=(dx ** 2).sum(dim=(1, 2)),
                         n_elems=torch.full((lanes,), float(dx.shape[1] * dx.shape[2]),
                                            device=x.device))
        else:
            carry["theta_x"] = th
        if dx_data is not None:
            carry["dx_data"] = dx_data
        if has_sym and sym_reg_prep is not None:
            with torch.no_grad():
                carry["srctx"] = sym_reg_prep(x)
        return carry

    aux_keys = ("x", "dx", "theta_x", "srctx", "dx_data", "S", "B", "q", "n_elems")

    def step(carry, epoch0):
        aux = {k: carry[k] for k in aux_keys if k in carry}
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


def train_sindy_lbfgs(cfg, Q, x, dx, hp: LBFGSHParams, theta0, sym_reg_fn=None,
                      latent: Optional[LatentCtx] = None, dx_data=None,
                      epochs_per_call: int = 10) -> LBFGSResult:
    """Fit the regressor to each lane's fixed batch by L-BFGS: x, dx (lanes,
    k, dim), theta0 (lanes, n_params). Data space without a penalty runs on
    the normal-equation reduction; ``latent`` takes x = z, dx = dz and
    ``dx_data``; ``sym_reg_fn`` as for make_lbfgs_stepper (one-lane composed
    or fused). The epochs run host-stepped until every lane is done."""
    normal_eq = latent is None and (sym_reg_fn is None or hp.w_sym_reg == 0.0)
    init, step, extract = make_lbfgs_stepper(
        cfg, Q, hp, sym_reg_fn if latent is None and not normal_eq else None,
        epochs_per_call=epochs_per_call,
        latent=latent, normal_eq=normal_eq)
    carry = init(x, dx, theta0, dx_data)
    for e in range(0, hp.num_epochs, epochs_per_call):
        carry = step(carry, e)
        if bool(carry["done"].all()):
            break
    Xi, mask = extract(carry)
    return LBFGSResult(Xi=Xi.detach(), mask=mask, stop_epoch=carry["stop_epoch"])


def distill_to_data_space(cfg_dst, x, dx_synth, hp: LBFGSHParams, theta0) -> LBFGSResult:
    """Re-fit an unconstrained data-space regressor to derivatives
    synthesised from the frozen latent equation, dx_synth = J_dec(z)
    regressor(z) (the second phase of the latent fit)."""
    return train_sindy_lbfgs(cfg_dst, None, x, dx_synth, hp, theta0)


def make_sym_reg_fn(ae, spec, g_state, sym_reg_type: str, int_t: float, int_dt: float):
    """The composed symmetry-regularization hook of one lane,
    ``fn(forward_fn, x) -> scalar``: types 'i' and 'f' roll the candidate
    ODE out with Euler ``odeint`` over int_t and penalise the
    (in)finitesimal asymmetry of the flow map; 'r' penalises the reversed
    symmetry defect of the vector field."""
    from ..ops.integrators import odeint
    from . import symmreg as sr

    def fn(forward_fn, x):
        if sym_reg_type in ("i", "f"):
            def forward_step(q):
                return odeint(forward_fn, q, int_t, int_dt)

            x_fx = torch.stack([x, forward_step(x)], dim=1)
            if sym_reg_type == "i":
                return sr.symmreg_i(ae, spec, g_state, x_fx, f=forward_step)
            return sr.symmreg_f(ae, spec, g_state, x_fx, f=forward_step)
        if sym_reg_type == "r":
            return sr.symmreg_r(ae, spec, g_state, x, h=forward_fn)
        raise ValueError(f"Unknown sym_reg_type: {sym_reg_type}")

    return fn
