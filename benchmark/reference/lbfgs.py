"""The discovery protocol's optimizer in plain PyTorch: fixed-learning-rate
L-BFGS in optax's order (100 curvature pairs kept oldest first, a pair
zeroed on the first update after a reset, gamma from the newest pair,
min(1, 1/|g|_2) on the first update, the two-loop recursion, updates = -lr
direction), with torch.optim.LBFGS's first step -lr min(1, 1/|g|_1) g and
its inner breaks (gradient below 1e-7, a step or a change of the loss below
1e-9, a direction that does not descend), over a leading lane axis."""

from __future__ import annotations

import torch

TOL_CHANGE, TOL_GRAD = 1e-9, 1e-7
INNER_ITERS, MEMORY = 20, 100  # torch.optim.LBFGS's max_iter and history_size


def fresh_state(params, memory: int) -> dict:
    lanes, n = params.shape
    z = torch.zeros_like(params)
    return dict(count=torch.zeros(lanes, dtype=torch.int32, device=params.device),
                params=z, updates=z.clone(), s=params.new_zeros((lanes, memory, n)),
                y=params.new_zeros((lanes, memory, n)), w=params.new_zeros((lanes, memory)))


def two_loop(g, s, y, rho, gamma):
    """H g per lane over all m slots, oldest first."""
    m = s.shape[1]
    q, alphas = g, [None] * m
    for k in range(m - 1, -1, -1):
        a = rho[:, k:k + 1] * (s[:, k] * q).sum(-1, keepdim=True)
        q = q - a * y[:, k]
        alphas[k] = a
    r = q * gamma[:, None]
    for k in range(m):
        b = rho[:, k:k + 1] * (y[:, k] * r).sum(-1, keepdim=True)
        r = r + s[:, k] * (alphas[k] - b)
    return r


def direction(state: dict, grad, params, lr: float):
    """(updates, new state) of one update per lane."""
    first = (state["count"] == 0)[:, None]
    dp = params - state["params"]
    du = grad - state["updates"]
    vdot = (du * dp).sum(-1)
    weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
    dp = torch.where(first, 0.0, dp)
    du = torch.where(first, 0.0, du)
    weight = torch.where(first[:, 0], 0.0, weight)
    s = torch.cat([state["s"][:, 1:], dp[:, None]], dim=1)
    y = torch.cat([state["y"][:, 1:], du[:, None]], dim=1)
    w = torch.cat([state["w"][:, 1:], weight[:, None]], dim=1)
    num, den = (du * dp).sum(-1), (du * du).sum(-1)
    gamma = torch.where(den > 0.0, num / den, 1.0)
    gnorm = torch.sqrt((grad * grad).sum(-1))
    gamma = torch.where(first[:, 0], torch.minimum(torch.ones_like(gnorm), 1.0 / gnorm), gamma)
    d = two_loop(grad, s, y, w, gamma)
    return -lr * d, dict(count=state["count"] + 1, params=params, updates=grad, s=s, y=y, w=w)


def _select(cond, new, old):
    if isinstance(new, dict):
        return {k: _select(cond, new[k], old[k]) for k in new}
    return torch.where(cond.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def first_epoch(value_and_grad, params, lr: float, inner_iters: int = INNER_ITERS,
                memory: int = MEMORY):
    """The first epoch from ``params`` (L, n) with fresh optimizer state and
    no lane done: ``value_and_grad(params_sub, lanes)`` returns (loss,
    penalty, grad) of the lanes ``lanes`` (a LongTensor). Returns the
    parameters after the epoch and, per evaluation, the lanes evaluated,
    their parameters and their penalties."""
    lanes = params.shape[0]
    dev = params.device
    state = fresh_state(params, memory)
    prev_val = torch.full((lanes,), float("inf"), dtype=params.dtype, device=dev)
    prev_step = torch.full((lanes,), float("inf"), dtype=params.dtype, device=dev)
    frozen = torch.zeros(lanes, dtype=torch.bool, device=dev)
    evals = []
    for i in range(inner_iters):
        idx = torch.nonzero(~frozen).flatten()
        if idx.numel() == 0:
            break
        value = torch.zeros(lanes, dtype=params.dtype, device=dev)
        grad = torch.zeros_like(params)
        v_a, pen_a, g_a = value_and_grad(params[idx], idx)
        evals.append({"lanes": idx, "params": params[idx], "pen": pen_a})
        value[idx] = v_a
        grad[idx] = g_a
        frozen = frozen | (grad.abs().amax(-1) <= TOL_GRAD)
        if i > 0:
            frozen = frozen | (prev_step <= TOL_CHANGE) | ((value - prev_val).abs() < TOL_CHANGE)
        stalled = frozen.clone()
        first = state["count"] == 0
        g1 = grad.abs().sum(-1)
        t1 = torch.minimum(torch.ones_like(g1), 1.0 / g1)
        updates, new_state = direction(state, grad, params, lr)
        gtd = torch.where(first, -(grad * grad).sum(-1), (grad * updates).sum(-1) / lr)
        frozen = frozen | (gtd > -TOL_CHANGE)
        updates = torch.where(first[:, None], -lr * t1[:, None] * grad, updates)
        step_max = updates.abs().amax(-1)
        params = _select(frozen, params, params + updates)
        state = _select(stalled, state, new_state)
        prev_val = torch.where(stalled, prev_val, value)
        prev_step = torch.where(frozen, prev_step, step_max)
    return params, evals
