"""The zoom line search of ``optax.lbfgs(lr)`` (optax 0.2.6,
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``), batched over lanes.

The port's copy of optax's ``zoom_linesearch`` for the one configuration
that the JAX package's ``_make_opt(LBFGSHParams(linesearch=True))`` runs:
slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, increase factor 2,
stepsize precision (interval threshold) 1e-5, tolerance 0, no largest step,
a first guess of 1 and at most 20 trial steps. It keeps the approximate
(Hager-Zhang) decrease test, the safe step when the search fails, and the
non-finite handling (a NaN decrease or curvature error counts as infinite).

Phase 1 (Nocedal and Wright, Algorithm 3.5) doubles the step until an
interval holding an acceptable one is found; phase 2 (Algorithm 3.6) zooms
into it by a cubic, then a quadratic, then a bisection step. Each lane
follows its own search, as ``jax.vmap`` of optax's ``while_loop`` does:
the loop runs while any lane is still searching, a lane is evaluated only
while it searches, and a lane that has finished keeps its state. The loop
reads the "any lane searching" flag on the host once per trial step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5
MAX_LINESEARCH_STEPS = 20
TOL = 0.0


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * dc * dc) * r0 + db * db * db * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _nan_to_inf(e):
    return torch.where(torch.isnan(e), math.inf, e)


def _decrease_error(t, v, s, v0, s0):
    """Sufficient decrease (Armijo), or the approximate one where the value
    lies within APPROX_DEC_RTOL of the start's: 0 when met."""
    dec = v - v0 - SLOPE_RTOL * t * s0
    approx = s - (2 * SLOPE_RTOL - 1.0) * s0
    delta_values = v - v0 - APPROX_DEC_RTOL * v0.abs()
    approx = torch.maximum(approx, delta_values)
    dec = torch.maximum(torch.minimum(approx, dec), torch.zeros_like(dec))
    return _nan_to_inf(dec)


def _curvature_error(s, s0):
    """Small curvature (strong Wolfe): 0 when met."""
    curv = s.abs() - CURV_RTOL * s0.abs()
    return _nan_to_inf(torch.maximum(curv, torch.zeros_like(curv)))


# a lane's scalar state, one column each of a (lanes, len(FIELDS)) tensor
# in the parameters' dtype (flags as 0 and 1, the trial count exact): the
# fields every trial sets alike, then those its phase decides
COMMON = ("count", "stepsize", "value", "slope", "decrease_error", "curvature_error",
          "error", "done")
BRANCH = ("interval_found", "failed", "low", "value_low", "slope_low", "high", "value_high",
          "slope_high", "cubic_ref", "value_cubic_ref", "safe_stepsize", "safe_value")
FIELDS = COMMON + BRANCH
_COL = {name: i for i, name in enumerate(FIELDS)}


def zoom_linesearch(value_and_grad: Callable, params: torch.Tensor, updates: torch.Tensor,
                    value: torch.Tensor, grad: torch.Tensor, stats: Optional[dict] = None):
    """The step along ``updates`` (lanes, n) from ``params`` (lanes, n) of
    each lane, given the value (lanes,) and gradient (lanes, n) at params.

    ``value_and_grad(theta, sel)`` evaluates the lanes ``sel`` (a long
    tensor of lane positions) at theta (len(sel), n) and returns their
    values and gradients. Returns (stepsize (lanes,), value and gradient at
    params + stepsize * updates). ``stats``, when given, counts
    the lanes' zoom trials by kind ("cubic", "quadratic", "bisection"), the
    failed searches ("failed") and those of them that took the safe step
    ("safe"), each read on the host."""
    lanes = value.shape[0]

    def _stack(*cols):  # per-lane columns, flags as 0 and 1
        return torch.stack([c.to(value.dtype) for c in cols], 1)

    zeros = torch.zeros_like(value)
    inf = torch.full_like(value, math.inf)
    slope = (updates * grad).sum(-1)
    v0, s0 = value, slope
    # optax's init: no step yet, every error infinite, the interval [0, 0]
    st = _stack(*(dict(count=zeros, stepsize=zeros, value=value, slope=slope,
                       decrease_error=inf, curvature_error=inf, error=inf, done=zeros,
                       interval_found=zeros, failed=zeros, low=zeros, value_low=value,
                       slope_low=slope, high=zeros, value_high=value, slope_high=slope,
                       cubic_ref=zeros, value_cubic_ref=value, safe_stepsize=zeros,
                       safe_value=value)[k] for k in FIELDS))
    grad_st, safe_grad = grad, grad
    while True:
        f = dict(zip(FIELDS, st.unbind(1)))
        run = (f["done"] + f["failed"]) == 0
        if not bool(run.any()):
            break
        count, stepsize, low, high = f["count"], f["stepsize"], f["low"], f["high"]
        vlow, slow, vhigh, shigh = f["value_low"], f["slope_low"], f["value_high"], f["slope_high"]
        found = f["interval_found"] > 0
        # phase 1's trial: the guess 1 first, then twice the previous step
        t_search = torch.where(count == 0, 1.0, INCREASE_FACTOR * stepsize)
        # phase 2's trial: cubic, else quadratic, else bisection
        delta = (high - low).abs()
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = delta <= STEPSIZE_PRECISION
        m_cubic = _cubicmin(low, vlow, slow, high, vhigh, f["cubic_ref"], f["value_cubic_ref"])
        use_cubic = (m_cubic > left + cubic_chk) & (m_cubic < right - cubic_chk)
        m_quad = _quadmin(low, vlow, slow, high, vhigh)
        use_quad = ~use_cubic & (m_quad > left + quad_chk) & (m_quad < right - quad_chk)
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, m_cubic, f["cubic_ref"])
        middle = torch.where(use_quad, m_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)
        t = torch.where(found, middle, t_search)

        sel = torch.nonzero(run).flatten()
        v_sel, g_sel = value_and_grad(params[sel] + t[sel, None] * updates[sel], sel)
        if sel.numel() == lanes:
            v, g = v_sel.to(value.dtype), g_sel.to(grad.dtype)
        else:
            v, g = f["value"].clone(), grad_st.clone()
            v[sel] = v_sel.to(v.dtype)
            g[sel] = g_sel.to(g.dtype)
        s = (g * updates).sum(-1)
        dec = _decrease_error(t, v, s, v0, s0)
        curv = _curvature_error(s, s0)
        err = torch.maximum(dec, curv)
        done = err <= TOL
        safe_decrease = dec <= TOL
        max_steps = count + 1 >= MAX_LINESEARCH_STEPS

        # phase 1 (optax's _search_interval)
        set_high_to_new = (dec > 0.0) | ((v >= f["value"]) & (count > 0))
        set_low_to_new = (s >= 0.0) & ~set_high_to_new
        lohi = torch.where(set_low_to_new[:, None],
                           _stack(t, v, s, stepsize, f["value"], f["slope"]),
                           _stack(stepsize, f["value"], f["slope"], t, v, s))
        safe_s = torch.where(safe_decrease[:, None], _stack(t, v),
                             _stack(f["safe_stepsize"], f["safe_value"]))
        search = torch.cat([_stack(set_high_to_new | set_low_to_new | done, max_steps & ~done),
                            lohi, lohi[:, :2], safe_s], 1)

        # phase 2 (optax's _zoom_into_interval)
        update_safe = safe_decrease & (v < f["safe_value"])
        safe_z = torch.where(update_safe[:, None], _stack(t, v),
                             _stack(f["safe_stepsize"], f["safe_value"]))
        set_high_to_middle = (dec > 0.0) | (v >= vlow)
        set_high_to_low = (s * (high - low) >= 0.0) & ~set_high_to_middle
        old_lo, old_hi = _stack(low, vlow, slow), _stack(high, vhigh, shigh)
        new_mid = _stack(t, v, s)
        hi = torch.where(set_high_to_middle[:, None], new_mid, old_hi)
        hi = torch.where(set_high_to_low[:, None], old_lo, hi)
        lo = torch.where(set_high_to_middle[:, None], old_lo, new_mid)
        ref = torch.where((set_high_to_middle | set_high_to_low)[:, None], old_hi[:, :2],
                          old_lo[:, :2])
        failed_z = (max_steps | (too_small_int & (safe_z[:, 0] > 0.0))) & ~done
        zoom = torch.cat([_stack(found, failed_z), lo, hi, ref, safe_z], 1)

        new = torch.cat([_stack(count + 1, t, v, s, dec, curv, err, done),
                         torch.where(found[:, None], zoom, search)], 1)
        safe_grad_new = torch.where(torch.where(found, update_safe, safe_decrease)[:, None],
                                    g, safe_grad)
        # a failed search takes the safe step: the best point of sufficient
        # decrease, or no step at all when even the trials left the domain
        nf = dict(zip(FIELDS, new.unbind(1)))
        use_safe = (nf["failed"] > 0) & ((nf["safe_stepsize"] > 0.0) | torch.isinf(dec))
        cols = [_COL["stepsize"], _COL["value"]]
        new[:, cols] = torch.where(use_safe[:, None],
                                   new[:, [_COL["safe_stepsize"], _COL["safe_value"]]],
                                   new[:, cols])
        g = torch.where(use_safe[:, None], safe_grad_new, g)
        if stats is not None:
            zoom_run = run & found
            for key, hit in (("cubic", use_cubic & zoom_run), ("quadratic", use_quad & zoom_run),
                             ("bisection", use_bisection & zoom_run),
                             ("failed", (nf["failed"] > 0) & run), ("safe", use_safe & run)):
                stats[key] = stats.get(key, 0) + int(hit.sum())
        st = torch.where(run[:, None], new, st)
        grad_st = torch.where(run[:, None], g, grad_st)
        safe_grad = torch.where(run[:, None], safe_grad_new, safe_grad)
    return st[:, _COL["stepsize"]], st[:, _COL["value"]], grad_st
