"""ODE integrators: the RK4 data-generation solver, the Euler/RK4
rollout of the symmetry losses, and the fused Euler rollout-and-tangent pair
with a memory-light backward.

The JAX package writes the step loops as ``lax.scan``s; here they are Python
loops over steps on the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _rk4_step(f: Callable, x: torch.Tensor, dt: float) -> torch.Tensor:
    k1 = f(x)
    k2 = f(x + dt / 2 * k1)
    k3 = f(x + dt / 2 * k2)
    k4 = f(x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def solve_ode_batch(
    ode: Callable,
    x0: torch.Tensor,
    dt: float = 0.002,
    num_steps: int = 2000,
):
    """RK4 over a batch of initial conditions, recording x and the exact dx
    at every sample: dx[i] = ode(x[i]), and the last step does not advance x.
    Returns (x, dx), each (num_steps, *x0.shape), on x0's device and dtype."""
    xs = torch.empty((num_steps,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    dxs = torch.empty_like(xs)
    x = x0
    for i in range(num_steps):
        dx = ode(x)
        xs[i] = x
        dxs[i] = dx
        k1 = dt * dx
        k2 = dt * ode(x + 0.5 * k1)
        k3 = dt * ode(x + 0.5 * k2)
        k4 = dt * ode(x + k3)
        x = x + (k1 + 2 * k2 + 2 * k3 + k4) / 6
    return xs, dxs


def _euler_step(f: Callable, x: torch.Tensor, dt: float) -> torch.Tensor:
    return x + dt * f(x)


def odeint(f: Callable, x0: torch.Tensor, t: float, dt: float, method: str = "euler",
           full_traj: bool = False, num_steps: Optional[int] = None) -> torch.Tensor:
    """Integrate dx/dt = f(x) from x0 for int(t / dt) steps (or
    ``num_steps``), Euler or RK4: the final state, or with ``full_traj`` the
    states after each step stacked, (n_steps, *x0.shape) (x0 not included).
    Differentiable by autograd.

    Callers that know the step count pass ``num_steps``: int(t / dt) of
    t = n * dt truncates for many (n, dt) pairs (int((43 * 0.2) / 0.2) is
    42)."""
    if method not in ("euler", "rk4"):
        raise ValueError("Unrecognized ODEInt method.")
    n_steps = int(t / dt) if num_steps is None else num_steps
    step = _euler_step if method == "euler" else _rk4_step
    x = x0
    traj = []
    for _ in range(n_steps):
        x = step(f, x, dt)
        if full_traj:
            traj.append(x)
    if not full_traj:
        return x
    return torch.stack(traj) if traj else x0.new_empty((0,) + tuple(x0.shape))


def make_euler_pair(field_jvp: Callable, n_steps: int, dt: float):
    """Fused Euler rollout and directional derivative with a memory-light
    backward.

    ``make_euler_pair(field_jvp, n, dt)(x0, v0, A)`` returns (fx, iv): fx
    the Euler endpoint of dx/dt = f(x; A) from x0 after n steps, and iv its
    derivative along v0 (the tangent carried beside the state,
    tq <- tq + dt J_f(q) tq). ``field_jvp(A)`` returns the function
    (q, tq) -> (f(q; A), J_f(q; A) tq), e.g. from ``FunctionLibrary.jvp``
    or ``torch.func.jvp``. The backward keeps only the per-step inputs (q, tq) and
    re-linearises each step on the reverse sweep with ``torch.func.vjp`` of
    one step, instead of keeping the autograd graph of the whole rollout and
    its tangent. Gradients flow to x0, v0 and A. Both directions run under a
    profiler label (euler_pair, euler_pair.backward).
    """

    def pair_step(q, tq, A):
        fq, jq = field_jvp(A)(q, tq)
        return q + dt * fq, tq + dt * jq

    class EulerPair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x0, v0, A):
            qs, tqs = [], []
            q, tq = x0, v0
            with torch.profiler.record_function("euler_pair"):
                for _ in range(n_steps):
                    qs.append(q)
                    tqs.append(tq)
                    q, tq = pair_step(q, tq, A)
            ctx.save_for_backward(A, *qs, *tqs)
            return q, tq

        @staticmethod
        def backward(ctx, cq, ctq):
            A, *saved = ctx.saved_tensors
            qs, tqs = saved[:n_steps], saved[n_steps:]
            cA = torch.zeros_like(A)
            with torch.profiler.record_function("euler_pair.backward"):
                for q, tq in zip(reversed(qs), reversed(tqs)):
                    _, vjp_fn = torch.func.vjp(pair_step, q, tq, A)
                    cq, ctq, dA = vjp_fn((cq, ctq))
                    cA = cA + dA
            return cq, ctq, cA

    return EulerPair.apply
