"""The port's optax-order L-BFGS update (ops/lbfgs_dir.py: the memory
update, gamma and the plain two-loop direction) against
optax.lbfgs(lr, linesearch=None, memory_size=m) on the same stream of
parameters and gradients, per lane, through memory fill and wrap-around; and the plain two-loop
against the JAX package's two-loop kernel (interpret mode).

Tolerance rtol 2e-5 / atol 1e-6 on every update, the bar
tests/test_lbfgs_dir.py holds the JAX package's kernel to against optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from symmetry_ode_discovery_tpu.ops.pallas_lbfgs_dir import two_loop_direction as jtwo_loop

from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir


@pytest.mark.parametrize("m,steps", [(7, 17), (100, 30)])
def test_update_matches_optax_on_random_stream(m, steps):
    lanes, n, lr = 3, 12, 0.37
    rng = np.random.default_rng(m)
    p0 = rng.standard_normal((lanes, n)).astype(np.float32)
    opt = optax.lbfgs(lr, linesearch=None, memory_size=m)
    step_j = jax.jit(opt.update)
    p_j = [jnp.asarray(p0[i]) for i in range(lanes)]
    s_j = [opt.init(p) for p in p_j]
    st = lbfgs_dir.init_state(torch.tensor(p0), m)
    for it in range(steps):
        noise = (0.05 * rng.standard_normal((lanes, n))).astype(np.float32)
        p_now = np.stack([np.asarray(p) for p in p_j])
        g = 0.9 * p_now + noise  # curvature-consistent
        # both sides see the same (params, grad) stream, so their memories
        # hold the same pairs and each update is compared on its own
        u_t, st = lbfgs_dir.update(st, torch.tensor(g), torch.tensor(p_now), lr, kernel=False)
        for i in range(lanes):
            u_j, s_j[i] = step_j(jnp.asarray(g[i]), s_j[i], p_j[i])
            np.testing.assert_allclose(u_t[i].numpy(), np.asarray(u_j), rtol=2e-5, atol=1e-6,
                                       err_msg=f"iteration {it}, lane {i}")
            p_j[i] = optax.apply_updates(p_j[i], u_j)
    assert st["count"].tolist() == [steps] * lanes


def _two_loop_case(case, B, m, n, seed=9):
    """(g, s, y, rho, gamma) as float32 numpy. "legacy": random pairs and
    weights, the first 3 weights 0. Otherwise a curvature-consistent memory
    (y = 0.8 s + noise, rho = 1/(y.s)) with the first third of the slots
    empty (s = y = rho = 0, optax's fresh memory), and each case's edge."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, n)).astype(np.float32)
    s = rng.standard_normal((B, m, n)).astype(np.float32)
    y = rng.standard_normal((B, m, n)).astype(np.float32)
    rho = rng.uniform(0, 2, (B, m)).astype(np.float32)
    gam = rng.uniform(0.5, 1.5, B).astype(np.float32)
    if case == "legacy":
        rho[:, :3] = 0.0
        return g, s, y, rho, gam
    y = (0.8 * s + 0.1 * y).astype(np.float32)
    rho = (1.0 / np.einsum("lkn,lkn->lk", s, y)).astype(np.float32)
    empty = m // 3
    s[:, :empty] = y[:, :empty] = rho[:, :empty] = 0.0
    if case == "all_empty":
        s[:] = y[:] = rho[:] = 0.0
    elif case == "rho0_nonzero_sy":  # weight 0 on pairs with s, y != 0
        rho[:, ::3] = 0.0
        s[:, :empty] = rng.standard_normal((B, empty, n))
        y[:, :empty] = rng.standard_normal((B, empty, n))
    elif case == "neg_zero_g":  # -0 and +0 components, gamma < 0 (r = q gamma turns +0 to -0)
        g[:, ::2] = -0.0
        g[:, 1::4] = 0.0
        gam = -gam
    return g, s, y, rho, gam


TWO_LOOP_CASES = {
    # case: (edge, lanes, m, n)
    "legacy": ("legacy", 4, 11, 17),
    "leading_empty": ("leading_empty", 4, 11, 17),
    "all_empty": ("all_empty", 3, 7, 16),
    "rho0_nonzero_sy": ("rho0_nonzero_sy", 4, 11, 17),
    "neg_zero_g": ("neg_zero_g", 4, 11, 16),
    "m1": ("leading_empty", 3, 1, 17),
    "n1": ("leading_empty", 3, 7, 1),
}


@pytest.mark.parametrize("case", sorted(TWO_LOOP_CASES))
def test_two_loop_plain_matches_jax_kernel(case):
    """The plain two-loop against the JAX kernel in interpret mode, within
    rtol 1e-5 / atol 1e-6 (the two sum each dot product in another order),
    with the same NaN positions; on the all-empty memory both are g gamma
    exactly."""
    edge, B, m, n = TWO_LOOP_CASES[case]
    args = _two_loop_case(edge, B, m, n)
    want = np.asarray(jax.vmap(lambda *a: jtwo_loop(*a, interpret=True))(
        *(jnp.asarray(a) for a in args)))
    t = [torch.tensor(a) for a in args]
    got = lbfgs_dir.two_loop_direction_plain(*t).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if edge == "all_empty":
        np.testing.assert_array_equal(got, args[0] * args[4][:, None])
    # on CPU tensors the wrapper runs the plain version and counts no launch
    before = lbfgs_dir.launches
    np.testing.assert_array_equal(lbfgs_dir.two_loop_direction(*t).numpy(), got)
    assert lbfgs_dir.launches == before


def _bad_two_loop_args(fault):
    g, s, y = torch.zeros((2, 5)), torch.zeros((2, 3, 5)), torch.zeros((2, 3, 5))
    rho, gamma = torch.zeros((2, 3)), torch.ones(2)
    if fault == "y_shape":
        y = torch.zeros((2, 3, 4))
    elif fault == "rho_shape":
        rho = torch.zeros((2, 2))
    elif fault == "gamma_shape":
        gamma = torch.ones(3)
    elif fault == "dtype":
        s = s.double()
    elif fault == "contiguity":
        s = torch.zeros((3, 2, 5)).transpose(0, 1)
    elif fault == "device":
        gamma = torch.ones(2, device="meta")
    return g, s, y, rho, gamma


@pytest.mark.parametrize("fault,match", [
    ("y_shape", "shape"), ("rho_shape", "shape"), ("gamma_shape", "shape"),
    ("dtype", "float32"), ("contiguity", "contiguous"), ("device", "float32 on cpu")])
def test_two_loop_checks_shapes(fault, match):
    """The wrapper's one-pass check still names each fault it must refuse."""
    before = lbfgs_dir.launches
    with pytest.raises(ValueError, match=match):
        lbfgs_dir.two_loop_direction(*_bad_two_loop_args(fault))
    assert lbfgs_dir.launches == before
