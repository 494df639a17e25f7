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


def test_two_loop_plain_matches_jax_kernel():
    rng = np.random.default_rng(9)
    B, m, n = 4, 11, 17
    g = rng.standard_normal((B, n)).astype(np.float32)
    s = rng.standard_normal((B, m, n)).astype(np.float32)
    y = rng.standard_normal((B, m, n)).astype(np.float32)
    rho = rng.uniform(0, 2, (B, m)).astype(np.float32)
    rho[:, :3] = 0.0
    gam = rng.uniform(0.5, 1.5, B).astype(np.float32)
    want = jax.vmap(lambda *a: jtwo_loop(*a, interpret=True))(
        *(jnp.asarray(a) for a in (g, s, y, rho, gam)))
    t = [torch.tensor(a) for a in (g, s, y, rho, gam)]
    np.testing.assert_allclose(lbfgs_dir.two_loop_direction_plain(*t).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    # on CPU tensors the wrapper runs the plain version and counts no launch
    before = lbfgs_dir.launches
    np.testing.assert_array_equal(lbfgs_dir.two_loop_direction(*t).numpy(),
                                  lbfgs_dir.two_loop_direction_plain(*t).numpy())
    assert lbfgs_dir.launches == before


def test_two_loop_checks_shapes():
    g = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="shape"):
        lbfgs_dir.two_loop_direction(g, torch.zeros((2, 3, 5)), torch.zeros((2, 3, 4)),
                                     torch.zeros((2, 3)), torch.ones(2))
