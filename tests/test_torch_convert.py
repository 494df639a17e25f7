"""convert.py: the JAX package's SINDy state, Q and theta0 into the port's
tensors. get_Xi must agree with the JAX one: the same Q @ beta product in
f32 (summed in another order), so 1e-6 absolute."""

import jax
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models.sindy import equation_strings as jax_equation_strings
from symmetry_ode_discovery_tpu.models.sindy import get_Xi as jax_get_Xi
from symmetry_ode_discovery_tpu.models.sindy import init_sindy
from symmetry_ode_discovery_tpu.models.sindy import make_config as jax_make_config
from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.models.sindy import (
    equation_strings, get_Xi, make_config)

SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]])
CASES = {
    "plain_lv_library": dict(include_exp=True),
    "so2_const": dict(L_list=[SO2]),
    "scaling2_no_const": dict(L_list=[SCALING2], constrain_constant=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_get_Xi_matches_jax(name):
    kw = CASES[name]
    jcfg, jQ = jax_make_config(2, poly_order=2, **kw)
    jstate = init_sindy(jax.random.PRNGKey(7), jcfg, jQ)
    jstate = jstate.replace(mask=jstate.mask.at[0, 1].set(0.0))
    cfg, _ = make_config(2, poly_order=2, **kw)
    state = convert.sindy_state(jstate, device="cpu")
    assert all(t.dtype == torch.float32 for t in
               (state.Xi, state.mask, state.beta, state.const, state.Q))
    np.testing.assert_allclose(get_Xi(cfg, state).numpy(),
                               np.asarray(jax_get_Xi(jcfg, jstate)), atol=1e-6)
    np.testing.assert_array_equal(state.mask.numpy(), np.asarray(jstate.mask))
    assert equation_strings(cfg, state) == jax_equation_strings(jcfg, jstate)


def test_q_and_theta0_layout():
    jcfg, jQ = jax_make_config(2, poly_order=2, L_list=[SO2])
    Q = convert.q_matrix(jQ, device="cpu")
    assert Q.dtype == torch.float32 and Q.is_contiguous()
    np.testing.assert_array_equal(Q.numpy(), jQ)
    th0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, jcfg.n_free + 2)),
                     dtype=np.float64)
    t = convert.theta0(th0, device="cpu")
    assert t.dtype == torch.float32 and tuple(t.shape) == th0.shape
    np.testing.assert_array_equal(t.numpy(), th0.astype(np.float32))
    with pytest.raises(ValueError):
        convert.theta0(th0[0], device="cpu")
