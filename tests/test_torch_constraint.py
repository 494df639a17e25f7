"""The port's equivariance constraint against the JAX package's.

Both are float64 numpy on the host. The SVD basis of the null space is not
unique, so the check compares projectors Q Q^T (to 1e-5, well above the f32
rounding of Q) and the model configuration that depends on Q's shape.
"""

import numpy as np
import pytest

from symmetry_ode_discovery_tpu.models.sindy import make_config as jax_make_config
from symmetry_ode_discovery_tpu.ops.constraint import get_M_list as jax_get_M_list
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.ops.constraint import get_M_list
from symmetry_ode_discovery_tpu_torch.ops.library import FunctionLibrary
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams
from symmetry_ode_discovery_tpu_torch.training.sweep import _kernel_setup

SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]])
CASES = {
    "so2": dict(L_list=[SO2]),
    "scaling2": dict(L_list=[SCALING2]),
    "scaling2_const": dict(L_list=[SCALING2], constrain_constant=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_projector_and_config_match_jax(name):
    kw = CASES[name]
    cfg, Q = make_config(2, poly_order=2, threshold=5e-2, **kw)
    jcfg, jQ = jax_make_config(2, poly_order=2, threshold=5e-2, **kw)
    assert Q.shape == jQ.shape
    np.testing.assert_allclose(Q @ Q.T, jQ @ jQ.T, atol=1e-5)
    for field in ("n_free", "use_kron_product", "allow_constant", "constraint"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.n_terms == jcfg.n_terms
    _, Mmap, n_params = _kernel_setup(cfg, Q, LBFGSHParams(), "cpu")
    d, p = cfg.latent_dim, cfg.n_terms
    assert tuple(Mmap.shape) == (d * p, n_params)
    assert n_params == cfg.n_free + (d if cfg.allow_constant else 0)


@pytest.mark.parametrize("L", [SO2, SCALING2], ids=["so2", "scaling2"])
def test_M_list_matches_jax(L):
    lib = FunctionLibrary(2, 3)
    for M, jM in zip(get_M_list(lib, [L]), jax_get_M_list(lib, [L])):
        np.testing.assert_array_equal(M, jM)


def test_equivariance_holds():
    """Every Xi in the span of Q satisfies L Xi = Xi M."""
    cfg, Q = make_config(2, poly_order=2, L_list=[SO2])
    M = get_M_list(cfg.library, [SO2])[0]
    beta = np.random.default_rng(0).normal(size=Q.shape[1])
    Xi = (Q @ beta).reshape(2, cfg.n_terms)
    np.testing.assert_allclose(SO2 @ Xi, Xi @ M, atol=1e-5)


def test_unconstrained_config():
    cfg, Q = make_config(2, poly_order=2, include_exp=True)
    jcfg, jQ = jax_make_config(2, poly_order=2, include_exp=True)
    assert Q is None and jQ is None
    assert cfg.n_terms == jcfg.n_terms == 8
