"""The port's SINDy library against the JAX package's, on the same numpy input.

Tolerance: polynomial terms are the same three-factor products in the same
order, so they agree to rounding; sin/exp come from different math libraries
(XLA vs ATen), which agree to a few f32 ulps. 1e-6 relative covers both.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.ops.library import FunctionLibrary as JaxLibrary
from symmetry_ode_discovery_tpu.ops.library import poly_exponent_table as jax_exponents
from symmetry_ode_discovery_tpu_torch.ops.library import (
    FunctionLibrary, poly_exponent_table, poly_index_table)

CASES = list(itertools.product([1, 2, 3], [False, True], [False, True]))


@pytest.mark.parametrize("poly_order,sine,exp", CASES)
def test_theta_matches_jax(poly_order, sine, exp):
    x = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    ref = np.asarray(JaxLibrary(3, poly_order, sine, exp)(jnp.asarray(x)))
    lib = FunctionLibrary(3, poly_order, sine, exp)
    got = lib(torch.as_tensor(x)).numpy()
    assert got.shape == (64, lib.n_terms)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert lib.term_names() == JaxLibrary(3, poly_order, sine, exp).term_names()


@pytest.mark.parametrize("dim,poly_order", [(2, 2), (2, 3), (3, 3)])
def test_tables_match_jax(dim, poly_order):
    np.testing.assert_array_equal(poly_exponent_table(dim, poly_order),
                                  jax_exponents(dim, poly_order))
    assert poly_index_table(dim, poly_order).shape[0] == \
        FunctionLibrary(dim, poly_order).n_poly_terms


def test_batched_leading_dims():
    x = torch.randn(4, 5, 2, generator=torch.Generator().manual_seed(0))
    lib = FunctionLibrary(2, 2, include_exp=True)
    np.testing.assert_array_equal(lib(x).numpy(),
                                  lib(x.reshape(20, 2)).reshape(4, 5, -1).numpy())
