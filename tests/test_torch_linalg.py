"""ops/linalg.py against the JAX package's ops/linalg.py on the CPU, on the
same numpy inputs made from a seed.

Solutions agree within 1e-5 relative to the JAX solution's largest element
(f32, well-conditioned systems), masks and zero patterns exactly. The
system that straddles the default cutoff eps * max(m, n) * s_max has
orthogonal columns, so both QRs and SVDs are exact to rounding and the
cutoff alone decides which coefficients are 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.ops import linalg as jlinalg

from symmetry_ode_discovery_tpu_torch.ops import linalg

REL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers on one machine, and
    MKL's batched QR with a thread for every core stalls when a core is busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _system(seed, m=200, n=8, k=None, zero_cols=()):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    A[:, list(zero_cols)] = 0.0
    b = rng.standard_normal((m,) if k is None else (m, k)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, k=3), dict(seed=2, m=64, n=6),
    dict(seed=3, zero_cols=(1,)), dict(seed=4, zero_cols=(0, 5, 6), k=2),
    dict(seed=5, m=40, n=10, zero_cols=(2, 3, 4, 5, 6, 7, 8))],
    ids=["full_rank", "full_rank_k3", "full_rank_64x6", "one_zero_col", "three_zero_cols_k2",
         "seven_zero_cols"])
def test_min_norm_lstsq_matches_jax(case):
    A, b = _system(**case)
    got = linalg.min_norm_lstsq(torch.from_numpy(A), torch.from_numpy(b))
    want = jlinalg.min_norm_lstsq(jnp.asarray(A), jnp.asarray(b))
    assert got.shape == want.shape
    _close(got, want)
    # a zeroed column's coefficient is 0 to rounding in both (the masked
    # solver multiplies it by its 0 mask)
    for j in case.get("zero_cols", ()):
        for x in (np.asarray(got), np.asarray(want)):
            assert np.abs(x[j]).max() <= 1e-6 * np.abs(x).max()


def test_min_norm_lstsq_cutoff_straddle():
    """Singular values 1, 0.5, 3x and 1/3x the cutoff, and an exact 0: the
    first three are kept, the last two give 0, in both packages."""
    m, n = 64, 5
    cutoff = np.finfo(np.float32).eps * m
    s = np.array([1.0, 0.5, 3 * cutoff, cutoff / 3, 0.0], np.float32)
    rng = np.random.default_rng(7)
    rows = rng.permutation(m)[:n]
    cols = rng.permutation(n)
    A = np.zeros((m, n), np.float32)
    A[rows, cols] = s * rng.choice([-1.0, 1.0], n).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    got = linalg.min_norm_lstsq(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.asarray(jlinalg.min_norm_lstsq(jnp.asarray(A), jnp.asarray(b)))
    _close(got, want)
    kept = cols[:3]
    assert (got[kept] != 0).all() and not got[cols[3:]].any()
    assert (want[kept] != 0).all() and not want[cols[3:]].any()


def test_min_norm_lstsq_batched_equals_one_by_one():
    A = np.stack([_system(s)[0] for s in range(3)])
    b = np.stack([_system(s)[1] for s in range(3)])
    got = linalg.min_norm_lstsq(torch.from_numpy(A), torch.from_numpy(b))
    for i in range(3):
        _close(got[i], jlinalg.min_norm_lstsq(jnp.asarray(A[i]), jnp.asarray(b[i])))


@pytest.mark.parametrize("gamma", [0.0, 0.05, 1.0])
def test_ridge_augment_matches_jax(gamma):
    theta, y = _system(11, m=30, n=6, k=2)
    A, B = linalg.ridge_augment(torch.from_numpy(theta), torch.from_numpy(y), gamma)
    jA, jB = jlinalg.ridge_augment(jnp.asarray(theta), jnp.asarray(y), gamma)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(B.numpy(), np.asarray(jB))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_lstsq_per_dim_matches_jax(seed):
    A, B = _system(20 + seed, m=300, n=8, k=2)
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(2, 8)) > 0.4).astype(np.float32)
    mask[:, 0] = 1.0
    got = linalg.masked_lstsq_per_dim(torch.from_numpy(A), torch.from_numpy(B),
                                      torch.from_numpy(mask)).numpy()
    want = np.asarray(jlinalg.masked_lstsq_per_dim(jnp.asarray(A), jnp.asarray(B),
                                                   jnp.asarray(mask)))
    _close(got, want)
    np.testing.assert_array_equal(got != 0, mask > 0)
    np.testing.assert_array_equal(want != 0, mask > 0)
