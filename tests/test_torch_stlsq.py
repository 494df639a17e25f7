"""Direct STLSQ: models/sindy.py's solvers and training/sweep.py's
sweep_sindy_stlsq against the JAX package's on the CPU, on the same numpy
inputs made from a seed.

Cases: unconstrained (dosc), constrained with a free constant per equation
(dosc, so(2)) and constrained without one (growth, scaling, constrained
constant). Coefficients agree within 1e-5 relative to the largest, residuals
within 1e-5 relative, the sweep's MSEs within 1e-6 absolute (as in
tests/test_torch_sweep.py), masks, forms and convergence flags exactly. The sweep takes
the JAX sweep's own per-seed rows (fold_in(PRNGKey(0), s), then the first
split's permutation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.evaluation import sindy_truth as jax_truth
from symmetry_ode_discovery_tpu.models import sindy as jsindy
from symmetry_ode_discovery_tpu.training.sweep import sweep_sindy_stlsq as jax_sweep_stlsq

from symmetry_ode_discovery_tpu_torch.convert import sindy_state
from symmetry_ode_discovery_tpu_torch.models import sindy
from symmetry_ode_discovery_tpu_torch.training.sweep import sweep_sindy_stlsq

REL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers on one machine, and
    MKL's batched QR with a thread for every core stalls when a core is busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]])
CASES = {
    # name: (task, make_config kwargs, ridge gamma, threshold)
    "plain": ("dosc", dict(), 0.0, 5e-2),
    "plain_ridge": ("dosc", dict(), 0.05, 5e-2),
    "so2_free_const": ("dosc", dict(L_list=[SO2]), 0.0, 5e-2),
    "scaling_no_const": ("growth", dict(L_list=[SCALING2], constrain_constant=True), 0.0, 5e-2),
}


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _rows(task, n=400, seed=0, noise=0.01):
    """Rows of the task's true equation on a box, with Gaussian noise on dx."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    if task == "growth":
        x = rng.uniform(0.2, 1.5, (n, 2)).astype(np.float32)
    cfg, _ = sindy.make_config(2, poly_order=2)
    theta = cfg.library(torch.from_numpy(x)).numpy()
    dx = theta @ jax_truth[task].T + noise * rng.standard_normal((n, 2))
    return x, dx.astype(np.float32)


def _configs(name):
    task, kw, gamma, thr = CASES[name]
    cfg, Q = sindy.make_config(2, poly_order=2, threshold=thr, **kw)
    jcfg, jQ = jsindy.make_config(2, poly_order=2, threshold=thr, **kw)
    if Q is not None:
        np.testing.assert_array_equal(Q, jQ)
    return task, cfg, Q, jcfg, jQ, gamma, thr


def _states(cfg, jcfg, jQ, key=3):
    jst = jsindy.init_sindy(jax.random.PRNGKey(key), jcfg, jQ)
    return sindy_state(jst, "cpu"), jst


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_sindy_one_step_matches_jax(name):
    task, cfg, Q, jcfg, jQ, gamma, thr = _configs(name)
    x, y = _rows(task)
    st, jst = _states(cfg, jcfg, jQ)
    # a second step from a thinned mask exercises the masked columns
    for _ in range(2):
        st, resid, conv = sindy.solve_sindy_one_step(cfg, st, torch.from_numpy(x),
                                                     torch.from_numpy(y), gamma, thr)
        jst, jresid, jconv = jsindy.solve_sindy_one_step(jcfg, jst, jnp.asarray(x),
                                                         jnp.asarray(y), gamma, thr)
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(jst.mask))
        _close(sindy.get_Xi(cfg, st), jsindy.get_Xi(jcfg, jst))
        _close(resid, jresid)
        assert bool(conv) == bool(jconv)
    if cfg.constraint:
        _close(st.beta, jst.beta)
        if cfg.allow_constant:
            _close(st.const, jst.const)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_sindy_matches_jax(name):
    task, cfg, Q, jcfg, jQ, gamma, thr = _configs(name)
    x, y = _rows(task, seed=1)
    st, jst = _states(cfg, jcfg, jQ, key=5)
    st, resid = sindy.solve_sindy(cfg, st, torch.from_numpy(x), torch.from_numpy(y), gamma, thr,
                                  max_iter=6)
    jst, jresid = jsindy.solve_sindy(jcfg, jst, jnp.asarray(x), jnp.asarray(y), gamma, thr,
                                     max_iter=6)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(jst.mask))
    _close(sindy.get_Xi(cfg, st), jsindy.get_Xi(jcfg, jst))
    _close(resid, jresid)
    # the true equation's support survives the threshold
    assert (st.mask.numpy()[jax_truth[task] != 0] > 0).all()


def test_init_sindy_draws_from_the_generator():
    cfg, Q = sindy.make_config(2, poly_order=2, L_list=[SO2])
    a = sindy.init_sindy(torch.Generator().manual_seed(4), cfg, Q)
    b = sindy.init_sindy(torch.Generator().manual_seed(4), cfg, Q)
    torch.testing.assert_close(a.Xi, b.Xi, rtol=0, atol=0)
    assert a.beta.shape == (cfg.n_free,) and a.const.shape == (2, 1)
    torch.testing.assert_close(a.Xi, sindy.get_Xi(cfg, a))
    assert (a.mask == 1).all()


@pytest.mark.parametrize("name", ["plain", "so2_free_const", "scaling_no_const"])
@pytest.mark.parametrize("subsample", [0.5, 1.0])
def test_sweep_stlsq_on_injected_rows_matches_jax(name, subsample):
    task, cfg, Q, jcfg, jQ, gamma, thr = _configs(name)
    x, dx = _rows(task, n=300, seed=2, noise=0.05)
    seeds = np.arange(4)
    n, k = x.shape[0], int(x.shape[0] * subsample)
    idx = np.stack([np.asarray(jax.random.permutation(jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), s))[0], n)[:k]) for s in seeds])
    got = sweep_sindy_stlsq(cfg, Q, x, dx, jax_truth[task], list(seeds), w_sindy_reg=gamma,
                            threshold=thr, subsample=subsample, max_iter=5,
                            subsample_idx=idx, device="cpu")
    want = jax_sweep_stlsq(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx), jax_truth[task], seeds,
                           w_sindy_reg=gamma, threshold=thr, subsample=subsample, max_iter=5,
                           n_mesh_devices=1)
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    np.testing.assert_array_equal(got.correct_form, np.asarray(want.correct_form))
    _close(got.Xi, want.Xi)
    # the MSE as in tests/test_torch_sweep.py: within 1e-6 absolute
    np.testing.assert_allclose(got.mse, np.asarray(want.mse), rtol=0, atol=1e-6)
