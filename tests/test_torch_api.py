"""The port's small public functions and its subpackages' exports, against
the JAX package on the same numpy inputs (CPU):

- models/sindy.py sindy_forward (unconstrained and constrained) within
  1e-6 relative, print_equations printing the same lines;
- ops/constraint.py xi_from_beta within 1e-6 (batched too);
- symgp/tape.py eval_population (K5's plain version here) within 1e-5 of
  the JAX interpreter, tape_to_sympy the same expressions;
- data/datasets.py SimpleLinear on the JAX package's draws, fed;
- ops/gp_smoothing.py fit_sigma_in within 1e-6 relative;
- every name of the JAX subpackages' __all__ importable from the port's
  counterpart, but DATA_PATH (the port's caches live outside the tree,
  under data_path()).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.data.datasets import SimpleLinear as JSimpleLinear
from symmetry_ode_discovery_tpu.models import sindy as jsindy
from symmetry_ode_discovery_tpu.ops.constraint import xi_from_beta as jxi_from_beta
from symmetry_ode_discovery_tpu.ops.gp_smoothing import fit_sigma_in as jfit_sigma_in
from symmetry_ode_discovery_tpu.symgp import tape as jtape

from symmetry_ode_discovery_tpu_torch.data import SimpleLinear
from symmetry_ode_discovery_tpu_torch.models import sindy
from symmetry_ode_discovery_tpu_torch.ops.constraint import xi_from_beta
from symmetry_ode_discovery_tpu_torch.ops.gp_smoothing import fit_sigma_in
from symmetry_ode_discovery_tpu_torch.symgp import tape

SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])


def _states(constrained: bool):
    """The JAX init_sindy state and the port's state on the same numbers."""
    kw = dict(L_list=[SO2]) if constrained else {}
    jcfg, jQ = jsindy.make_config(2, poly_order=2, threshold=5e-2, **kw)
    cfg, Q = sindy.make_config(2, poly_order=2, threshold=5e-2, **kw)
    jst = jsindy.init_sindy(jax.random.PRNGKey(3), jcfg, jQ)
    mask = (np.random.default_rng(0).random((2, cfg.n_terms)) > 0.3).astype(np.float32)
    jst = jst.replace(mask=jnp.asarray(mask))
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    st = sindy.SINDyState(Xi=t(jst.Xi), mask=t(mask), beta=t(jst.beta), const=t(jst.const),
                          Q=t(jst.Q))
    return jcfg, jst, cfg, st


@pytest.mark.parametrize("constrained", [False, True], ids=["sindy", "esindy"])
def test_sindy_forward_matches_jax(constrained):
    jcfg, jst, cfg, st = _states(constrained)
    x = np.random.default_rng(1).standard_normal((50, 2)).astype(np.float32)
    want = np.asarray(jsindy.sindy_forward(jcfg, jst, jnp.asarray(x)))
    got = sindy.sindy_forward(cfg, st, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # batched over a leading dimension
    both = sindy.sindy_forward(cfg, st, torch.tensor(np.stack([x, x])))
    assert torch.equal(both[0], both[1])


@pytest.mark.parametrize("constrained", [False, True], ids=["sindy", "esindy"])
def test_print_equations_matches_jax(constrained, capsys):
    jcfg, jst, cfg, st = _states(constrained)
    jsindy.print_equations(jcfg, jst, var="x")
    want = capsys.readouterr().out
    sindy.print_equations(cfg, st, var="x")
    assert capsys.readouterr().out == want
    assert want.count("\n") == 2


def test_xi_from_beta_matches_jax():
    jcfg, jQ = jsindy.make_config(2, poly_order=2, L_list=[SO2])
    rng = np.random.default_rng(2)
    beta = rng.standard_normal((3, jcfg.n_free)).astype(np.float32)
    const = rng.standard_normal((3, 2, 1)).astype(np.float32)
    for allow in (True, False):
        got = xi_from_beta(torch.tensor(jQ, dtype=torch.float32), torch.tensor(beta),
                           torch.tensor(const), 2, jcfg.n_terms, allow).numpy()
        for i in range(3):
            want = np.asarray(jxi_from_beta(jnp.asarray(jQ, jnp.float32), jnp.asarray(beta[i]),
                                            jnp.asarray(const[i]), 2, jcfg.n_terms, allow))
            np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)


def _population(n=48):
    jspec = jtape.TapeSpec(n_vars=2, max_len=25, binary_ops=(jtape.ADD, jtape.SUB, jtape.MUL),
                           unary_ops=(jtape.EXP,))
    spec = tape.TapeSpec(n_vars=2, max_len=25, binary_ops=(tape.ADD, tape.SUB, tape.MUL),
                         unary_ops=(tape.EXP,))
    return jspec, spec, jtape.random_population(np.random.default_rng(4), jspec, n)


def test_eval_population_matches_jax():
    jspec, spec, pop = _population()
    X = np.random.default_rng(5).uniform(-1.5, 1.5, (300, 2)).astype(np.float32)
    want = np.asarray(jtape.eval_population(pop, jnp.asarray(X), jspec))
    got = tape.eval_population(pop, torch.tensor(X), spec)
    assert got.shape == (48, 300) and got.device.type == "cpu"
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_tape_to_sympy_matches_jax():
    _, _, pop = _population(30)
    names = ["u", "v"]
    for row in zip(*pop):
        assert str(tape.tape_to_sympy(*row, var_names=names)) == \
            str(jtape.tape_to_sympy(*row, var_names=names))
    bad = (np.array([tape.ADD, 0]), np.zeros(2, np.int32), np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="underflow"):
        tape.tape_to_sympy(*bad)


def test_simple_linear_on_fed_draws():
    n, seed = 64, 3
    coeff = np.array([[0.5, -1.0], [2.0, 0.1]], np.float32)
    ref = JSimpleLinear(n, coeff=coeff, seed=seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    draws = [np.asarray(jax.random.normal(k, (n, 2))) for k in keys]
    got = SimpleLinear(n, coeff=coeff, device="cpu", draws=draws)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.dx.numpy(), np.asarray(ref.dx), rtol=1e-6, atol=1e-5)
    assert len(got) == n and got.input_dim == 2
    # the port's own draws: seeded, standard-normal scale
    own = SimpleLinear(n, seed=seed, device="cpu")
    assert torch.equal(own.x, SimpleLinear(n, seed=seed, device="cpu").x)
    assert own.x.dtype == torch.float32 and 3.0 < float(own.x.std()) < 20.0


def test_fit_sigma_in_matches_jax():
    rng = np.random.default_rng(6)
    t = np.linspace(0.0, 2.0, 40)
    Y = np.stack([np.sin(3 * t), np.cos(2 * t)], axis=1) + 0.05 * rng.standard_normal((40, 2))
    want = jfit_sigma_in(Y, t, 0.05, 1.0, 0.3)
    got = fit_sigma_in(Y, t, 0.05, 1.0, 0.3)
    assert got == pytest.approx(want, rel=1e-6)


SUBPACKAGES = ("data", "models", "ops", "symgp", "training", "utils", "parallel", "evaluation")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_is_importable_from_the_port(sub):
    jmod = importlib.import_module(f"symmetry_ode_discovery_tpu.{sub}")
    mod = importlib.import_module(f"symmetry_ode_discovery_tpu_torch.{sub}")
    names = [n for n in jmod.__all__ if n != "DATA_PATH"]
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, missing
    assert set(names) <= set(mod.__all__)
