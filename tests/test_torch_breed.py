"""The numpy breeding paths against the JAX package's: symgp/evolve.py's
breed_numpy (with _splice and _mutate) and symgp/objective.py's
paired_breed_numpy against the JAX breed_numpy and the numpy branch of the
JAX paired_breed (reached by making its get_native return no core), over 5
generations from one population and one np.random.Generator each: the
populations bit-equal every generation, and the generators' states equal
after. The LV search space (max_len 25, exp) and selkov's (max_len 40)."""

import numpy as np
import pytest

from symmetry_ode_discovery_tpu.symgp import evolve as jevolve
from symmetry_ode_discovery_tpu.symgp import objective as jobjective
from symmetry_ode_discovery_tpu.symgp import tape as jtape

from symmetry_ode_discovery_tpu_torch.symgp import evolve, objective, tape

SPECS = {"lv": dict(n_vars=2, max_len=25, unary=True),
         "selkov": dict(n_vars=2, max_len=40, unary=False)}
GENERATIONS = 5


def _specs(name):
    kw = SPECS[name]
    unary_j = (jtape.EXP,) if kw["unary"] else ()
    unary = (tape.EXP,) if kw["unary"] else ()
    return (jtape.TapeSpec(n_vars=kw["n_vars"], max_len=kw["max_len"],
                           binary_ops=(jtape.ADD, jtape.SUB, jtape.MUL), unary_ops=unary_j),
            tape.TapeSpec(n_vars=kw["n_vars"], max_len=kw["max_len"],
                          binary_ops=(tape.ADD, tape.SUB, tape.MUL), unary_ops=unary))


def _fitness(pop, seed):
    """A fitness that depends on the tapes (lengths, constants) and ties."""
    ops, _, consts = pop
    lens = jtape.tape_length(ops).astype(np.float64)
    noise = np.random.default_rng(seed).random(ops.shape[0])
    return np.round(lens / 7.0 + np.abs(consts).sum(axis=1) * 0.01 + noise, 2)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_breed_numpy_bit_equal(name):
    jspec, spec = _specs(name)
    cfg_j = jevolve.GPConfig(pop_size=96)
    cfg = evolve.GPConfig(pop_size=96)
    pop = jtape.random_population(np.random.default_rng(1), jspec, cfg.pop_size)
    rng_j, rng = np.random.default_rng(7), np.random.default_rng(7)
    pop_j = pop
    for g in range(GENERATIONS):
        fit = _fitness(pop_j, g)
        pop_j = jevolve.breed_numpy(pop_j, fit, rng_j, jspec, cfg_j)
        pop = evolve.breed_numpy(pop, fit, rng, spec, cfg)
        _assert_same(pop, pop_j)
        assert jtape.tape_valid(pop[0]).all()
    assert rng.bit_generator.state == rng_j.bit_generator.state


@pytest.mark.parametrize("name", sorted(SPECS))
def test_paired_breed_numpy_bit_equal(name, monkeypatch):
    monkeypatch.setattr(jevolve, "get_native", lambda: None)
    jspec, spec = _specs(name)
    cfg_j = jevolve.GPConfig(pop_size=64)
    cfg = evolve.GPConfig(pop_size=64)
    pop = jobjective.paired_population(np.random.default_rng(2), jspec, cfg.pop_size)
    rng_j, rng = np.random.default_rng(11), np.random.default_rng(11)
    pop_j = pop
    for g in range(GENERATIONS):
        fit = _fitness(pop_j, 100 + g)
        fit_p = fit.reshape(-1, 2).sum(axis=1)
        pop_j = jobjective.paired_breed(pop_j, fit_p, rng_j, jspec, cfg_j)
        pop = objective.paired_breed_numpy(pop, fit_p, rng, spec, cfg)
        _assert_same(pop, pop_j)
        assert pop[0].shape == (2 * cfg.pop_size, spec.max_len)
    assert rng.bit_generator.state == rng_j.bit_generator.state


def test_splice_and_mutate_bit_equal():
    jspec, spec = _specs("selkov")
    pop = jtape.random_population(np.random.default_rng(3), jspec, 40)
    rng_j, rng = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(0, 40, 2):
        a = tuple(x[i] for x in pop)
        b = tuple(x[i + 1] for x in pop)
        _assert_same(evolve._splice(a, b, rng, spec), jevolve._splice(a, b, rng_j, jspec))
        _assert_same(evolve._mutate(a, rng, spec), jevolve._mutate(a, rng_j, jspec))
    assert rng.bit_generator.state == rng_j.bit_generator.state
