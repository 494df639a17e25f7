"""The port's GP engine against the JAX package's on identical inputs (numpy
populations, data and np.random.Generator states):

- the breeding core (the port's copy of csrc/evolve.cpp, built by
  ops/_nvcc.py) against the JAX package's core through evolve.breed and
  objective.paired_breed: bit for bit, and the generators end in one state;
- one generation of make_sweep_gen_step: fitness within 1e-5 relative, the
  top-K index sets equal (also with duplicate tapes, whose fitnesses tie),
  the accepted constants within 1e-4;
- small sweeps (2 seeds, population 64, 6 generations, 256 rows, small
  random g(x) and J_g(x)): the per-seed best tapes equal, ops and args
  exactly and constants within 1e-4; the same for the single-seed engines;
- the same generation and sweeps with the fitness evaluated in bf16
  (--gp_eval_dtype bf16: the reference's fit_loss with eval_dtype bfloat16,
  the port's UnitLoss with eval_dtype): to the same bars, since the bf16
  predictions are bit for bit the reference's (tests/test_torch_tape_bf16.py)
  and only the f32 loss reductions differ in order;
- the form projector: verdicts and coefficients equal on 500 random LV
  tapes and on edge strings;
- the EquivGP-r tables g(x), J_g(x) from the LV checkpoint within 1e-5 of
  their scale, with n_g = 1 group element.

Fitness sums rows in another order than XLA and ATen's exp differs from
XLA's by an ulp: 1e-5 relative. Adam's constants carry that rounding: 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli.main_gp import _task_spec as j_task_spec
from symmetry_ode_discovery_tpu.symgp import eval_gp as jeg
from symmetry_ode_discovery_tpu.symgp import evolve as je
from symmetry_ode_discovery_tpu.symgp import objective as jo
from symmetry_ode_discovery_tpu.symgp import sweep as js
from symmetry_ode_discovery_tpu.symgp import tape as jt

from symmetry_ode_discovery_tpu_torch.cli.main_gp import _task_spec
from symmetry_ode_discovery_tpu_torch.symgp import eval_gp as teg
from symmetry_ode_discovery_tpu_torch.symgp import evolve as te
from symmetry_ode_discovery_tpu_torch.symgp import objective as to
from symmetry_ode_discovery_tpu_torch.symgp import sweep as ts
from symmetry_ode_discovery_tpu_torch.symgp import tape as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads():
    """Small tensors on a few threads: the suite runs several workers on
    one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _lv_data(S=2, N=256, seed=5):
    """LV-like rows, derivatives near the true LV field, and a small random
    group transform g(x) = 1.01 x + 0.01 with noisy Jacobians."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.2, 2.0, (S, N, 2)).astype(np.float32)
    dX = np.stack([2 / 3 - 4 / 3 * np.exp(X[..., 1]), np.exp(X[..., 0]) - 1], -1)
    dX = (dX + 0.05 * rng.standard_normal((S, N, 2))).astype(np.float32)
    gx = (X[:, None] * 1.01 + 0.01).astype(np.float32)
    Jg = (np.eye(2) * 1.01 + 0.01 * rng.standard_normal((S, 1, N, 2, 2))).astype(np.float32)
    return X, dX, gx, Jg


def _cfgs(**kw):
    return je.GPConfig(**kw), te.GPConfig(**kw)


@pytest.mark.parametrize("grouped", [False, True], ids=["breed", "paired_breed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breeding_core_bit_equal(grouped, seed):
    assert je.get_native() is not None  # the JAX package's core, not its numpy fallback
    spec = j_task_spec("lv", 2)
    cfg_j, cfg_t = _cfgs(pop_size=128)
    pop = jt.random_population(np.random.default_rng(seed), spec, 256)
    fit = np.random.default_rng(seed + 10).random(128 if grouped else 256)
    fit[:7] = fit[7]  # ties at the elitism cut
    rj, rt = np.random.default_rng(seed + 20), np.random.default_rng(seed + 20)
    for _ in range(3):  # three generations in a row
        if grouped:
            out_j = jo.paired_breed(pop, fit, rj, spec, cfg_j)
            out_t = to.paired_breed(pop, fit, rt, _task_spec("lv", 2), cfg_t)
        else:
            out_j = je.breed(pop, fit, rj, spec, cfg_j)
            out_t = te.breed(pop, fit, rt, _task_spec("lv", 2), cfg_t)
        for a, b in zip(out_j, out_t):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        pop = out_t
    assert rj.integers(2 ** 63) == rt.integers(2 ** 63)
    assert tt.tape_valid(pop[0]).all()


def _population(seed, U, P, duplicates):
    spec = j_task_spec("lv", 2)
    pops = [jt.random_population(np.random.default_rng(seed + u), spec, P) for u in range(U)]
    ops, args, consts = (np.stack([p[i] for p in pops]) for i in range(3))
    if duplicates:  # 8 distinct tapes, each at 8 scattered indices: their fitnesses tie
        src = np.arange(P) % 8
        ops, args, consts = ops[:, src], args[:, src], consts[:, src]
    return ops, args, consts


@pytest.mark.parametrize("duplicates", [False, True], ids=["random", "duplicates"])
@pytest.mark.parametrize("mode", ["plain", "system"])
def test_one_generation_matches_jax(mode, duplicates):
    X, dX, gx, Jg = _lv_data(S=3, N=200)
    K, k_small = 20, 64
    group = 1 if mode == "plain" else 2
    ops, args, consts = _population(0, 3, 64 * group, duplicates)
    spec_j, spec_t = j_task_spec("lv", 2), _task_spec("lv", 2)
    if mode == "plain":
        data = (X, dX[..., 0])
        unit_j = js._plain_unit_loss(spec_j)
        unit_t = ts._plain_unit_loss(spec_t)
    else:
        data = (X, dX, gx, Jg)
        unit_j = js._system_unit_loss(spec_j, 0.1, 1)
        unit_t = ts._system_unit_loss(spec_t, 0.1, 1)
    small = tuple(a[:, :k_small] if a.ndim < 4 else a[:, :, :k_small] for a in data)
    J = [jnp.asarray(a) for a in (ops, args, consts)]
    T = [torch.as_tensor(a) for a in (ops, args, consts)]
    dj = [jnp.asarray(a) for a in data + small]
    dt = [torch.as_tensor(np.ascontiguousarray(a)) for a in data + small]

    fit0_j = np.asarray(jax.vmap(unit_j)(*J, *dj[:len(data)]))
    with torch.no_grad():
        fit0_t = unit_t(*T, *dt[:len(data)]).numpy()
    np.testing.assert_allclose(fit0_t, fit0_j, rtol=1e-5)
    idx_j = np.asarray(jax.vmap(lambda f: jax.lax.top_k(-f, K)[1])(jnp.asarray(fit0_j)))
    idx_t = torch.sort(torch.as_tensor(fit0_t), dim=1, stable=True).indices[:, :K].numpy()
    for u in range(3):
        assert set(idx_j[u]) == set(idx_t[u])
    if duplicates:  # the cut falls inside a group of tied tapes: lower indices first
        assert any(len(set(fit0_j[u, idx_j[u]])) < K for u in range(3))

    gen_j = js.make_sweep_gen_step(unit_j, 8, 0.05, K, group, n_data=len(data))
    gen_t = ts.make_sweep_gen_step(unit_t, 8, 0.05, K, group, n_data=len(data))
    c_j, f_j = (np.asarray(a) for a in gen_j(*J, *dj))
    c_t, f_t = (a.numpy() for a in gen_t(*T, *dt))
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    changed_j, changed_t = (c_j != consts).any(-1), (c_t != consts).any(-1)
    np.testing.assert_array_equal(changed_t, changed_j)  # the same groups accepted
    assert changed_t.any()


@pytest.mark.parametrize("mode", ["plain", "system"])
def test_one_generation_bf16_fitness_matches_jax(mode):
    """One generation whose full-batch fitness runs in bf16 (the ranking and
    the accept/reject comparison) and whose Adam gradient stays f32."""
    X, dX, gx, Jg = _lv_data(S=3, N=200, seed=6)
    K, k_small = 20, 64
    group = 1 if mode == "plain" else 2
    ops, args, consts = _population(1, 3, 64 * group, False)
    spec_j, spec_t = j_task_spec("lv", 2), _task_spec("lv", 2)
    if mode == "plain":
        data = (X, dX[..., 0])
        unit_j, fit_j = (js._plain_unit_loss(spec_j, eval_dtype=e) for e in (None, jnp.bfloat16))
        unit_t = ts._plain_unit_loss(spec_t)
    else:
        data = (X, dX, gx, Jg)
        unit_j, fit_j = (js._system_unit_loss(spec_j, 0.1, 1, eval_dtype=e)
                         for e in (None, jnp.bfloat16))
        unit_t = ts._system_unit_loss(spec_t, 0.1, 1)
    fit_t = dataclasses.replace(unit_t, eval_dtype=torch.bfloat16)
    small = tuple(a[:, :k_small] if a.ndim < 4 else a[:, :, :k_small] for a in data)
    J = [jnp.asarray(a) for a in (ops, args, consts)]
    T = [torch.as_tensor(a) for a in (ops, args, consts)]
    dj = [jnp.asarray(a) for a in data + small]
    dt = [torch.as_tensor(np.ascontiguousarray(a)) for a in data + small]

    fit0_j = np.asarray(jax.vmap(fit_j)(*J, *dj[:len(data)]))
    with torch.no_grad():
        fit0_t = fit_t(*T, *dt[:len(data)])
    assert fit0_t.dtype == torch.float32
    np.testing.assert_allclose(fit0_t.numpy(), fit0_j, rtol=1e-5)
    with torch.no_grad():  # bf16 predictions: another fitness than the f32 one
        assert not torch.equal(fit0_t, unit_t(*T, *dt[:len(data)]))

    gen_j = js.make_sweep_gen_step(unit_j, 8, 0.05, K, group, n_data=len(data), fit_loss=fit_j)
    gen_t = ts.make_sweep_gen_step(unit_t, 8, 0.05, K, group, n_data=len(data), fit_loss=fit_t)
    c_j, f_j = (np.asarray(a) for a in gen_j(*J, *dj))
    c_t, f_t = (a.numpy() for a in gen_t(*T, *dt))
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal((c_t != consts).any(-1), (c_j != consts).any(-1))
    assert (c_t != consts).any()


@pytest.mark.parametrize("mode", ["plain", "system"])
def test_small_sweeps_bf16_fitness_give_the_same_tapes(mode):
    X, dX, gx, Jg = _lv_data(seed=7)
    cfg_j, cfg_t = _cfgs(pop_size=64, n_generations=6)
    kw_j, kw_t = dict(eval_dtype=jnp.bfloat16), dict(eval_dtype=torch.bfloat16, device="cpu")
    if mode == "plain":
        pj, rj = js.gp_sweep_plain(X, dX, j_task_spec("lv", 2), cfg_j, [0, 1],
                                   const_subsample=128, **kw_j)
        pt, rt = ts.gp_sweep_plain(X, dX, _task_spec("lv", 2), cfg_t, [0, 1],
                                   const_subsample=128, **kw_t)
    else:
        pj, rj = js.gp_sweep_system(X, dX, j_task_spec("lv", 2), cfg_j, [0, 1], gx_all=gx,
                                    Jgx_all=Jg, w_sym_reg=0.1, const_subsample=128, **kw_j)
        pt, rt = ts.gp_sweep_system(X, dX, _task_spec("lv", 2), cfg_t, [0, 1], gx_all=gx,
                                    Jgx_all=Jg, w_sym_reg=0.1, const_subsample=128, **kw_t)
    np.testing.assert_allclose(rt.history, np.asarray(rj.history), rtol=1e-4)
    _assert_same_tapes([b for s in pj for b in s], [b for s in pt for b in s])


def _assert_same_tapes(best_j, best_t):
    for bj, bt in zip(best_j, best_t):
        assert tt.tape_to_string(*bt) == jt.tape_to_string(*bj)
        np.testing.assert_array_equal(bt[0], bj[0])
        np.testing.assert_array_equal(bt[1], bj[1])
        np.testing.assert_allclose(bt[2], bj[2], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "system"])
def test_small_sweeps_give_the_same_tapes(mode):
    X, dX, gx, Jg = _lv_data()
    cfg_j, cfg_t = _cfgs(pop_size=64, n_generations=6)
    if mode == "plain":
        pj, rj = js.gp_sweep_plain(X, dX, j_task_spec("lv", 2), cfg_j, [0, 1],
                                   const_subsample=128)
        pt, rt = ts.gp_sweep_plain(X, dX, _task_spec("lv", 2), cfg_t, [0, 1],
                                   const_subsample=128, device="cpu")
    else:
        pj, rj = js.gp_sweep_system(X, dX, j_task_spec("lv", 2), cfg_j, [0, 1], gx_all=gx,
                                    Jgx_all=Jg, w_sym_reg=0.1, const_subsample=128)
        pt, rt = ts.gp_sweep_system(X, dX, _task_spec("lv", 2), cfg_t, [0, 1], gx_all=gx,
                                    Jgx_all=Jg, w_sym_reg=0.1, const_subsample=128,
                                    device="cpu")
    # best-so-far fitness after Adam: the constants' rounding (1e-4) enters
    np.testing.assert_allclose(rt.history, np.asarray(rj.history), rtol=1e-4)
    _assert_same_tapes([b for s in pj for b in s], [b for s in pt for b in s])
    assert rt.device_s.shape == rt.host_s.shape == (6,)


@pytest.mark.parametrize("mode", ["plain", "system"])
def test_single_seed_engines_give_the_same_tapes(mode):
    X, dX, gx, Jg = _lv_data(S=1, N=150, seed=8)
    cfg_j, cfg_t = _cfgs(pop_size=48, n_generations=4, seed=3)
    if mode == "plain":
        bj, hj = je.symbolic_regression(X[0], dX[0, :, 1], j_task_spec("lv", 2), cfg_j)
        bt, ht = te.symbolic_regression(X[0], dX[0, :, 1], _task_spec("lv", 2), cfg_t,
                                        device="cpu")
        bj, bt = [bj], [bt]
    else:
        bj, hj = jo.symbolic_regression_system(X[0], dX[0], j_task_spec("lv", 2), cfg_j,
                                               gx_list=list(gx[0]), Jgx_list=list(Jg[0]),
                                               w_sym_reg=0.1)
        bt, ht = to.symbolic_regression_system(X[0], dX[0], _task_spec("lv", 2), cfg_t,
                                               gx_list=list(gx[0]), Jgx_list=list(Jg[0]),
                                               w_sym_reg=0.1, device="cpu")
        bj = [tuple(a[c] for a in bj) for c in range(2)]
        bt = [tuple(a[c] for a in bt) for c in range(2)]
    np.testing.assert_allclose(ht, hj, rtol=1e-4)
    _assert_same_tapes(bj, bt)


EDGE = ["exp(x0 + 0.5)", "exp(2*x0)", "x0*exp(x0)", "(-(-(x0)))", "(-(x1 - (-x0)))",
        "exp(exp(x0))", "0.6667 - 1.333*exp(x1)", "exp(x0) - 1.0", "x0/x1", "sin(x0)",
        "<invalid>", "(x0 * (x0 * x1))", "((0.5 + x0) * (x1 - 0.25))"]


@pytest.mark.parametrize("task", ["lv", "selkov", "dosc"])
def test_projector_matches_jax(task):
    spec = j_task_spec(task, 2)
    pop = jt.random_population(np.random.default_rng(11), spec, 500 if task == "lv" else 100)
    exprs = [jt.tape_to_string(*r) for r in zip(*pop)] + EDGE
    verdicts = []
    for e in exprs:
        cj, okj = jeg.expr_to_library_coeffs(e, task)
        ct, okt = teg.expr_to_library_coeffs(e, task)
        assert okt == okj, e
        if okj:
            np.testing.assert_array_equal(ct, cj)
        verdicts.append(okt)
    assert 0 < sum(verdicts) < len(verdicts)
    eqs = [exprs[i:i + 2] for i in range(0, 40, 2)] + [["0.6667 - 1.3333*exp(x1)",
                                                          "exp(x0) - 1.0"]]
    for pair in eqs:
        rj, rt = jeg.eval_gp_equations(pair, task), teg.eval_gp_equations(pair, task)
        assert rj.keys() == rt.keys()
        for k in rj:
            np.testing.assert_array_equal(np.asarray(rt[k]), np.asarray(rj[k]))


@pytest.fixture(scope="module")
def lv_precompute():
    """(JAX precompute, port precompute) from saved_models/laligan-noise99-lv
    with the flags of lv/noise99_eq_gp_symm.cfg."""
    from symmetry_ode_discovery_tpu.cli.main import build_models
    from symmetry_ode_discovery_tpu.models import lie_generator as jlg
    from symmetry_ode_discovery_tpu.training.symmreg import make_precompute_symmreg_r
    from symmetry_ode_discovery_tpu.utils import checkpoint as ckpt
    from symmetry_ode_discovery_tpu.utils.config import get_args as j_get_args

    from symmetry_ode_discovery_tpu_torch.cli.main_gp import make_gx_fn
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    cfg = os.path.join(REPO, "run_configs/lv/noise99_eq_gp_symm.cfg")
    args = vars(j_get_args(["--config", cfg]))
    args["input_dim"] = 2
    ae_def, gspec, _ = build_models(args)
    k = jax.random.PRNGKey(0)
    params, bstats = ae_def.init(k)
    bundle = {"ae": params, "d": {}, "g": jlg.init_generator(k, gspec)}
    bundle, bstats = ckpt.load_laligan(args["load_laligan"], bundle, bstats,
                                       root=os.path.join(REPO, "saved_models"))
    pre_j = make_precompute_symmreg_r(ae_def, bundle["ae"], bstats, gspec, bundle["g"])
    targs = vars(get_args(["--config", cfg]))
    targs["input_dim"] = 2
    pre_t = make_gx_fn(targs, "cpu", os.path.join(REPO, "saved_models"))
    return pre_j, pre_t


def test_equivgp_precompute_matches_jax(lv_precompute):
    pre_j, pre_t = lv_precompute
    x = np.random.default_rng(9).uniform(0.0, 2.5, (256, 2)).astype(np.float32)
    gx_j, J_j = pre_j(jnp.asarray(x))
    gx_t, J_t = pre_t(torch.as_tensor(x))
    assert len(gx_j) == len(gx_t) == 1  # n_g = 1 for this checkpoint's generator
    for a, b in zip(gx_j + J_j, gx_t + J_t):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5 * np.abs(a).max(), rtol=0)
    assert all(bool(torch.isfinite(t).all()) for t in gx_t + J_t)
