"""The slice as a whole: the port's sweep against the JAX package's
fused-kernel sweep (Pallas in interpret mode) on the same small datasets, the
same per-seed subsample indices and the same theta0 draws.

Per seed, correct_form and the mask must be equal and the MSE within 1e-6
(MSEs here are ~1e-8..1e-3; 1e-6 absolute is far below any change of form
and above the f32 rounding of coefficients within 1e-3 of each other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu.evaluation import aggregate_results as jax_aggregate_results
from symmetry_ode_discovery_tpu.evaluation import sindy_truth as jax_truth
from symmetry_ode_discovery_tpu.models.sindy import make_config as jax_make_config
from symmetry_ode_discovery_tpu.ops.integrators import solve_ode_batch
from symmetry_ode_discovery_tpu.training.siged import LBFGSHParams as JaxHParams
from symmetry_ode_discovery_tpu.training.sweep import (
    _pallas_lbfgs_sweep, _pallas_setup, _prep_normal_eq, eval_coefficients_jnp)
from symmetry_ode_discovery_tpu_torch.evaluation import (
    aggregate_results, eval_sindy_coefficients, sindy_truth)
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams
from symmetry_ode_discovery_tpu_torch.training.sweep import (
    eval_coefficients, sweep_sindy_lbfgs, sweep_sindy_lbfgs_stacked)

SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]])
SEEDS = np.arange(4)


def _data(name, n_ics, steps, dt, noise, seed=0):
    sys_ = SYSTEMS[name]
    x0 = sys_.sample_ics(jax.random.PRNGKey(seed), n_ics)
    x, dx = solve_ode_batch(sys_.f, x0, dt=dt, num_steps=steps)
    x = np.asarray(jnp.transpose(x, (1, 0, 2)).reshape(-1, 2))
    dx = np.asarray(jnp.transpose(dx, (1, 0, 2)).reshape(-1, 2))
    rng = np.random.default_rng(seed)
    return ((x + noise * rng.normal(size=x.shape)).astype(np.float32),
            (dx + noise * rng.normal(size=dx.shape)).astype(np.float32))


CASES = {
    # name: (system, config kwargs, hyper-parameters, data)
    "dosc_sindy": ("dosc", dict(), dict(lr_sindy=1.0, st_freq=10, threshold=5e-2),
                   dict(n_ics=20, steps=200, dt=0.01, noise=0.02)),
    "dosc_esindy": ("dosc", dict(L_list=[SO2]), dict(lr_sindy=1.0, st_freq=10, threshold=5e-2),
                    dict(n_ics=20, steps=200, dt=0.01, noise=0.02)),
    "growth_esindy": ("growth", dict(L_list=[SCALING2], constrain_constant=True),
                      dict(lr_sindy=1.0, st_freq=30, threshold=5e-2),
                      dict(n_ics=30, steps=80, dt=0.02, noise=0.01)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_matches_jax(name):
    system, ckw, hkw, dkw = CASES[name]
    x, dx = _data(system, **dkw)
    hp_kw = dict(num_epochs=30, sindy_reg_type="none", **hkw)
    jcfg, jQ = jax_make_config(2, poly_order=2, threshold=5e-2, **ckw)
    jhp = JaxHParams(**hp_kw)
    k = x.shape[0] // 2
    idx = np.stack([np.random.default_rng(100 + s).permutation(x.shape[0])[:k]
                    for s in SEEDS]).astype(np.int32)
    _, _, n_params = _pallas_setup(jcfg, jQ, jhp)
    th0 = np.asarray(_prep_normal_eq(jcfg, k, n_params, jnp.asarray(x), jnp.asarray(dx),
                                     jnp.asarray(SEEDS), jnp.asarray(idx))[4])
    ref = _pallas_lbfgs_sweep(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx),
                              jax_truth[system], jhp, SEEDS, k, interpret=True,
                              subsample_idx=idx)

    cfg, Q = make_config(2, poly_order=2, threshold=5e-2, **ckw)
    got = sweep_sindy_lbfgs(cfg, Q, x, dx, sindy_truth[system], LBFGSHParams(**hp_kw),
                            SEEDS, lbfgs_subsample=0.5, subsample_idx=idx, theta0=th0,
                            device="cpu")
    assert got.Xi.shape == (len(SEEDS), 2, cfg.n_terms)
    np.testing.assert_array_equal(got.correct_form, ref.correct_form)
    np.testing.assert_array_equal(got.mask, np.asarray(ref.mask).reshape(got.mask.shape))
    np.testing.assert_allclose(got.mse, ref.mse, atol=1e-6)
    np.testing.assert_allclose(got.Xi, ref.Xi, atol=1e-3)


def test_stacked_equals_per_dataset_sweeps():
    cfg, Q = make_config(2, poly_order=2, L_list=[SO2], threshold=5e-2)
    hp = LBFGSHParams(num_epochs=20, lr_sindy=1.0, sindy_reg_type="none",
                      st_freq=10, threshold=5e-2)
    datasets = [_data("dosc", 20, 200, 0.01, noise, seed=s)
                for s, noise in enumerate([0.0, 0.05])]
    stacked = sweep_sindy_lbfgs_stacked(cfg, Q, [d[0] for d in datasets],
                                        [d[1] for d in datasets], sindy_truth["dosc"],
                                        hp, SEEDS, lbfgs_subsample=0.5, device="cpu")
    assert len(stacked) == 2
    for (x, dx), res in zip(datasets, stacked):
        one = sweep_sindy_lbfgs(cfg, Q, x, dx, sindy_truth["dosc"], hp, SEEDS,
                                lbfgs_subsample=0.5, device="cpu")
        np.testing.assert_array_equal(res.mask, one.mask)
        np.testing.assert_array_equal(res.correct_form, one.correct_form)
        np.testing.assert_allclose(res.Xi, one.Xi, atol=1e-6)


def test_sweep_recovers_clean_dosc():
    x, dx = _data("dosc", 20, 200, 0.01, 0.0)
    cfg, Q = make_config(2, poly_order=2, L_list=[SO2], threshold=1e-2)
    hp = LBFGSHParams(num_epochs=30, lr_sindy=1.0, sindy_reg_type="none",
                      st_freq=30, threshold=1e-2)
    res = sweep_sindy_lbfgs(cfg, Q, x, dx, sindy_truth["dosc"], hp, SEEDS,
                            lbfgs_subsample=0.5, device="cpu")
    assert res.correct_form.all(), res.Xi
    assert (res.mse < 1e-5).all()
    summary = aggregate_results(res.results_list(), verbose=False)
    assert summary["success_joint"] == len(SEEDS)


def test_eval_coefficients_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    truth = sindy_truth["lv"]
    coef = (truth + 0.01 * rng.normal(size=(6,) + truth.shape)).astype(np.float32)
    mask = (rng.uniform(size=coef.shape) > 0.3).astype(np.float32)
    mask[0] = truth != 0
    cf, mse = eval_coefficients(torch.as_tensor(coef), torch.as_tensor(mask),
                                torch.as_tensor(truth, dtype=torch.float32))
    for i in range(len(coef)):
        jcf, jmse = eval_coefficients_jnp(jnp.asarray(coef[i]), jnp.asarray(mask[i]),
                                          jnp.asarray(truth))
        np.testing.assert_array_equal(cf[i].numpy(), np.asarray(jcf))
        np.testing.assert_allclose(mse[i].numpy(), np.asarray(jmse), rtol=1e-6)
        ref = eval_sindy_coefficients(coef[i], mask[i], truth)
        np.testing.assert_array_equal(cf[i].numpy(), ref["correct_form"])
        # the numpy reference is float64: f32 rounding of ~1e-2 residuals
        np.testing.assert_allclose(mse[i].numpy(), ref["mse"], rtol=1e-4)
    assert cf[0].all()


def test_aggregate_results_matches_jax():
    rng = np.random.default_rng(1)
    truth = sindy_truth["growth"]
    results = []
    for i in range(12):
        coef = truth + 0.02 * rng.normal(size=truth.shape)
        mask = (truth != 0) | (rng.uniform(size=truth.shape) < 0.1 * (i % 3))
        results.append(eval_sindy_coefficients(coef, mask, truth))
    got = aggregate_results(results, verbose=False)
    ref = jax_aggregate_results(results_list=results, verbose=False)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(ref[key], float),
                                   rtol=0, atol=0, err_msg=key)


def test_subsample_idx_shape_is_checked():
    x, dx = _data("dosc", 4, 50, 0.01, 0.0)
    cfg, _ = make_config(2, poly_order=2)
    with pytest.raises(ValueError):
        sweep_sindy_lbfgs(cfg, None, x, dx, sindy_truth["dosc"], LBFGSHParams(),
                          SEEDS, subsample_idx=np.zeros((4, 3), np.int64), device="cpu")
