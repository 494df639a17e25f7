"""The JAX package's per-seed draws, dumped for the port, and the CLI pieces
that take them.

- tools/dump_jax_draws.py's idx and theta0 equal the JAX CLI's own draws:
  the host-stepped fit's (cli/main.py:359-363, training/siged.py's
  init_params: Xi (d, p), or [beta, const] under a constraint, which the
  port's lanes take flat) and the sweep's (training/sweep.py::_prep_normal_eq,
  whose reduction the rows must reproduce).
- The port's sweep branch (cli/main.py::run) passes a file's theta0 through
  unchanged and, on a dumped file, gives the JAX package's fused-kernel sweep
  (Pallas in interpret mode) per seed; the stepped branch's parity on dumped
  draws is tests/test_torch_stepper.py's.
- A multi-seed sweep without a ground truth runs through the host-stepped fit
  and writes no eval npz, as the JAX CLI's.
- cli/aggregate.py prints what the JAX package's prints on tracked run
  directories, plain and with --impute_nan.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli import aggregate as jax_aggregate
from symmetry_ode_discovery_tpu.evaluation import sindy_truth as jax_truth
from symmetry_ode_discovery_tpu.models.sindy import make_config as jax_make_config
from symmetry_ode_discovery_tpu.training import siged as jsiged
from symmetry_ode_discovery_tpu.training.siged import LBFGSHParams as JaxHParams
from symmetry_ode_discovery_tpu.training.sweep import (
    _pallas_lbfgs_sweep, _pallas_setup, _prep_normal_eq)

from symmetry_ode_discovery_tpu_torch.cli import aggregate
from symmetry_ode_discovery_tpu_torch.cli import main as cli_main
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training import siged, sweep
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SEEDS = [0, 1, 5]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dump_jax_draws", os.path.join(REPO, "tools", "dump_jax_draws.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DUMP = _tool()


def _dosc(n=600, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    A = np.array([[-0.1, -1.0], [1.0, -0.1]], np.float32)
    dx = (x @ A.T + 0.01 * rng.standard_normal((n, 2))).astype(np.float32)
    return x, dx


def _cli_prep_seed(s, n, k):
    """The JAX CLI's per-seed keys and rows (cli/main.py:359-363)."""
    kperm, kfit, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), s), 3)
    return np.asarray(jax.random.permutation(kperm, n)[:k]), kfit


@pytest.mark.parametrize("constrained", [False, True], ids=["Xi", "beta_const"])
def test_stepped_draws_are_the_jax_clis(constrained):
    n, k = 600, 60
    jcfg, jQ = jax_make_config(2, poly_order=2, L_list=[SO2] if constrained else [])
    idx, theta0 = DUMP.stepped_draws(jcfg, jQ, n, k, SEEDS)
    init_params, jxi_of = jsiged._make_param_fns(jcfg, None if jQ is None else jnp.asarray(jQ))
    cfg, Q = make_config(2, poly_order=2, L_list=[SO2] if constrained else [])
    n_params, _, xi_of = siged._make_param_fns(cfg, Q)
    for i, s in enumerate(SEEDS):
        rows, kfit = _cli_prep_seed(s, n, k)
        np.testing.assert_array_equal(idx[i], rows)
        params = init_params(kfit)
        want = np.asarray(params["Xi"]) if not constrained else np.concatenate(
            [np.asarray(params["beta"]), np.asarray(params["const"]).reshape(-1)])
        np.testing.assert_array_equal(theta0[i], want)
        # the port's flat lane reads the same coefficients from it
        flat = torch.as_tensor(theta0[i].reshape(1, -1))
        assert flat.shape[1] == n_params
        np.testing.assert_allclose(xi_of(flat)[0].numpy(), np.asarray(jxi_of(params)),
                                   atol=1e-6)
    assert theta0.shape == ((len(SEEDS), 2, 6) if not constrained else (len(SEEDS), n_params))


@pytest.mark.parametrize("given", [False, True], ids=["drawn", "perms"])
def test_sweep_draws_are_prep_normal_eqs(given):
    x, dx = _dosc()
    n, k = x.shape[0], x.shape[0] // 2
    jcfg, jQ = jax_make_config(2, poly_order=2, L_list=[SO2])
    perms = (np.stack([np.random.default_rng(s).permutation(n)[:k] for s in SEEDS])
             if given else None)
    idx, theta0 = DUMP.sweep_draws(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx), k, SEEDS, perms)
    n_params = _pallas_setup(jcfg, jQ, JaxHParams())[2]
    S, B, q, _, th0 = _prep_normal_eq(jcfg, k, n_params, jnp.asarray(x), jnp.asarray(dx),
                                      jnp.asarray(SEEDS), None if perms is None
                                      else jnp.asarray(perms))
    np.testing.assert_array_equal(theta0, np.asarray(th0))
    if given:
        np.testing.assert_array_equal(idx, perms)
    S2, B2, q2, _, _ = _prep_normal_eq(jcfg, k, n_params, jnp.asarray(x), jnp.asarray(dx),
                                       jnp.asarray(SEEDS), jnp.asarray(idx))
    for a, b in ((S, S2), (B, B2), (q, q2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_draws_flattens_and_repeats(tmp_path):
    path = tmp_path / "d.npz"
    theta0 = np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4)
    np.savez(path, seeds=np.array([4, 7, 9], np.int32), idx=np.arange(9).reshape(3, 3),
             theta0=theta0)
    idx, th = cli_main.load_draws(str(path), [9, 4, 4])
    np.testing.assert_array_equal(idx, [[6, 7, 8], [0, 1, 2], [0, 1, 2]])
    np.testing.assert_array_equal(th, theta0[[2, 0, 0]].reshape(3, 8))
    np.savez(path, seeds=np.array([4, 7, 9], np.int32), idx=np.arange(9).reshape(3, 3))
    assert cli_main.load_draws(str(path), [7])[1] is None


def _sweep_args(tmp_path, draws):
    args = vars(get_args(["--config", "dosc/noise20_esindy.cfg", "--n_seeds", str(len(SEEDS)),
                          "--seed", "0", "--num_epochs", "20", "--st_freq", "10",
                          "--threshold", "5e-2", "--subsample_perms", str(draws),
                          "--eval_root", str(tmp_path / "ev")]))
    return args


def _dump_sweep(tmp_path, x, dx, seeds):
    jcfg, jQ = jax_make_config(2, poly_order=2, L_list=[SO2], threshold=5e-2)
    idx, theta0 = DUMP.sweep_draws(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx),
                                   x.shape[0] // 2, seeds)
    path = tmp_path / "draws.npz"
    np.savez(path, seeds=np.asarray(seeds, np.int32), idx=idx, theta0=theta0)
    return path, idx, theta0, jcfg, jQ


def test_sweep_branch_passes_theta0_through(tmp_path, monkeypatch):
    x, dx = _dosc()
    seeds = list(range(len(SEEDS)))
    path, idx, theta0, _, _ = _dump_sweep(tmp_path, x, dx, seeds)
    seen = {}
    real = sweep.sweep_sindy_lbfgs

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(sweep, "sweep_sindy_lbfgs", spy)
    cli_main.run(_sweep_args(tmp_path, path), train_data=(x, dx), device="cpu")
    np.testing.assert_array_equal(seen["theta0"], theta0)
    assert seen["theta0"].dtype == np.float32
    np.testing.assert_array_equal(seen["subsample_idx"], idx)


def test_sweep_branch_on_dumped_draws_matches_jax(tmp_path):
    x, dx = _dosc()
    seeds = list(range(len(SEEDS)))
    path, idx, _, jcfg, jQ = _dump_sweep(tmp_path, x, dx, seeds)
    args = _sweep_args(tmp_path, path)
    out = cli_main.run(args, train_data=(x, dx), device="cpu")
    jhp = JaxHParams(num_epochs=20, lr_sindy=args["lr_sindy"], sindy_reg_type="l1",
                     w_sindy_reg=args["w_sindy_reg"], st_freq=10, threshold=5e-2)
    ref = _pallas_lbfgs_sweep(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx), jax_truth["dosc"], jhp,
                              np.asarray(seeds), x.shape[0] // 2, interpret=True,
                              subsample_idx=idx)
    np.testing.assert_array_equal(out["mask"], np.asarray(ref.mask).reshape(out["mask"].shape))
    np.testing.assert_allclose(out["Xi"], ref.Xi, atol=1e-3)
    for i, s in enumerate(seeds):
        with np.load(tmp_path / "ev" / args["save_dir"] / f"seed{s}.npz") as z:
            np.testing.assert_array_equal(z["correct_form"], ref.correct_form[i])


def test_sweep_without_ground_truth_writes_nothing(tmp_path):
    """rd has no entry in sindy_truth: the sweep takes the host-stepped fit."""
    x, dx = _dosc()
    args = vars(get_args(["--task", "rd", "--sindy_optimizer", "lbfgs", "--ae_arch", "none",
                          "--latent_dim", "2",
                          "--n_comps", "1", "--repr", "(1,so2)", "--n_seeds", "3",
                          "--seed_chunk", "2", "--num_epochs", "4", "--lr_sindy", "1.0",
                          "--st_freq", "2", "--lbfgs_subsample", "0.5",
                          "--eval_root", str(tmp_path / "ev")]))
    out = cli_main.run(args, train_data=(x, dx), device="cpu")
    assert not (tmp_path / "ev").exists()
    assert out["Xi"].shape == (3, 2, 6) and np.isfinite(out["Xi"]).all()
    assert out["seeds_run"] == list(range(args["seed"], args["seed"] + 3))
    assert len(out["epochs_run"]) == 2
    # thresholding kept the linear terms of the oscillator it was fitted to
    assert (out["mask"][:, :, 1:3] > 0).all()


@pytest.mark.parametrize("impute", [False, True], ids=["plain", "impute_nan"])
@pytest.mark.parametrize("run_name", ["esindy-noise20-dosc", "symreg2-noise99-lv-pallasf32"])
def test_aggregate_prints_the_jax_clis_lines(run_name, impute, capsys):
    argv = [run_name, "--max_seed", "50", "--result_dir", os.path.join(REPO, "eval_results")]
    argv += ["--impute_nan"] if impute else []
    jax_aggregate.main(argv)
    want = capsys.readouterr().out
    aggregate.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert "Joint success rate" in got
