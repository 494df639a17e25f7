"""Weak SINDy: models/wsindy.py, training/sweep.py's sweep_wsindy and
cli/main_wsindy.py against the JAX package's on the CPU, on the same numpy
trajectories made from a seed; cli/main_sindy.py against the JAX STLSQ CLI.

- The test-function matrices and each solve agree within 1e-5 relative to
  the largest element (residuals 1e-4); masks, forms and convergence flags
  exactly.
- The ``ref`` windows: for seeds 0-49 the port's equal the JAX sweep's
  (read off the arguments of the solve it launches), and the two sweeps
  give the same masks and coefficients within 1e-3 (the repo's sweep bar).
- tools/dump_jax_draws.py's WSINDy windows, read back by --subsample_perms,
  give the JAX CLI's default sweep (its own draws) seed for seed.
- Both CLIs write the JAX CLIs' eval npz keys and outcomes.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli import main_sindy as jax_main_sindy
from symmetry_ode_discovery_tpu.cli import main_wsindy as jax_main_wsindy
from symmetry_ode_discovery_tpu.data import datasets as jax_datasets
from symmetry_ode_discovery_tpu.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu.evaluation import sindy_truth as jax_truth
from symmetry_ode_discovery_tpu.models import sindy as jsindy
from symmetry_ode_discovery_tpu.models import wsindy as jwsindy
from symmetry_ode_discovery_tpu.ops.integrators import solve_ode_batch
from symmetry_ode_discovery_tpu.training.sweep import sweep_wsindy as jax_sweep_wsindy
from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

from symmetry_ode_discovery_tpu_torch.cli import main_sindy, main_wsindy
from symmetry_ode_discovery_tpu_torch.convert import sindy_state
from symmetry_ode_discovery_tpu_torch.models import sindy, wsindy
from symmetry_ode_discovery_tpu_torch.training.sweep import sweep_wsindy, wsindy_windows
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
# the residual is the mean square of G Xi - b, whose elements cancel to a
# small part of their terms' size: 1e-4 relative
RESID_REL = 1e-4
# a sweep's coefficients: the repo's bar (tests/test_pallas_lbfgs.py:68-69)
SWEEP_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers on one machine, and
    MKL's batched QR with a thread for every core stalls when a core is busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
EVAL_KEYS = {"coefficients", "correct_form", "mse", "correct_form_all", "mse_all"}
# name: (task, make_config kwargs, ridge, threshold)
CASES = {
    "lv_exp": ("lv", dict(include_exp=True), 0.0, 0.15),
    "dosc": ("dosc", dict(), 0.0, 5e-2),
    "growth_ridge": ("growth", dict(), 0.05, 5e-2),
}


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# steps a trajectory: a few time units of each system at its cached-data dt
STEPS = {"lv": 5000, "dosc": 200, "growth": 200}


def _trajs(task, n_ics=6, steps=None, seed=0, noise=0.01):
    """(n_ics, steps, 2) trajectories of the task's system, spaced by the
    task's cached-data dt, with Gaussian noise."""
    steps = STEPS[task] if steps is None else steps
    sys_ = SYSTEMS[task]
    x0 = sys_.sample_ics(jax.random.PRNGKey(seed), n_ics)
    x, _ = solve_ode_batch(sys_.f, x0, dt=jax_datasets.ode_dt_dict[task], num_steps=steps)
    x = np.asarray(jnp.transpose(x, (1, 0, 2)))
    rng = np.random.default_rng(seed)
    return (x + noise * rng.standard_normal(x.shape)).astype(np.float32)


def _configs(name):
    task, kw, gamma, thr = CASES[name]
    cfg, _ = sindy.make_config(2, poly_order=2, threshold=thr, **kw)
    jcfg, _ = jsindy.make_config(2, poly_order=2, threshold=thr, **kw)
    return task, cfg, jcfg, gamma, thr


def _mats(w, dt):
    t = np.arange(w, dtype=np.float32) * np.float32(dt)
    mats = wsindy.make_wsindy_matrices(torch.arange(w, dtype=torch.float32) * dt, w * dt)
    jmats = jwsindy.make_wsindy_matrices(jnp.arange(w) * dt, float(w * dt))
    np.testing.assert_array_equal(t, np.asarray(jnp.arange(w) * dt))
    return mats, jmats


@pytest.mark.parametrize("task", ["lv", "dosc", "growth"])
def test_make_wsindy_matrices_matches_jax(task):
    mats, jmats = _mats(160, jax_datasets.ode_dt_dict[task])
    _close(mats.V, jmats.V)
    _close(mats.V_drv, jmats.V_drv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wsindy_solve_step_and_solve_match_jax(name):
    task, cfg, jcfg, gamma, thr = _configs(name)
    x = _trajs(task)[2]
    w = int(0.8 * x.shape[0])
    x = x[x.shape[0] // 10:x.shape[0] // 10 + w]
    mats, jmats = _mats(x.shape[0], jax_datasets.ode_dt_dict[task])
    jst = jsindy.init_sindy(jax.random.PRNGKey(1), jcfg)
    st = sindy_state(jst, "cpu")
    for _ in range(2):
        st, resid, conv = wsindy.wsindy_solve_step(cfg, st, mats, torch.from_numpy(x), gamma, thr)
        jst, jresid, jconv = jwsindy.wsindy_solve_step(jcfg, jst, jmats, jnp.asarray(x), gamma,
                                                       thr)
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(jst.mask))
        _close(st.Xi, jst.Xi)
        _close(resid, jresid, RESID_REL)
        assert bool(conv) == bool(jconv)
    st, resid = wsindy.solve_wsindy(cfg, st, mats, torch.from_numpy(x), gamma, thr, 10)
    jst, jresid = jwsindy.solve_wsindy(jcfg, jst, jmats, jnp.asarray(x), gamma, thr, 10)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(jst.mask))
    _close(st.Xi, jst.Xi)
    _close(resid, jresid, RESID_REL)


def test_wsindy_refuses_a_constraint():
    cfg, Q = sindy.make_config(2, poly_order=2, L_list=[np.array([[0.0, 1.0], [-1.0, 0.0]])])
    st = sindy.init_sindy(torch.Generator().manual_seed(0), cfg, Q)
    mats, _ = _mats(50, 0.2)
    with pytest.raises(AssertionError, match="constraint"):
        wsindy.wsindy_solve_step(cfg, st, mats, torch.zeros((50, 2)), 0.0, 0.1)


@pytest.mark.parametrize("name", ["lv_exp", "growth_ridge"])
def test_sweep_wsindy_ref_windows_match_jax(name, monkeypatch):
    """The JAX sweep's own ``ref`` windows, read off the arguments of the
    jitted solve it launches, equal the port's for seeds 0-49; the two
    sweeps agree on them."""
    task, cfg, jcfg, gamma, thr = _configs(name)
    x = _trajs(task, n_ics=5, seed=3, noise=0.01)
    dt = jax_datasets.ode_dt_dict[task]
    seeds = list(range(50))
    launched = []
    real_jit = jax.jit

    def spy_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)

        def call(*args):
            launched.append([np.asarray(v) for v in args if hasattr(v, "shape")])
            return jitted(*args)
        return call

    monkeypatch.setattr(jax, "jit", spy_jit)
    want = jax_sweep_wsindy(jcfg, jnp.asarray(x), dt, jax_truth[task], np.asarray(seeds),
                            w_sindy_reg=gamma, threshold=thr, subsample_rng="ref")
    monkeypatch.setattr(jax, "jit", real_jit)
    jax_windows = [v for args in launched for v in args if v.shape == (len(seeds), 2)]
    assert len(jax_windows) == 1
    win = wsindy_windows(seeds, 5, x.shape[1], int(0.8 * x.shape[1]), "ref")
    np.testing.assert_array_equal(win, jax_windows[0])
    got = sweep_wsindy(cfg, x, dt, jax_truth[task], seeds, w_sindy_reg=gamma, threshold=thr,
                       subsample_rng="ref", device="cpu")
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    np.testing.assert_array_equal(got.correct_form, np.asarray(want.correct_form))
    np.testing.assert_allclose(got.Xi, np.asarray(want.Xi), rtol=0, atol=SWEEP_ATOL)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dump_jax_draws", os.path.join(REPO, "tools", "dump_jax_draws.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_dataset(monkeypatch, x, dx):
    """The JAX CLIs' get_dataset, returning (x, dx) (n_ics, steps, dim)."""
    def get_dataset(args):
        args["input_dim"] = x.shape[-1]
        ds = types.SimpleNamespace(trajs_x=jnp.asarray(x), x=jnp.asarray(x.reshape(-1, 2)),
                                   dx=jnp.asarray(dx.reshape(-1, 2)))
        return ds, None, args
    monkeypatch.setattr(jax_datasets, "get_dataset", get_dataset)


def _read_evals(root, save_dir, seeds):
    out = []
    for s in seeds:
        with np.load(os.path.join(root, save_dir, f"seed{s}.npz")) as z:
            assert set(z.files) == EVAL_KEYS
            out.append({k: np.asarray(z[k]) for k in z.files})
    return out


def _assert_same_evals(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["correct_form"], w["correct_form"])
        assert bool(g["correct_form_all"]) == bool(w["correct_form_all"])
        np.testing.assert_array_equal(g["coefficients"] != 0, w["coefficients"] != 0)
        np.testing.assert_allclose(g["coefficients"], w["coefficients"], rtol=0,
                                   atol=SWEEP_ATOL)


@pytest.mark.parametrize("argv_extra", [["--subsample_rng", "ref"], ["--seed", "3"]],
                         ids=["ref_windows", "jax_draws_file"])
def test_main_wsindy_matches_jax_cli(argv_extra, tmp_path, monkeypatch):
    """The port's CLI on the CPU against the JAX CLI on the same
    trajectories: with --subsample_rng ref both recompute the reference's
    windows; otherwise the JAX CLI draws its own and the port reads them
    from tools/dump_jax_draws.py's file (--subsample_perms)."""
    x = _trajs("lv", n_ics=5, seed=4, noise=0.02)
    dx = np.zeros_like(x)
    base = ["--config", "lv/noise99_eq_wsindy.cfg", "--n_seeds", "6"] + argv_extra
    monkeypatch.chdir(REPO)  # the JAX parser resolves run_configs/ from here
    jargs = vars(jget_args(base))
    seeds = list(range(jargs["seed"], jargs["seed"] + 6))
    extra = []
    if "--subsample_rng" not in argv_extra:
        tool = _tool()
        start, traj = tool.wsindy_draws(x.shape[0], x.shape[1], seeds)
        tool.check_wsindy_draws(dict(jargs, input_dim=2), x, seeds, start, traj)
        np.savez(tmp_path / "draws.npz", seeds=np.asarray(seeds, np.int32), start=start,
                 traj=traj, branch=np.asarray("wsindy"))
        extra = ["--subsample_perms", str(tmp_path / "draws.npz")]
    args = vars(get_args(base + extra + ["--eval_root", str(tmp_path / "port"),
                                         "--save_root", str(tmp_path / "ckpt")]))
    out = main_wsindy.run(args, train_data=(x, dx), device="cpu")
    _fake_dataset(monkeypatch, x, dx)
    monkeypatch.chdir(tmp_path)
    jax_main_wsindy.run(jargs)
    got = _read_evals(tmp_path / "port", args["save_dir"], seeds)
    want = _read_evals(tmp_path / "eval_results", args["save_dir"], seeds)
    _assert_same_evals(got, want)
    assert [r["correct_form_all"] for r in out["results"]] == [
        w["correct_form_all"] for w in want]
    with np.load(tmp_path / "ckpt" / args["save_dir"] / "regressor.npz") as z:
        assert set(z.files) == {"Xi", "mask"}
        np.testing.assert_array_equal(z["mask"], out["mask"][0])


def test_main_sindy_matches_jax_cli(tmp_path, monkeypatch):
    """STLSQ through both CLIs on dosc-like rows: the JAX CLI's own rows
    (its per-seed permutation of all rows) against the port's rows in its
    own order; the full-row solve does not depend on the order beyond
    rounding."""
    x = _trajs("dosc", n_ics=4, steps=60, seed=5, noise=0.0)
    rng = np.random.default_rng(5)
    cfg, _ = sindy.make_config(2, poly_order=2)
    dx = (cfg.library(torch.from_numpy(x.reshape(-1, 2))).numpy() @ jax_truth["dosc"].T
          + 0.02 * rng.standard_normal((x.shape[0] * x.shape[1], 2))).astype(np.float32)
    dx = dx.reshape(x.shape)
    base = ["--config", "dosc/noise20_sindy.cfg", "--n_seeds", "3", "--seed", "0"]
    monkeypatch.chdir(REPO)
    args = vars(get_args(base + ["--eval_root", str(tmp_path / "port"),
                                 "--save_root", str(tmp_path / "ckpt")]))
    out = main_sindy.run(args, train_data=(x, dx), device="cpu")
    jargs = vars(jget_args(base))
    _fake_dataset(monkeypatch, x, dx)
    monkeypatch.chdir(tmp_path)
    jax_main_sindy.run(jargs)
    seeds = [0, 1, 2]
    got = _read_evals(tmp_path / "port", args["save_dir"], seeds)
    want = _read_evals(tmp_path / "eval_results", args["save_dir"], seeds)
    _assert_same_evals(got, want)
    assert all(r["correct_form_all"] for r in out["results"])
    assert (tmp_path / "ckpt" / args["save_dir"] / "regressor.npz").exists()


def test_sweep_wsindy_refuses_windows_outside_the_data():
    cfg, _ = sindy.make_config(2, poly_order=2)
    x = np.zeros((3, 50, 2), np.float32)
    for bad in ([[11, 0]], [[0, 3]], [[-1, 0]]):
        with pytest.raises(ValueError, match="outside"):
            sweep_wsindy(cfg, x, 0.2, jax_truth["dosc"], [0], windows=np.asarray(bad),
                         device="cpu")
