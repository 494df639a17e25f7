"""Long-term-prediction evaluation against the JAX package on the CPU:
odeint's whole trajectory, eval_ltp_accuracy in both branches (plain, and
encode -> latent RK4 -> decode through a small autoencoder),
ltp_sweep_errors (the three step counts and the blow-up seed of
tests/test_ltp_sweep.py), the sweep summary of cli/eval_ltp_sweep.py on two
tracked records, and cli/eval_rd_ltp.py on the tracked laligan-sindy-rd-2
checkpoint.

The same numpy inputs go through both packages. Tolerances (both float32,
the rollouts' stages summed in other orders): 1e-4 relative at horizons of
100 steps or fewer, 1e-3 at 2,002 steps (rounding accumulates over the
horizon), non-finite in the same places; the summaries' counts equal and
medians within 1e-4 relative; the rd series' means within 1e-3 relative of
the tracked rollout.npz and its z_true within 1e-4 of the field (the port
on the JAX solver's data).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from symmetry_ode_discovery_tpu.cli import eval_ltp_sweep as jsweep
from symmetry_ode_discovery_tpu.data import datasets as jds
from symmetry_ode_discovery_tpu.data.rd_solver import simulate_rd as jax_simulate_rd
from symmetry_ode_discovery_tpu.data.systems import SYSTEMS as JSYSTEMS
from symmetry_ode_discovery_tpu.evaluation.eval_ltp import eval_ltp_accuracy as jeval_ltp
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.ops.integrators import odeint as jodeint
from symmetry_ode_discovery_tpu.ops.integrators import solve_ode_batch as jsolve

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.cli import eval_ltp_sweep, eval_rd_ltp
from symmetry_ode_discovery_tpu_torch.evaluation.eval_eq import sindy_truth
from symmetry_ode_discovery_tpu_torch.evaluation.eval_ltp import eval_ltp_accuracy
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.ops.integrators import odeint
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _dosc_trajs(seed, n_ics, dt, steps):
    """(n_ics, steps, 2) dosc trajectories from numpy initial conditions."""
    x0 = np.random.default_rng(seed).uniform(-2.0, 2.0, (n_ics, 2)).astype(np.float32)
    x, _ = jsolve(JSYSTEMS["dosc"].f, jnp.asarray(x0), dt=dt, num_steps=steps)
    return np.asarray(jnp.transpose(x, (1, 0, 2)))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_odeint_full_trajectory_matches_jax():
    cfg, cfg_j = make_config(2, poly_order=2)[0], jmake_config(2, poly_order=2)[0]
    Xi = (sindy_truth["dosc"] + np.random.default_rng(1).normal(0, 0.01, (2, 6))).astype(
        np.float32)
    x0 = np.random.default_rng(2).normal(size=(5, 2)).astype(np.float32)
    for method in ("euler", "rk4"):
        want = jodeint(lambda q: cfg_j.library(q) @ jnp.asarray(Xi).T, jnp.asarray(x0), 43 * 0.2,
                       0.2, method=method, full_traj=True, num_steps=43)
        got = odeint(lambda q: cfg.library(q) @ torch.tensor(Xi).T, torch.tensor(x0), 43 * 0.2,
                     0.2, method=method, full_traj=True, num_steps=43)
        assert got.shape == (43, 5, 2)
        assert _rel(got.numpy(), np.asarray(want)) < 1e-4
    empty = odeint(lambda q: q, torch.tensor(x0), 0.0, 0.1, full_traj=True)
    assert empty.shape == (0, 5, 2)


def _small_ae():
    kw = dict(input_dim=2, hidden_dim=16, latent_dim=2, n_layers=2, n_comps=1,
              batch_norm=True, ortho_ae=False)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(3))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    return ae_def, params, bstats, ae.eval()


@pytest.mark.parametrize("latent", [False, True], ids=["plain", "latent"])
def test_eval_ltp_accuracy_matches_jax(latent):
    x = _dosc_trajs(0, 4, 0.2, 44)
    # a perturbed field: errors well above the rounding of the data
    truth = (sindy_truth["dosc"] + np.random.default_rng(5).normal(0, 0.05, (2, 6))).astype(
        np.float32)
    cfg, cfg_j = make_config(2, poly_order=2)[0], jmake_config(2, poly_order=2)[0]
    kw_j, kw = {}, {}
    if latent:
        ae_def, params, bstats, ae = _small_ae()
        kw_j = dict(encode=lambda q: ae_def.encode(params, bstats, q, train=False)[0],
                    decode=lambda z: ae_def.decode(params, z))
        kw = dict(encode=ae.encode, decode=ae.decode)
    want = jeval_ltp(lambda q: cfg_j.library(q) @ jnp.asarray(truth).T, x, task="dosc", dt=0.2,
                     **kw_j)
    got = eval_ltp_accuracy(lambda q: cfg.library(q) @ torch.tensor(truth).T, x, task="dosc",
                            dt=0.2, device="cpu", **kw)
    assert set(got) == {"x_pred", "t", "error"}
    assert got["x_pred"].shape == want["x_pred"].shape == (4, 43, 2)
    np.testing.assert_array_equal(got["t"], want["t"])
    assert _rel(got["x_pred"], want["x_pred"]) < 1e-4
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-4,
                               atol=1e-4 * float(np.max(want["error"])))


@pytest.mark.parametrize("dt,steps", [(0.2, 44), (0.02, 60), (0.002, 2002)],
                         ids=["dt0.2", "dt0.02", "dt0.002"])
def test_ltp_sweep_errors_step_counts(dt, steps):
    """The explicit step count (int((n - 1) dt / dt) truncates for many
    pairs), truth and a spoiled matrix, against the JAX package."""
    x = _dosc_trajs(1, 2, dt, steps)
    truth = sindy_truth["dosc"]
    spoiled = truth.copy()
    spoiled[0, 2] = -truth[0, 2]
    perturbed = truth + np.random.default_rng(6).normal(0, 0.02, truth.shape)
    coefs = np.stack([truth, spoiled, perturbed]).astype(np.float32)
    want = np.asarray(jsweep.ltp_sweep_errors(jmake_config(2, poly_order=2)[0], coefs, x, dt))
    got = eval_ltp_sweep.ltp_sweep_errors(make_config(2, poly_order=2)[0], coefs, x, dt,
                                          device="cpu").numpy()
    assert got.shape == want.shape == (3, 2, steps - 1)
    # the truth row is the floor: rounding of the data, in both packages
    assert got[0].max() < 1e-6 and want[0].max() < 1e-6
    tol = 1e-4 if steps <= 101 else 1e-3
    for s in (1, 2):  # each row against its own scale
        assert _rel(got[s], want[s]) < tol, (s, _rel(got[s], want[s]))


def test_ltp_sweep_blowup_stays_in_its_row():
    """A diverging seed goes non-finite in the same places as the JAX
    package's, and only in its own row."""
    cfg, cfg_j = (m(2, poly_order=2, include_exp=True)[0] for m in (make_config, jmake_config))
    p = cfg.n_terms
    blowup = np.zeros((2, p), np.float32)
    blowup[:, -2:] = 5.0
    tame = np.zeros((2, p), np.float32)
    tame[0, 2], tame[1, 1] = -1.0, 1.0
    coefs = np.stack([tame, blowup, tame])
    x = _dosc_trajs(4, 3, 0.1, 30) * 0.1
    want = np.asarray(jsweep.ltp_sweep_errors(cfg_j, coefs, x, 0.1))
    got = eval_ltp_sweep.ltp_sweep_errors(cfg, coefs, x, 0.1, device="cpu").numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isfinite(got[1]).all() and np.isfinite(got[[0, 2]]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
    summ = eval_ltp_sweep._summ(got, "all")
    assert summ["finite"] == 2 and summ["n"] == 3


@pytest.mark.parametrize("config", ["growth/noise05_esindy.cfg", "lv/noise99_eq_sindy_2.cfg"],
                         ids=["esindy-noise05-growth", "sindy2-noise99-lv"])
def test_sweep_summary_matches_jax(config, tmp_path, monkeypatch):
    """cli/eval_ltp_sweep.py's run on a tracked record: the JAX CLI reads the
    clean validation cache it generated under a scratch directory, the
    port's the same files through $SODT_TORCH_DATA_PATH."""
    monkeypatch.chdir(REPO)
    args = vars(get_args(["--config", config]))
    jds.load_or_generate(args["task"], "val", 0.0, None, path=str(tmp_path))
    monkeypatch.setattr(jds, "DATA_PATH", str(tmp_path))
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(tmp_path))
    want = jsweep.run(dict(args))
    got = eval_ltp_sweep.run(dict(args, eval_root=os.path.join(REPO, "eval_results")),
                             device="cpu")
    for key in ("all", "correct_form", "wrong_form", "truth_floor"):
        assert got[key]["n"] == want[key]["n"] and got[key]["finite"] == want[key]["finite"], key
        if key != "truth_floor" and np.isfinite(want[key]["median"]):
            np.testing.assert_allclose(got[key]["median"], want[key]["median"], rtol=1e-4)
    # the floor is the data's rounding in both: compared by its bound only
    assert got["truth_floor"]["median"] < 1e-6 and want["truth_floor"]["median"] < 1e-6


def test_sweep_summary_exits_on_library_mismatch(tmp_path):
    """The JAX CLI's exits: a run whose coefficients the config's library
    does not fit."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    np.savez(run_dir / "seed0.npz", coefficients=np.zeros((2, 5)), correct_form=np.ones(2))
    args = vars(get_args(["--config", "dosc/noise20_sindy.cfg", "--save_dir", "run",
                          "--eval_root", str(tmp_path)]))
    with pytest.raises(SystemExit, match="library mismatch"):
        eval_ltp_sweep.run(args, device="cpu", x_val=_dosc_trajs(0, 2, 0.2, 10))
    with pytest.raises(SystemExit, match="no seed npz"):
        eval_ltp_sweep.run(dict(args, save_dir="none"), device="cpu",
                           x_val=_dosc_trajs(0, 2, 0.2, 10))


@pytest.fixture(scope="module")
def rd_mat(tmp_path_factory):
    """The JAX solver's reaction_diffusion.mat in a scratch directory."""
    d = tmp_path_factory.mktemp("rd")
    t, x, y, uf, duf = jax_simulate_rd()
    sio.savemat(str(d / "reaction_diffusion.mat"),
                {"t": t.reshape(-1, 1), "x": x.reshape(-1, 1), "y": y.reshape(-1, 1),
                 "uf": uf, "duf": duf})
    return d


@pytest.mark.parametrize("split", ["val", "traintail"])
def test_rd_ltp_matches_tracked_rollout(split, rd_mat, tmp_path, monkeypatch):
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(rd_mat))
    args = vars(get_args(["--config", "rd/sym_eq.cfg", "--load_laligan", "laligan-sindy-rd-2",
                          "--rd_eval_split", split, "--eval_root", str(tmp_path)]))
    got = eval_rd_ltp.run(args, device="cpu", ckpt_root=os.path.join(REPO, "saved_models"))
    name = "rd-ltp-laligan-sindy-rd-2" + ("" if split == "val" else "-traintail")
    with np.load(os.path.join(REPO, "eval_results", name, "rollout.npz")) as z:
        want = {k: z[k] for k in z.files}
    with np.load(tmp_path / name / "rollout.npz") as z:
        assert set(z.files) == set(want)
    for k in ("rel_rollout", "rel_latent", "rel_recon", "pow_rollout", "pow_recon"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(np.mean(got[k]), np.mean(want[k]), rtol=1e-3, err_msg=k)
    assert _rel(got["z_true"], want["z_true"]) < 1e-4
    np.testing.assert_allclose(got["t"], want["t"])
    np.testing.assert_array_equal(got["Xi"], want["Xi"])
