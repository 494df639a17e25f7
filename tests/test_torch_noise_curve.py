"""The port's noise curves (cli/noise_curve.py) against the JAX package's
tools/noise_curve.py:

- the protocol table equals the JAX tool's for every (system, method) and
  agrees with run_configs/, parsed by the port's utils/config.py;
- the stacked sweep with given draws, on the JAX package's gen_data output
  at two or three noise levels, 8 seeds and the JAX draws (idx and theta0 as
  tools/dump_jax_draws.py writes them), against the JAX package's
  sweep_sindy_lbfgs_stacked (its Pallas kernel in interpret mode), at the
  full protocols of dosc EquivSINDy-c (so(2)) and growth EquivSINDy-c
  (scaling2 and the constant): masks and forms equal per seed, coefficients
  within 1e-3 (the repo's bar);
- the stacked sweep on draws shared by the datasets and on draws of its
  own for each equals each dataset's own sweep on the same draws;
- the CLI end to end on the CPU on a small cache, one level cached and one
  generated: its npz files hold the keys, shapes and dtypes of the JAX
  package's save_eval_results, and --perms_dir draws give the stacked
  sweep's result.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.data.generate import gen_data as jax_gen_data
from symmetry_ode_discovery_tpu.data.systems import SYSTEMS as JAX_SYSTEMS
from symmetry_ode_discovery_tpu.evaluation import sindy_truth as jax_truth
from symmetry_ode_discovery_tpu.evaluation.eval_eq import save_eval_results as jax_save
from symmetry_ode_discovery_tpu.models.sindy import make_config as jax_make_config
from symmetry_ode_discovery_tpu.training.siged import LBFGSHParams as JaxHParams
from symmetry_ode_discovery_tpu.training.sweep import SweepResult as JaxSweepResult
from symmetry_ode_discovery_tpu.training.sweep import (
    sweep_sindy_lbfgs_stacked as jax_stacked)

from symmetry_ode_discovery_tpu_torch.cli import noise_curve
from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams
from symmetry_ode_discovery_tpu_torch.training.sweep import (
    _kernel_setup, sweep_sindy_lbfgs, sweep_sindy_lbfgs_stacked)
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import noise_curve as jax_tool  # noqa: E402
from tools.dump_jax_draws import sweep_draws  # noqa: E402

CFGS = {
    ("dosc", "sindy"): "dosc/noise20_sindy.cfg",
    ("dosc", "esindy"): "dosc/noise20_esindy.cfg",
    ("growth", "sindy"): "growth/noise05_sindy.cfg",
    ("growth", "esindy"): "growth/noise05_esindy.cfg",
    ("lv", "sindy"): "lv/noise99_eq_sindy_2.cfg",
    ("selkov", "sindy"): "selkov/noise20_eq_sindy.cfg",
    ("dosc", "wsindy"): "dosc/noise20_wsindy.cfg",
    ("growth", "wsindy"): "growth/noise05_wsindy.cfg",
    ("lv", "wsindy"): "lv/noise99_eq_wsindy.cfg",
    ("selkov", "wsindy"): "selkov/noise20_eq_wsindy.cfg",
}
SEEDS = np.arange(8)


@pytest.fixture(autouse=True)
def _few_threads():
    """Small tensors on a few threads: the suite runs several workers on
    one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _same_kwargs(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "L_list":
            assert len(got[k]) == len(v)
            for a, b in zip(got[k], v):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        else:
            assert got[k] == v and type(got[k]) is type(v), k


@pytest.mark.parametrize("system,method", sorted(CFGS) + [("lv", "esindy"),
                                                          ("selkov", "esindy")])
def test_protocol_matches_jax_tool_and_run_config(system, method):
    if (system, method) not in CFGS:  # no fixed-group protocol: both refuse
        for make in (noise_curve.make_protocol, jax_tool.make_protocol):
            with pytest.raises(SystemExit):
                make(system, method)
        return
    cfg_kw, hp_kw, subsample = noise_curve.make_protocol(system, method)
    j_cfg_kw, j_hp_kw, j_subsample = jax_tool.make_protocol(system, method)
    _same_kwargs(cfg_kw, j_cfg_kw)
    _same_kwargs(hp_kw, j_hp_kw)
    assert subsample == j_subsample
    assert noise_curve.ALL_LEVELS == jax_tool.ALL_LEVELS

    args = vars(get_args(["--config", CFGS[(system, method)]]))
    assert cfg_kw.get("poly_order", 2) == args["poly_order"]
    assert cfg_kw.get("include_exp", False) == args["include_exp"]
    assert float(cfg_kw["threshold"]) == float(args["threshold"])
    assert cfg_kw.get("constrain_constant", False) == args["constrain_constant"]
    assert ("L_list" in cfg_kw) == args["eq_constraint"]
    if method == "wsindy":
        assert subsample is None
        assert hp_kw["w_sindy_reg"] == args["w_sindy_reg"]
        assert float(hp_kw["threshold"]) == float(args["threshold"])
    else:
        assert subsample == args["lbfgs_subsample"]
        for k in ("num_epochs", "lr_sindy", "st_freq"):
            assert hp_kw[k] == args[k], k
        assert float(hp_kw["threshold"]) == float(args["threshold"])


def _jax_levels(system, levels, n_ics):
    """The JAX package's gen_data at each level (its own key a level),
    flattened to (N, 2) float32 numpy rows."""
    sys_ = JAX_SYSTEMS[system]
    out = []
    for i, nl in enumerate(levels):
        x, dx = jax_gen_data(sys_, jax.random.PRNGKey(10 + i), n_ics=n_ics,
                             noise=nl, multiplicative_noise=sys_.multiplicative_noise,
                             smoothing="gp")
        out.append((np.asarray(x, np.float32).reshape(-1, 2),
                    np.asarray(dx, np.float32).reshape(-1, 2)))
    return out


# system, EquivSINDy-c levels, ICs (dosc: the protocol's 50, its statistics
# need them; growth: 20 of 100)
STACKED = {"dosc": ([0.0, 0.2], 50), "growth": ([0.0, 0.05, 0.2], 20)}


@pytest.mark.parametrize("system", sorted(STACKED))
def test_stacked_sweep_on_jax_draws_matches_jax(system):
    levels, n_ics = STACKED[system]
    data = _jax_levels(system, levels, n_ics)
    cfg_kw, hp_kw, subsample = noise_curve.make_protocol(system, "esindy")
    jcfg, jQ = jax_make_config(2, **jax_tool.make_protocol(system, "esindy")[0])
    hp_common = dict(w_sindy_x=1.0, w_sindy_reg=0.0, sindy_reg_type="l1", **hp_kw)
    n = data[0][0].shape[0]
    k = int(n * subsample)
    idx, theta0 = sweep_draws(jcfg, jQ, jnp.asarray(data[0][0]), jnp.asarray(data[0][1]), k,
                              SEEDS)
    ref = jax_stacked(jcfg, jQ, [x for x, _ in data], [dx for _, dx in data],
                      jax_truth[system], JaxHParams(**hp_common), SEEDS,
                      lbfgs_subsample=subsample, interpret=True)

    cfg, Q = make_config(2, **cfg_kw)
    got = sweep_sindy_lbfgs_stacked(cfg, Q, [x for x, _ in data], [dx for _, dx in data],
                                    sindy_truth[system], LBFGSHParams(**hp_common), SEEDS,
                                    lbfgs_subsample=subsample, subsample_idx=idx,
                                    theta0=theta0, device="cpu")
    assert len(got) == len(ref) == len(levels)
    for nl, g, r in zip(levels, got, ref):
        np.testing.assert_array_equal(g.mask, np.asarray(r.mask).reshape(g.mask.shape),
                                      err_msg=f"noise {nl}")
        np.testing.assert_array_equal(g.correct_form, r.correct_form, err_msg=f"noise {nl}")
        np.testing.assert_allclose(g.Xi, r.Xi, atol=1e-3, err_msg=f"noise {nl}")
    # the curve is not flat: the data reach the sweep
    assert any(int(g.correct_form.all(1).sum()) > 0 for g in got)


def _small_dosc(noises, n_ics=10, steps=150):
    """dosc rows at a few noise levels, from numpy draws."""
    rng = np.random.default_rng(3)
    t = np.arange(steps) * 0.05
    out = []
    for nl in noises:
        r0 = rng.uniform(0.5, 2.0, (n_ics, 1))
        ph = rng.uniform(0, 2 * np.pi, (n_ics, 1))
        amp = r0 * np.exp(-0.1 * t)
        x = np.stack([amp * np.cos(t + ph), amp * np.sin(t + ph)], -1)
        dx = np.stack([-0.1 * x[..., 0] - x[..., 1], x[..., 0] - 0.1 * x[..., 1]], -1)
        x = x + nl * rng.standard_normal(x.shape)
        out.append((x.reshape(-1, 2).astype(np.float32), dx.reshape(-1, 2).astype(np.float32)))
    return out


@pytest.mark.parametrize("draws", ["shared", "per_dataset"])
def test_stacked_equals_per_dataset_sweeps_on_given_draws(draws):
    data = _small_dosc([0.0, 0.05, 0.1])
    cfg, Q = make_config(2, poly_order=2, L_list=[noise_curve.SO2], threshold=5e-2)
    hp = LBFGSHParams(num_epochs=20, lr_sindy=1.0, sindy_reg_type="none", st_freq=10,
                      threshold=5e-2)
    n, seeds = data[0][0].shape[0], [0, 1, 2, 3]
    k = n // 2
    rng = np.random.default_rng(4)
    n_params = _kernel_setup(cfg, Q, hp, "cpu")[2]
    idx = np.stack([np.stack([rng.permutation(n)[:k] for _ in seeds]) for _ in data])
    th0 = rng.standard_normal((len(data), len(seeds), n_params)).astype(np.float32)
    if draws == "shared":
        idx, th0 = idx[0], th0[0]
    stacked = sweep_sindy_lbfgs_stacked(cfg, Q, [x for x, _ in data], [dx for _, dx in data],
                                        sindy_truth["dosc"], hp, seeds, lbfgs_subsample=0.5,
                                        subsample_idx=idx, theta0=th0, device="cpu")
    for i, ((x, dx), res) in enumerate(zip(data, stacked)):
        one = sweep_sindy_lbfgs(cfg, Q, x, dx, sindy_truth["dosc"], hp, seeds,
                                lbfgs_subsample=0.5,
                                subsample_idx=idx if draws == "shared" else idx[i],
                                theta0=th0 if draws == "shared" else th0[i], device="cpu")
        np.testing.assert_array_equal(res.mask, one.mask)
        np.testing.assert_array_equal(res.correct_form, one.correct_form)
        np.testing.assert_allclose(res.Xi, one.Xi, atol=1e-6)
    if draws == "per_dataset":  # the datasets' own draws reach their lanes
        assert not np.array_equal(stacked[0].Xi, stacked[1].Xi)
    with pytest.raises(ValueError):
        sweep_sindy_lbfgs_stacked(cfg, Q, [x for x, _ in data], [dx for _, dx in data],
                                  sindy_truth["dosc"], hp, seeds, lbfgs_subsample=0.5,
                                  subsample_idx=np.zeros((2, len(seeds), k), np.int64),
                                  device="cpu")


def test_cli_writes_the_jax_schema(tmp_path, monkeypatch, capsys):
    """cli/noise_curve.py on the CPU: dosc at noise 0.05 and 0.1 from a
    small cache (10 trajectories of numpy dosc data), 0.0 generated by the
    port at the protocol's size; SINDy and EquivSINDy-c on draws files
    (tools/dump_jax_draws.py's keys: one for every level, and one for the
    generated level's row count), then WSINDy on the port's draws; npz
    files in the JAX package's schema."""
    from symmetry_ode_discovery_tpu_torch.data.datasets import load_or_generate

    data_dir, perms, ev = tmp_path / "data", tmp_path / "perms", tmp_path / "eval"
    data_dir.mkdir()
    perms.mkdir()
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(data_dir))
    for nl, (x, dx) in zip([0.05, 0.1], _small_dosc([0.05, 0.1], steps=100)):
        np.save(data_dir / f"dosc-train-noise{int(100 * nl):02d}-gp-x.npy", x.reshape(10, 100, 2))
        np.save(data_dir / f"dosc-train-noise{int(100 * nl):02d}-gp-dx.npy",
                dx.reshape(10, 100, 2))
    seeds = list(range(3))
    rng = np.random.default_rng(5)
    draws = {}
    for method in ("sindy", "esindy"):
        cfg, Q = make_config(2, **noise_curve.make_protocol("dosc", method)[0])
        n_params = _kernel_setup(cfg, Q, LBFGSHParams(), "cpu")[2]
        for tag, n in (("", 1000), ("-noise00", 5000)):  # 10 cached, 50 generated ICs
            draws[method + tag] = dict(
                seeds=np.array([7] + seeds, np.int32),
                idx=np.stack([rng.permutation(n)[:n // 2] for _ in range(4)]).astype(np.int32),
                theta0=rng.standard_normal((4, n_params)).astype(np.float32),
                branch=np.asarray("sweep"))
            np.savez(perms / f"noisecurve-dosc-{method}{tag}.npz", **draws[method + tag])
    argv = ["--system", "dosc", "--n_seeds", "3", "--levels", "0.0", "0.05", "0.1",
            "--device", "cpu", "--eval_root", str(ev), "--perms_dir", str(perms)]
    assert noise_curve.main(argv) == 0
    out, err = capsys.readouterr()
    assert "generating dosc levels [0.0]" in err
    rec = __import__("json").loads(out.strip().splitlines()[-1])
    assert rec["generated_levels"] == ["0.00"] and rec["device"] == "cpu"
    assert rec["lbfgs_sweep_launches"] == {"sindy": 0, "esindy": 0}  # the CPU runs the plain version
    # the generated level is the port's cache draw
    cached = np.load(data_dir / "dosc-train-noise00-gp-x.npy")
    assert cached.shape == (50, 100, 2)
    os.remove(data_dir / "dosc-train-noise00-gp-x.npy")
    gen = load_or_generate("dosc", "train", 0.0, "gp", device="cpu")
    np.testing.assert_array_equal(cached, gen[0].numpy())

    # the schema: the JAX package's save_eval_results of its own result
    # dicts (training/sweep.py::SweepResult) and the tracked records
    monkeypatch.chdir(tmp_path)
    for method in ("sindy", "esindy"):
        cfg_kw, hp_kw, subsample = noise_curve.make_protocol("dosc", method)
        cfg, Q = make_config(2, **cfg_kw)
        xs = [np.load(data_dir / f"dosc-train-noise{t}-gp-x.npy").reshape(-1, 2)
              for t in ("05", "10")]
        dxs = [np.load(data_dir / f"dosc-train-noise{t}-gp-dx.npy").reshape(-1, 2)
               for t in ("05", "10")]
        want = sweep_sindy_lbfgs_stacked(
            cfg, Q, xs, dxs, sindy_truth["dosc"],
            LBFGSHParams(w_sindy_x=1.0, w_sindy_reg=0.0, sindy_reg_type="l1", **hp_kw),
            seeds, lbfgs_subsample=subsample, subsample_idx=draws[method]["idx"][1:],
            theta0=draws[method]["theta0"][1:], device="cpu")
        tracked = os.path.join(REPO, "eval_results", f"noisecurve-dosc-{method}-noise05",
                               "seed0.npz")
        for nl, res in zip(("05", "10"), want):
            ref = JaxSweepResult(Xi=res.Xi, mask=res.mask, correct_form=res.correct_form,
                                 mse=res.mse).results_list()
            for s in seeds:
                jax_save(ref[s], f"ref-{method}-{nl}", s)
                with np.load(ev / f"noisecurve-dosc-{method}-noise{nl}" / f"seed{s}.npz") as z, \
                        np.load(tmp_path / "eval_results" / f"ref-{method}-{nl}"
                                / f"seed{s}.npz") as r, np.load(tracked) as t:
                    assert sorted(z.files) == sorted(r.files) == sorted(t.files)
                    for key in r.files:
                        assert z[key].shape == r[key].shape == t[key].shape, key
                        assert z[key].dtype == r[key].dtype == t[key].dtype, key
                        np.testing.assert_array_equal(z[key], r[key], err_msg=key)
            assert rec["success_by_noise"][method][f"{int(nl) / 100:.2f}"] == int(
                res.correct_form.all(1).sum())

    # the port's own draws: the files are optional
    assert noise_curve.main(argv[:-2] + ["--no_save", "--methods", "wsindy"]) == 0
    rec = __import__("json").loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert rec["generated_levels"] == [] and set(rec["success_by_noise"]) == {"wsindy"}
