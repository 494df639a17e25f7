"""The port's GP CLI (cli/main_gp.py run, device="cpu") against the JAX
package's sweep mode (cli/main_gp.py _run_sweep_mode) on the same rows: the
same equation files, word for word, and the same eval npz fields (equal
masks and forms; coefficients and MSE within 1e-4, the constants'
tolerance), with the fitness in f32 and, with --gp_eval_dtype bf16, in bf16
(K5's bf16 mode; its plain version here); then resume, the single-seed
branch and the refusals.

Tiny protocol: LV-like rows (4,000; pysr_subsample 0.05 gives 200 per
seed), population 32, 3 generations, 2 seeds; the EquivGP-r leg reads the
tracked checkpoint saved_models/laligan-noise99-lv.
"""

import os

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.cli import main_gp
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "saved_models")
TINY = ["--n_seeds", "2", "--pysr_bs", "32", "--gp_generations", "3",
        "--pysr_subsample", "0.05"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _data(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.2, 2.0, (n, 2)).astype(np.float32)
    dx = np.stack([2 / 3 - 4 / 3 * np.exp(x[:, 1]), np.exp(x[:, 0]) - 1], -1)
    return x, (dx + 0.05 * rng.standard_normal((n, 2))).astype(np.float32)


def _args(config, extra=()):
    return vars(get_args(["--config", config] + TINY + list(extra)))


def _jax_sweep(config, x, dx, workdir, monkeypatch, extra=()):
    """The JAX package's sweep mode in ``workdir`` (it writes
    eval_results/<save_dir> under the working directory)."""
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.cli import main_gp as jmain
    from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

    args = vars(jget_args(["--config", config] + TINY + list(extra)))
    args["input_dim"] = 2
    gx_fn = None
    if args["pysr_symmreg"]:
        import jax

        from symmetry_ode_discovery_tpu.cli.main import build_models
        from symmetry_ode_discovery_tpu.models import lie_generator as jlg
        from symmetry_ode_discovery_tpu.training.symmreg import make_precompute_symmreg_r
        from symmetry_ode_discovery_tpu.utils import checkpoint as ckpt

        ae_def, gspec, _ = build_models(args)
        k = jax.random.PRNGKey(0)
        params, bstats = ae_def.init(k)
        bundle = {"ae": params, "d": {}, "g": jlg.init_generator(k, gspec)}
        bundle, bstats = ckpt.load_laligan(args["load_laligan"], bundle, bstats, root=CKPT)
        pre = make_precompute_symmreg_r(ae_def, bundle["ae"], bstats, gspec, bundle["g"])
        gx_fn = lambda xx: pre(jnp.asarray(xx))
    save_dir = os.path.join(workdir, "eqs")
    os.makedirs(save_dir)
    monkeypatch.chdir(workdir)
    jmain._run_sweep_mode(args, x, dx, int(len(x) * args["pysr_subsample"]),
                          jmain._task_spec("lv", 2), gx_fn, save_dir, args["seed"],
                          args["n_seeds"])
    return save_dir, os.path.join(workdir, "eval_results", args["save_dir"])


@pytest.mark.parametrize("config", ["lv/noise99_eq_gp.cfg", "lv/noise99_eq_gp_symm.cfg"],
                         ids=["plain", "equivgp_r"])
def test_cli_sweep_matches_jax(config, tmp_path, monkeypatch):
    _sweep_matches_jax(config, [], tmp_path, monkeypatch)


@pytest.mark.parametrize("config", ["lv/noise99_eq_gp.cfg", "lv/noise99_eq_gp_symm.cfg"],
                         ids=["plain", "equivgp_r"])
def test_cli_sweep_bf16_matches_jax(config, tmp_path, monkeypatch):
    """--gp_eval_dtype bf16 through both CLIs: the bf16 fitness of the
    port's plain K5 against the reference's bf16 fitness."""
    _sweep_matches_jax(config, ["--gp_eval_dtype", "bf16"], tmp_path, monkeypatch)


def _sweep_matches_jax(config, flags, tmp_path, monkeypatch):
    x, dx = _data()
    args = _args(config, flags + ["--eval_root", str(tmp_path / "port")])
    out = main_gp.run(args, train_data=(x, dx), device="cpu", ckpt_root=CKPT)
    port_dir = tmp_path / "port" / args["save_dir"]
    jax_eqs, jax_npz = _jax_sweep(config, x, dx, tmp_path / "jax", monkeypatch, flags)
    name = "equation_seed{}.txt" if args["pysr_symmreg"] else "equations_seed{}.txt"
    for i, s in enumerate((42, 43)):
        got = (port_dir / name.format(s)).read_text()
        assert got == open(os.path.join(jax_eqs, name.format(s))).read()
        assert out["equations"][i] == got.splitlines()
        with np.load(port_dir / f"seed{s}.npz") as zt, \
                np.load(os.path.join(jax_npz, f"seed{s}.npz")) as zj:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                if zj[k].dtype.kind == "f":
                    np.testing.assert_allclose(zt[k], zj[k], rtol=1e-4, atol=1e-4)
                else:
                    np.testing.assert_array_equal(zt[k], zj[k])
        assert out["correct_form"][s] == list(np.load(port_dir / f"seed{s}.npz")["correct_form"])
    (chunk,) = out["chunks"]
    assert chunk["seeds"] == [42, 43] and len(chunk["device_s"]) == 3
    assert np.isfinite(chunk["best_fit"]).all()


def test_cli_resume_skips_done_seeds(tmp_path):
    x, dx = _data(seed=1)
    args = _args("lv/noise99_eq_gp.cfg", ["--eval_root", str(tmp_path), "--n_seeds", "3"])
    first = main_gp.run(dict(args, n_seeds=2), train_data=(x, dx), device="cpu")
    out_dir = tmp_path / args["save_dir"]
    stamp = os.path.getmtime(out_dir / "seed42.npz")
    again = main_gp.run(dict(args), train_data=(x, dx), device="cpu")
    assert [c["seeds"] for c in again["chunks"]] == [[44]]
    assert again["equations"][:2] == first["equations"]
    assert os.path.getmtime(out_dir / "seed42.npz") == stamp
    assert (out_dir / "seed44.npz").exists()
    redo = main_gp.run(dict(args, overwrite_eval=True, n_seeds=2), train_data=(x, dx),
                       device="cpu")
    assert [c["seeds"] for c in redo["chunks"]] == [[42, 43]]
    assert redo["equations"] == first["equations"]


def test_cli_single_seed_writes_its_equations(tmp_path):
    x, dx = _data(seed=2)
    args = _args("lv/noise99_eq_gp.cfg", ["--eval_root", str(tmp_path), "--n_seeds", "1",
                                          "--gp_generations", "2"])
    out = main_gp.run(args, train_data=(x[:1000], dx[:1000]), device="cpu")
    (eqs,) = out["equations"]
    assert (tmp_path / args["save_dir"] / "equations_seed42.txt").read_text() == "\n".join(eqs)
    assert len(eqs) == 2 and "<invalid>" not in eqs


@pytest.mark.parametrize("flags, match", [(["--mesh_devices", "4"],
                                            "4-device mesh but only 0 CUDA devices")])
def test_cli_refuses_unported_options(flags, match, tmp_path):
    """A mesh of more CUDA devices than exist raises before anything is
    written (parallel/mesh.py::make_mesh)."""
    x, dx = _data(n=100)
    args = _args("lv/noise99_eq_gp.cfg", flags + ["--eval_root", str(tmp_path)])
    with pytest.raises(ValueError, match=match):
        main_gp.run(args, train_data=(x, dx), device="cpu")
    assert not any(tmp_path.iterdir())


def test_mt_task_runs_as_the_jax_cli(tmp_path, monkeypatch):
    """An mt_ task (--task mt_lv --mt_data), as the JAX package's CLI runs
    it: the windows' dataset keeps the flattened rows as x, which both CLIs
    fit with the search space of a task other than lv (no exp). A single
    seed writes the same equations; a sweep writes its first seed's
    equations, then raises KeyError('mt_lv') at that seed's scoring (no
    ground truth for the task) in both."""
    import symmetry_ode_discovery_tpu.data.datasets as jds
    from symmetry_ode_discovery_tpu.cli import main_gp as jmain
    from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

    x, dx = _data(n=1200, seed=4)
    data = tmp_path / "data"
    data.mkdir()
    for split in ("train", "val"):
        np.save(data / f"lv-{split}-noise99-gp-x.npy", x.reshape(4, 300, 2))
        np.save(data / f"lv-{split}-noise99-gp-dx.npy", dx.reshape(4, 300, 2))
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(data))
    monkeypatch.setattr(jds, "DATA_PATH", str(data))
    (tmp_path / "jax").mkdir()
    # the JAX CLI reads run_configs/ and writes saved_models/ under the
    # working directory
    os.symlink(os.path.join(REPO, "run_configs"), tmp_path / "jax" / "run_configs")
    monkeypatch.chdir(tmp_path / "jax")
    flags = ["--config", "lv/noise99_eq_gp.cfg"] + TINY + ["--task", "mt_lv", "--mt_data"]
    one = ["--n_seeds", "1", "--gp_generations", "2"]
    got = main_gp.run(vars(get_args(flags + one + ["--eval_root", str(tmp_path / "port")])),
                      device="cpu")
    want = jmain.run(vars(jget_args(flags + one)))
    assert got["equations"] == want["equations"]
    assert "exp" not in "".join(got["equations"][0])
    port_dir = tmp_path / "port" / "gp-noise99-lv"
    jax_dir = tmp_path / "jax" / "saved_models" / "gp-noise99-lv"
    for run, argv in ((lambda a: main_gp.run(a, device="cpu"),
                       flags + ["--eval_root", str(tmp_path / "port")]),
                      (jmain.run, flags)):
        get = get_args if run is not jmain.run else jget_args
        with pytest.raises(KeyError, match="mt_lv"):
            run(vars(get(argv)))
    assert (port_dir / "equations_seed42.txt").read_text() == \
        (jax_dir / "equations_seed42.txt").read_text()
    assert not (port_dir / "equations_seed43.txt").exists()
    assert not (jax_dir / "equations_seed43.txt").exists()
