"""The port's reaction-diffusion data (data/rd_solver.py, the rd part of
data/datasets.py), its .pt cache reader and data/gen.py CLI, and the tracked
rd checkpoint's reconstruction floor, against the JAX package's on the CPU.

Tolerances:
- simulate_rd against the JAX solver (both float32; XLA's pocketfft and
  torch's CPU FFT sum in other orders, and the initial condition's
  tanh/cos/sin round differently): uf and duf within 1e-5 of the field's
  largest magnitude at n 32, T 2, dt 0.1 and at the full n 100, T 10 (both
  measured under 2.3e-6); t, x and y equal;
- the splits and windows (the 1e-6 jitter is numpy's, drawn alike): equal
  bit for bit given the same uf and duf;
- the tracked laligan-rd-nonjoint-s42 autoencoder's floor on the port's
  data within 1e-5 relative of the JAX package's on its own data, and
  within 1% of eval_results/rd-aefloor-ours-laligan-rd-nonjoint-s42's
  train_pow and val_pow.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from symmetry_ode_discovery_tpu.data import datasets as jds
from symmetry_ode_discovery_tpu.data.rd_solver import simulate_rd as jax_simulate_rd

from symmetry_ode_discovery_tpu_torch.cli import main as cli_main
from symmetry_ode_discovery_tpu_torch.data import datasets as ds
from symmetry_ode_discovery_tpu_torch.data.rd_solver import generate_rd_mat, simulate_rd
from symmetry_ode_discovery_tpu_torch.evaluation.rd_floor import ae_floor, floor_metrics
from symmetry_ode_discovery_tpu_torch.utils import checkpoint as ckpt
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's CPU work on a few threads, set before the module's data
    fixtures: the suite runs several workers on one machine, and torch's
    FFT and products with a thread per core stall when other workers hold
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_rd():
    """The full-size data of both solvers: {"jax": (t, x, y, uf, duf),
    "port": ...} with numpy arrays."""
    port = simulate_rd(device="cpu")
    return {"jax": jax_simulate_rd(),
            "port": port[:3] + tuple(a.numpy() for a in port[3:])}


def _mat(t, x, y, uf, duf):
    return {"t": t.reshape(-1, 1), "x": x.reshape(-1, 1), "y": y.reshape(-1, 1),
            "uf": uf, "duf": duf}


def _field_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_simulate_rd_matches_jax_small():
    kw = dict(n=32, T=2.0, dt=0.1)
    tj, xj, yj, uj, dj = jax_simulate_rd(**kw)
    t, x, y, uf, duf = simulate_rd(device="cpu", **kw)
    assert uf.dtype == duf.dtype == torch.float32 and uf.shape == (32, 32, 21)
    for a, b in ((t, tj), (x, xj), (y, yj)):
        np.testing.assert_array_equal(a, b)
    assert _field_rel(uf.numpy(), uj) <= FIELD_REL
    assert _field_rel(duf.numpy(), dj) <= FIELD_REL


def test_simulate_rd_matches_jax_full(full_rd):
    tj, xj, yj, uj, dj = full_rd["jax"]
    t, x, y, uf, duf = full_rd["port"]
    assert uf.shape == duf.shape == (100, 100, 201) and uf.dtype == np.float32
    np.testing.assert_array_equal(t, tj)
    assert _field_rel(uf, uj) <= FIELD_REL
    assert _field_rel(duf, dj) <= FIELD_REL
    # the last snapshot too: no growth of the gap over the 804 RK4 steps
    assert _field_rel(uf[..., -1], uj[..., -1]) <= FIELD_REL


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_rd_splits_and_windows_bit_equal(full_rd, mode):
    data = _mat(*full_rd["jax"])
    want = jds.ReactionDiffusionDataset(data, mode)
    got = ds.ReactionDiffusionDataset(data, mode, device="cpu")
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.dx.numpy(), np.asarray(want.dx))
    np.testing.assert_array_equal(got.t, want.t)
    wwin = jds.MultiTimestepReactionDiffusionDataset(data, mode)
    gwin = ds.MultiTimestepReactionDiffusionDataset(data, mode, device="cpu")
    np.testing.assert_array_equal(gwin.x.numpy(), np.asarray(wwin.x))
    np.testing.assert_array_equal(gwin.dx.numpy(), np.asarray(wwin.dx))
    n_win = {"train": 158, "val": 18, "test": 19}[mode]
    assert gwin.x.shape == (n_win, 2, 10000) and len(gwin) == n_win
    np.testing.assert_array_equal(ds._rd_split(201, mode), jds._rd_split(201, mode))


def test_mat_round_trip_and_get_dataset_dispatch(tmp_path, monkeypatch):
    """generate_rd_mat writes what simulate_rd gives; with no .mat under
    the data path, get_dataset simulates it there (n 100) and dispatches rd
    and mt_rd as the JAX package's get_dataset on the same file."""
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(tmp_path))
    small = tmp_path / "small.mat"
    generate_rd_mat(str(small), n=8, T=1.0, device="cpu")
    z = sio.loadmat(str(small))
    t, x, y, uf, duf = simulate_rd(n=8, T=1.0, device="cpu")
    np.testing.assert_array_equal(z["uf"], uf.numpy())
    np.testing.assert_array_equal(z["duf"], duf.numpy())
    np.testing.assert_array_equal(z["t"].ravel(), t)
    assert z["x"].shape == (8, 1) and z["uf"].dtype == np.float32

    out = {}
    for task in ("rd", "mt_rd"):
        args = dict(vars(get_args(["--config", "rd/sym.cfg"])), task=task)
        train, val, args = ds.get_dataset(args, "cpu", with_val=True)
        out[task] = (train, val, args)
        assert args["input_dim"] == 10000
    assert os.path.exists(tmp_path / "reaction_diffusion.mat")
    assert out["rd"][2]["flatten"] is False and out["mt_rd"][2]["mt_data"] is True
    assert out["rd"][0].x.shape == (160, 10000) and out["rd"][1].x.shape == (20, 10000)
    monkeypatch.setattr(jds, "DATA_PATH", str(tmp_path))
    jtrain, jval, jargs = jds.get_dataset(dict(task="mt_rd"))
    np.testing.assert_array_equal(out["mt_rd"][0].x.numpy(), np.asarray(jtrain.x))
    np.testing.assert_array_equal(out["mt_rd"][1].dx.numpy(), np.asarray(jval.dx))


def test_pt_cache_reader(tmp_path):
    """The .npy pair first, else the reference's .pt pair (read with
    weights_only), else generation; a .pt that is not a tensor is not
    read."""
    stem = tmp_path / ds._cache_stem("dosc", "train", 0.2, "gp")
    x = torch.randn(3, 5, 2)
    dx = torch.randn(3, 5, 2)
    torch.save(x, f"{stem}-x.pt")
    torch.save(dx, f"{stem}-dx.pt")
    gx, gdx = ds.load_or_generate("dosc", "train", 0.2, "gp", path=str(tmp_path), device="cpu")
    assert torch.equal(gx, x) and torch.equal(gdx, dx)
    # the JAX package's reader gives the same arrays
    jx, jdx = jds._load_pt_cache(str(stem))
    np.testing.assert_array_equal(jx, x.numpy())
    # an .npy pair takes precedence
    np.save(f"{stem}-x.npy", np.zeros((1, 2, 2), np.float32))
    np.save(f"{stem}-dx.npy", np.ones((1, 2, 2), np.float32))
    gx, _ = ds.load_or_generate("dosc", "train", 0.2, "gp", path=str(tmp_path), device="cpu")
    assert gx.shape == (1, 2, 2)
    # a pickle of something else is refused and read as absent
    torch.save({"x": x}, f"{stem}-x.pt")
    assert ds._load_pt_cache(str(stem)) is None


def test_gen_cli_writes_what_load_or_generate_regenerates(tmp_path):
    gen_dir, miss_dir = tmp_path / "gen", tmp_path / "miss"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    subprocess.run([sys.executable, "-m", "symmetry_ode_discovery_tpu_torch.data.gen",
                    "--system", "dosc", "--noise", "0.2", "--modes", "train", "val",
                    "--n_ics", "6", "--save_dir", str(gen_dir), "--torch", "--device", "cpu"],
                   check=True, env=env, cwd=REPO, capture_output=True, timeout=600)
    for mode, n_ics in (("train", 6), ("val", None)):
        stem = ds._cache_stem("dosc", mode, 0.2, None)
        x = np.load(gen_dir / f"{stem}-x.npy")
        gx, gdx = ds.load_or_generate("dosc", mode, 0.2, None, path=str(miss_dir), n_ics=n_ics,
                                      device="cpu")
        np.testing.assert_array_equal(x, gx.numpy())
        np.testing.assert_array_equal(np.load(gen_dir / f"{stem}-dx.npy"), gdx.numpy())
        assert torch.equal(torch.load(gen_dir / f"{stem}-x.pt", weights_only=True), gx)


def test_tracked_rd_checkpoint_floor(full_rd):
    """The tracked non-joint rd checkpoint on the port's CPU data: its floor
    within 1e-5 relative of the JAX package's on the JAX solver's data, and
    within 1% of the recorded floor.npz."""
    from symmetry_ode_discovery_tpu.cli.main import build_models as jbuild
    from symmetry_ode_discovery_tpu.models import lie_generator as jlg
    from symmetry_ode_discovery_tpu.utils import checkpoint as jckpt
    from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

    from symmetry_ode_discovery_tpu_torch.cli.main import build_models
    from symmetry_ode_discovery_tpu_torch.evaluation.rd_floor import rd_snapshots

    name = "laligan-rd-nonjoint-s42"
    args = vars(get_args(["--config", "rd/sym.cfg"]))
    args["input_dim"] = 10000
    ae = build_models(args)[0]
    ae.load_state_dict(ckpt.load_laligan(name, os.path.join(REPO, "saved_models"), "cpu")[0])
    got = ae_floor(ae, _mat(*full_rd["port"]), "cpu")

    jargs = vars(jget_args(["--config", "rd/sym.cfg"]))
    jargs["input_dim"] = 10000
    ae_def, spec, _ = jbuild(jargs)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    bundle = {"ae": params, "d": {}, "g": jlg.init_generator(jax.random.PRNGKey(1), spec)}
    bundle, bstats = jckpt.load_laligan(name, bundle, bstats,
                                        root=os.path.join(REPO, "saved_models"))
    xs, tr, va = rd_snapshots(_mat(*full_rd["jax"]))
    zj = ae_def.encode(bundle["ae"], bstats, jnp.asarray(xs), train=False)[0]
    xhat = np.asarray(ae_def.decode(bundle["ae"], zj))
    want = {}
    for split, idx in (("train", tr), ("val", va)):
        want[f"{split}_rel"], want[f"{split}_pow"] = floor_metrics(xhat[idx], xs[idx])
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
    with np.load(os.path.join(REPO, "eval_results", f"rd-aefloor-ours-{name}",
                              "floor.npz")) as rec:
        for k in ("train_pow", "val_pow"):
            assert abs(got[k] - float(rec[k])) <= 0.01 * float(rec[k]), (k, got[k], float(rec[k]))


def test_cli_mt_rd_joint_run_writes_regressor(tmp_path, monkeypatch, capsys):
    """rd/sym_eq.cfg through cli/main.py::run on the port's full-size rd
    data (simulated under the data path), reduced to 2 x 32 and two
    epochs: the artifacts and regressor.npz in the JAX layout, finite
    components, loss_sindy_z among them."""
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(tmp_path / "data"))
    args = vars(get_args(["--config", "rd/sym_eq.cfg", "--hidden_dim", "32", "--n_layers", "2",
                          "--num_epochs", "2", "--save_root", str(tmp_path / "out")]))
    args["log_interval"] = 1  # the parser's default: on a command line the config's 10 wins
    out = cli_main.run(args, device="cpu")
    text = capsys.readouterr().out
    assert "Epoch 1 test, loss_ae:" in text and "loss_sindy_z" in text
    hist = out["history"]
    assert len(hist) == 2 and all(np.isfinite(v) for h in hist for v in h.values())
    assert "loss_sindy_z" in hist[-1] and "loss_sindy_x" not in hist[-1]
    Xi, mask = ckpt.load_regressor(out["save_dir"])
    assert Xi.shape == mask.shape == (2, 6)
    assert torch.equal(mask, out["trainer"].sindy["mask"])
    with np.load(os.path.join(out["save_dir"], "regressor.npz")) as z:
        assert sorted(z.files) == ["['Xi']", "['mask']"]
