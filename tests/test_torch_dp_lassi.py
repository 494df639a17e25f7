"""Data-parallel LaLiGAN training (training/lassi.py with parallel/dp.py)
on 2 and 4 gloo ranks on the CPU, against the port's single-device trainer
and the JAX trainer under ``dp_mesh=make_mesh(8, axis="batch")`` (the eight
virtual CPU devices of tests/conftest.py), on the same init and draws.

The set-up is tests/test_dp_lassi.py's (hidden width 32, 2 layers, batch
128, the rotation windows of tests/test_lassi.py, 3 epochs, thresholding
every 2), run through the port's replay of a JAX record
(cli/replay_lassi.py, ``replay_dp`` for the ranks), and so are the bars:
- each epoch's mean components within rtol 5e-3 and atol 1e-5;
- the autoencoder's parameters and its BatchNorm running statistics within
  relative L2 0.02 (over all the tensors at once);
- the joint least-squares path: the SINDy mask equal, loss_sindy_z within
  rtol 5e-2;
- one joint step in float64 within 1e-10 of the JAX trainer's float64 step.
Each rank runs in a process of its own (spawned: a few seconds each).
"""

import jax
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli.main import build_models as jbuild_models
from symmetry_ode_discovery_tpu.parallel.mesh import make_mesh as jmake_mesh
from symmetry_ode_discovery_tpu.training.lassi import LassiTrainer as JaxLassiTrainer
from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

from symmetry_ode_discovery_tpu_torch.cli import main as cli_main
from symmetry_ode_discovery_tpu_torch.cli.replay_lassi import replay, replay_dp
from symmetry_ode_discovery_tpu_torch.utils.checkpoint import flatten
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

from test_lassi import _mt_data
from test_torch_lassi import DUMP

FLAGS = ["--hidden_dim", "32", "--n_layers", "2", "--batch_size", "128", "--gan_st_freq", "2",
         "--gan_st_thres", "0.1"]
JOINT = ["--include_sindy", "--eq_constraint", "--w_sindy_x", "0", "--w_sindy_z", "1e-3"]
EPOCHS = 3


def _record(flags, epochs=EPOCHS, n_batches=0, f64=False):
    """tools/dump_jax_draws.py's LaLiGAN record of the JAX trainer on the
    rotation windows (dx = x, as test_dp_lassi.py), whose epoch means and
    final state are then replaced by the JAX trainer's under a batch mesh
    of 8 devices on the same init and draws."""
    args = vars(jget_args(["--config", "lv/noise99_sym.cfg"] + flags))
    args["input_dim"] = 2
    x = np.asarray(_mt_data())
    joint = "--include_sindy" in flags
    rec = DUMP.lassi_record(args, x, n_batches, epochs, flags, x if joint else None, f64=f64)
    assert rec["bit_equal"].all()
    ae_def, spec, disc = jbuild_models(args)
    n = len(rec["x"])
    tr = JaxLassiTrainer(ae_def, spec, disc, DUMP.lassi_hparams(args, epochs),
                         steps_per_epoch=n // args["batch_size"],
                         dp_mesh=jmake_mesh(8, axis="batch"))
    key = jax.random.PRNGKey(args["seed"])
    key, kinit = jax.random.split(key)
    bundle, bstats, opt, sc = tr.init(kinit, rec["x"])
    xj = jax.numpy.asarray(rec["x"])
    for e in range(epochs):
        key, sub = jax.random.split(key)
        bundle, bstats, opt, sc, m = tr.epoch(bundle, bstats, opt, sc, xj, xj, sub)
        bundle, bstats, opt, sc = DUMP._lassi_after_epoch(tr, e, bundle, bstats, opt, sc)
        for k, v in m.items():
            rec[f"epoch/{k}"][e] = float(v)
    rec = {k: v for k, v in rec.items() if not k.startswith("final/")}
    rec.update({f"final/{k}": v for k, v in flatten(DUMP.lassi_tree(bundle, bstats, sc)).items()})
    return rec


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    paths = {}
    for name, flags in (("plain", FLAGS), ("joint", FLAGS + JOINT)):
        paths[name] = str(root / f"{name}.npz")
        np.savez(paths[name], **_record(flags))
    return paths


def _assert_epochs_close(got, want):
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("ranks", [2, 4])
def test_dp_epochs_match_single_device_and_jax_dp(records, ranks):
    one = replay(records["plain"], "cpu")
    dp = replay_dp(records["plain"], ["cpu"] * ranks)
    assert dp["dp_devices"] == ["cpu"] * ranks and dp["all_reduces"] > 0
    _assert_epochs_close(dp["epoch_means"], one["epoch_means"])
    with np.load(records["plain"]) as z:
        jax_means = [{k: float(z[f"epoch/{k}"][e]) for k in dp["epoch_means"][0]}
                     for e in range(EPOCHS)]
    _assert_epochs_close(dp["epoch_means"], jax_means)
    # against the JAX dp_mesh run's final state, as against the single device's
    for out in (dp, one):
        assert out["final_rel"]["ae_global"] < 0.02
        assert out["final_rel"]["bn_stats_global"] < 0.02
        assert out["final_rel"]["masks_equal"]


@pytest.mark.parametrize("ranks", [2, 4])
def test_dp_joint_lstsq_matches_single_device_and_jax_dp(records, ranks):
    one = replay(records["joint"], "cpu")
    dp = replay_dp(records["joint"], ["cpu"] * ranks)
    with np.load(records["joint"]) as z:
        jax_sz = z["epoch/loss_sindy_z"]
    for e in range(EPOCHS):
        got = dp["epoch_means"][e]["loss_sindy_z"]
        assert np.isfinite(got)
        np.testing.assert_allclose(got, one["epoch_means"][e]["loss_sindy_z"], rtol=5e-2,
                                   atol=1e-4)
        np.testing.assert_allclose(got, jax_sz[e], rtol=5e-2, atol=1e-4)
    assert dp["sindy_final"]["mask_equal"]  # against the JAX dp_mesh run's
    assert dp["sindy_final"]["mask"] == one["sindy_final"]["mask"]


def test_dp_joint_step_float64_matches_jax(tmp_path):
    """One joint batch in float64: the components of the port's 2-rank step
    against the JAX trainer's float64 step on the same init and draws."""
    path = str(tmp_path / "one.npz")
    rec = DUMP.lassi_record(vars(jget_args(["--config", "lv/noise99_sym.cfg"] + FLAGS + JOINT)
                                 ) | {"input_dim": 2},
                            np.asarray(_mt_data()), 1, 1, FLAGS + JOINT,
                            np.asarray(_mt_data()), f64=True)
    np.savez(path, **rec)
    for out in (replay_dp(path, ["cpu", "cpu"], dtype=torch.float64),
                replay(path, "cpu", torch.float64)):
        assert out["batch0_max_rel"] <= 1e-10, out["batch0"]


def test_dp_cli_trains_writes_rank_0s_artifacts(tmp_path):
    """cli/main.py's data-parallel LaLiGAN branch through run_lassi_dp (the
    launcher --dp_devices calls with the first N CUDA devices), 2 gloo
    ranks: the same history as the single-device CLI from the same seed,
    the artifacts written once, by rank 0."""
    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data

    x, dx = gen_data(SYSTEMS["lv"], torch.Generator().manual_seed(0), n_ics=2, num_steps=700,
                     subsample_rate=10, device="cpu")
    flags = ["--config", "lv/noise99_sym.cfg", "--hidden_dim", "16", "--n_layers", "2",
             "--batch_size", "64", "--num_epochs", "2", "--save_interval", "0"]
    args = lambda root: vars(get_args(flags + ["--save_root", str(root)]))
    one = cli_main.run(args(tmp_path / "one"), train_data=(x, dx), device="cpu")
    dp = cli_main.run_lassi_dp(args(tmp_path / "dp"), ["cpu", "cpu"], train_data=(x, dx))
    _assert_epochs_close(dp["history"], one["history"])
    assert len(dp["walls"]) == 2 and dp["all_reduces"] > 0
    assert dp["save_dir"] == str(tmp_path / "dp" / "laligan-noise99-lv")
    assert {"autoencoder.npz", "generator.npz"} <= {p.name for p in
                                                    (tmp_path / "dp" / "laligan-noise99-lv").iterdir()}


@pytest.mark.parametrize("joint", [False, True], ids=["plain", "joint"])
def test_dp_float64_training_equals_single_device(joint, tmp_path):
    """run_lassi(dtype=float64), the same init and draws widened: 2 gloo
    ranks and one device then differ only by the order of their float64
    sums, within 1e-10 over three epochs, epoch means and each batch's
    metrics (chip_smoke.py's dp gate, 1e-6 over the first 9 batches at full
    width); the float32 run lies farther from both."""
    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data

    x, dx = gen_data(SYSTEMS["lv"], torch.Generator().manual_seed(0), n_ics=4, num_steps=1500,
                     subsample_rate=10, device="cpu")
    flags = ["--config", "lv/noise99_sym.cfg", "--hidden_dim", "32", "--n_layers", "2",
             "--batch_size", "128", "--num_epochs", "3", "--save_interval", "0",
             "--log_interval", "100", "--save_root", str(tmp_path)]
    flags += ["--include_sindy", "--eq_constraint", "--w_sindy_x", "0", "--w_sindy_z",
              "0.1"] if joint else []
    args = lambda: vars(get_args(flags))
    batches = []
    one = cli_main.run_lassi(args(), train_data=(x, dx), device="cpu", dtype=torch.float64,
                             batch_hook=lambda epoch, per_batch: batches.append(per_batch))
    dp = cli_main.run_lassi_dp(args(), ["cpu", "cpu"], train_data=(x, dx), dtype=torch.float64)
    assert one["trainer"].ae.encoder.dense[0].weight.dtype == torch.float64
    for h1, h2 in zip(one["history"], dp["history"]):
        for k, v in h1.items():
            assert abs(h2[k] - v) <= 1e-10 * max(abs(v), 1e-6), k
    assert len(batches) == len(dp["batches"]) == 3
    for b1, b2 in zip(batches, dp["batches"]):
        for k, v in b1.items():
            assert len(v) == len(b2[k]) > 1, k
            np.testing.assert_allclose(b2[k], v.numpy(), rtol=1e-10, atol=1e-16, err_msg=k)
    # over all the tensors at once: the biases that feed a training-mode
    # BatchNorm have an exact gradient of 0, so each run steps them on its
    # own rounding (cli/replay_lassi.py reports them apart)
    sd = one["trainer"].ae.state_dict()
    for stats in (False, True):
        keys = [k for k in sd if ("running" in k) == stats and "num_batches" not in k]
        a = np.concatenate([sd[k].numpy().ravel() for k in keys])
        b = np.concatenate([dp["state"]["ae"][k].ravel() for k in keys])
        assert np.linalg.norm(b - a) <= 1e-10 * np.linalg.norm(a), stats
    if joint:
        np.testing.assert_array_equal(dp["state"]["sindy"]["mask"],
                                      one["trainer"].sindy["mask"].numpy())
