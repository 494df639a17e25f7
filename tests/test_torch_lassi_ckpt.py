"""The port's LaLiGAN checkpoints, resume and CLI branch on the CPU, and the
JAX package's four LaLiGAN faults (ADVICE.md) shown beside the port's
behaviour, which avoids them.

- save_laligan writes the JAX package's layout: its load_laligan reads the
  port's files, and the two encoders and decoders agree within 1e-6;
- an interrupted and resumed port run is bit-identical to an uninterrupted
  one (the JAX package's model: tests/test_checkpoint_resume.py);
- pruning keeps the best snapshot by held-out metric, never a NaN one;
- cli/main.py's mt_data branch at a reduced size through run().
"""

import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli import main as jax_cli
from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.discriminator import Discriminator as JDisc
from symmetry_ode_discovery_tpu.training import lassi as jlassi
from symmetry_ode_discovery_tpu.utils import checkpoint as jckpt
from symmetry_ode_discovery_tpu.utils import watchdog

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.cli import main as cli_main
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.discriminator import Discriminator
from symmetry_ode_discovery_tpu_torch.training import lassi
from symmetry_ode_discovery_tpu_torch.utils import checkpoint as ckpt
from symmetry_ode_discovery_tpu_torch.utils.config import get_args
from symmetry_ode_discovery_tpu_torch.utils.metrics import load_metrics

AE_KW = dict(ae_arch="mlp", input_dim=2, hidden_dim=16, latent_dim=2, n_layers=2, n_comps=2,
             batch_norm=True, ortho_ae=True)
HP_KW = dict(batch_size=128, gan_st_freq=2, gan_st_thres=0.1, w_gan=0.01, w_reg_norm=0.01)


def _mt_data(n=256):
    """Pairs (x_t, x_{t+k}) on circles, as the JAX package's resume test."""
    rng = np.random.default_rng(0)
    r = rng.uniform(0.5, 2.0, size=n)
    th = rng.uniform(0, 2 * np.pi, size=n)
    x0 = np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
    x1 = np.stack([r * np.cos(th + 0.5), r * np.sin(th + 0.5)], axis=1)
    return np.stack([x0, x1], axis=1).astype(np.float32)


def _port(num_epochs, **kw):
    hp = lassi.LassiHParams(num_epochs=num_epochs, **dict(HP_KW, **kw))
    return lassi.LassiTrainer(AutoEncoder(AutoEncoderConfig(**AE_KW)),
                              lg.parse_repr("(2,1,2)", "0"),
                              Discriminator(4, hidden_dim=16, n_layers=2), hp, device="cpu")


def _jax(num_epochs, **kw):
    hp = jlassi.LassiHParams(num_epochs=num_epochs, **dict(HP_KW, **kw))
    return jlassi.LassiTrainer(AutoEncoderDef(**AE_KW), jlg.parse_repr("(2,1,2)", "0"),
                               JDisc(hidden_dim=16, n_layers=2), hp)


def _assert_state_equal(a, b):
    for (ka, va), (kb, vb) in zip(ckpt.flatten(a).items(), ckpt.flatten(b).items()):
        assert ka == kb
        np.testing.assert_array_equal(va, vb, err_msg=ka)


# --- checkpoints ---


def test_save_laligan_reads_in_the_jax_package(tmp_path):
    x = torch.tensor(_mt_data())
    tr = _port(2)
    lassi.train_lassi(tr, x, None, seed=3, verbose=False)
    out = ckpt.save_laligan("run", tr, root=str(tmp_path))
    ae_def = AutoEncoderDef(**AE_KW)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    bundle = {"ae": params, "g": jlg.init_generator(jax.random.PRNGKey(1),
                                                    jlg.parse_repr("(2,1,2)", "0"))}
    bundle, bstats = jckpt.load_laligan("run", bundle, bstats, root=str(tmp_path))
    tr.ae.eval()
    with torch.no_grad():
        z = tr.ae.encode(x)
        xhat = tr.ae.decode(z)
    zj = ae_def.encode(bundle["ae"], bstats, jnp.asarray(x.numpy()), train=False)[0]
    np.testing.assert_allclose(np.asarray(zj), z.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ae_def.decode(bundle["ae"], jnp.asarray(z.numpy()))),
                               xhat.numpy(), rtol=1e-6, atol=1e-6)
    for a, b in zip(bundle["g"].Li + bundle["g"].masks, tr.g_state.Li + tr.g_state.masks):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    # and the port reads its own files back
    sd, g_state = convert.laligan_from_npz(out, "cpu")
    ae = AutoEncoder(AutoEncoderConfig(**AE_KW))
    ae.load_state_dict(sd)
    with torch.no_grad():
        assert torch.equal(ae.eval().encode(x), z)


def test_interrupted_resume_is_bit_identical(tmp_path):
    """3 epochs, then a fresh trainer resuming to 6 == 6 uninterrupted
    epochs: parameters, statistics, optimiser state, masks and history."""
    x = torch.tensor(_mt_data())
    root = str(tmp_path)
    full = _port(6)
    hist_a = lassi.train_lassi(full, x, None, seed=7, verbose=False)
    lassi.train_lassi(_port(3), x, None, seed=7, verbose=False, save_interval=1,
                      save_dir="resume", root=root)
    assert ckpt.latest_train_state("resume", root)[1] == 3
    rest = _port(6)
    hist_b = lassi.train_lassi(rest, x, None, seed=7, verbose=False, save_interval=3,
                               save_dir="resume", resume=True, root=root)
    assert len(hist_a) == len(hist_b) == 6
    assert hist_a == hist_b
    _assert_state_equal(full.state(), rest.state())
    assert ckpt.latest_train_state("resume", root)[1] == 6


def test_prune_keeps_best_by_val(tmp_path):
    root = str(tmp_path)
    vals = {10: 0.20, 20: 0.07, 30: 0.15, 40: 0.18, 50: 0.21}
    for ep, v in vals.items():
        ckpt.save_train_state(ckpt.train_state_path("d", ep, root), {"w": np.zeros(2)}, [],
                              val_metric=v)
    ckpt.prune_train_states("d", keep=2, root=root)
    left = sorted(p.name for p in (tmp_path / "d").iterdir())
    assert left == ["train_state_ep00020.npz", "train_state_ep00040.npz",
                    "train_state_ep00050.npz"]
    assert ckpt.best_train_state("d", root)[1] == 20


# --- the JAX package's faults, beside the port ---


def _nan_on_second(epoch_fn, corrupt):
    calls = []

    def wrapped(*a, **kw):
        out = epoch_fn(*a, **kw)
        calls.append(1)
        return corrupt(out) if len(calls) == 2 else out
    return wrapped


def test_ema_is_updated_after_the_nan_check(tmp_path):
    """ADVICE: training/lassi.py:488 updates the EMA before the NaN check,
    so a NaN epoch poisons the final (EMA) autoencoder of the JAX package;
    the port checks first, and its final autoencoder is the EMA of the last
    finite epoch."""
    x = _mt_data()
    jtr = _jax(3, ae_ema=0.5)
    jtr.epoch = _nan_on_second(
        lambda *a: jlassi.LassiTrainer.epoch(jtr, *a),
        lambda out: (dict(out[0], ae=jax.tree_util.tree_map(lambda p: p * jnp.nan,
                                                            out[0]["ae"])),
                     *out[1:4], {k: v * jnp.nan for k, v in out[4].items()}))
    bundle, _, _, hist = jlassi.train_lassi(jtr, jnp.asarray(x), None, jax.random.PRNGKey(0),
                                            verbose=False)
    assert len(hist) == 1
    assert any(np.isnan(np.asarray(p)).any() for p in jax.tree_util.tree_leaves(bundle["ae"]))

    ptr = _port(3, ae_ema=0.5)
    ptr.init(0)
    init = [p.detach().clone() for p in ptr.ae.parameters()]

    def poison(out):
        with torch.no_grad():
            for p in ptr.ae.parameters():
                p.mul_(float("nan"))
        return {k: v * float("nan") for k, v in out.items()}

    ptr.epoch = _nan_on_second(ptr.epoch, poison)
    after_first = {}
    hook = lambda e, s: after_first.setdefault(e, [p.detach().clone() for p in
                                                   ptr.ae.parameters()])
    hist = lassi.train_lassi(ptr, torch.tensor(x), None, seed=0, verbose=False, epoch_hook=hook)
    assert len(hist) == 1
    for p, p0, p1 in zip(ptr.ae.parameters(), init, after_first[0]):
        assert torch.isfinite(p).all()
        torch.testing.assert_close(p.detach(), 0.5 * p0 + 0.5 * p1, rtol=0, atol=0)


def test_resume_with_ema_from_a_snapshot_without_one(tmp_path, monkeypatch):
    """ADVICE: training/lassi.py:460 raises KeyError when --ae_ema resumes
    from a snapshot saved without an EMA; the port starts the EMA from the
    resumed autoencoder and goes on."""
    monkeypatch.chdir(tmp_path)
    x = _mt_data()
    jlassi.train_lassi(_jax(2), jnp.asarray(x), None, jax.random.PRNGKey(0), verbose=False,
                       save_interval=1, save_dir="noema")
    with pytest.raises(KeyError):
        jlassi.train_lassi(_jax(3, ae_ema=0.9), jnp.asarray(x), None, jax.random.PRNGKey(0),
                           verbose=False, save_interval=1, save_dir="noema", resume=True)

    root = str(tmp_path / "port")
    lassi.train_lassi(_port(2), torch.tensor(x), None, seed=0, verbose=False, save_interval=1,
                      save_dir="noema", root=root)
    tr = _port(3, ae_ema=0.9)
    hist = lassi.train_lassi(tr, torch.tensor(x), None, seed=0, verbose=False, save_interval=1,
                             save_dir="noema", resume=True, root=root)
    assert len(hist) == 3
    assert all(torch.isfinite(p).all() for p in tr.ae.parameters())
    assert ckpt.load_train_state(ckpt.train_state_path("noema", 3, root),
                                 {"trainer": tr.state(), "generator": torch.Generator()
                                  .get_state()})[2]["ema_ae"] is not None


def test_no_heartbeat_is_left_running(tmp_path):
    """ADVICE: cli/main.py:518 arms the JAX package's heartbeat watchdog and
    never stops it (a thread that outlives the run, and can relaunch the
    process); the port starts none (utils/watchdog.py is ROADMAP item 12)."""
    src = inspect.getsource(jax_cli.main)
    assert "start_heartbeat(" in src and "stop_heartbeat" not in src
    watchdog.start_heartbeat(timeout_s=1e9, fire=lambda: None, poll_s=3600.0)
    try:
        assert any(t.name == "heartbeat-watchdog" and t.is_alive()
                   for t in threading.enumerate())
    finally:
        watchdog.stop_heartbeat()
    before = set(threading.enumerate())
    args = vars(get_args(["--config", "lv/noise99_sym.cfg", "--hidden_dim", "16",
                          "--n_layers", "2", "--batch_size", "128", "--num_epochs", "1",
                          "--save_root", str(tmp_path)]))
    x = _mt_data(300)[:, 0].reshape(2, 150, 2)
    cli_main.run(args, train_data=(x, x), device="cpu")
    assert set(threading.enumerate()) <= before
    assert "heartbeat" not in inspect.getsource(cli_main)


def test_a_nan_val_metric_is_never_the_best(tmp_path, monkeypatch):
    """ADVICE: utils/checkpoint.py:145 compares `v < best`, so a NaN first
    val metric stays the best for good and survives every pruning; the port
    skips NaN metrics."""
    monkeypatch.chdir(tmp_path)
    for mod, root in ((jckpt, "saved_models"), (ckpt, str(tmp_path / "port"))):
        kw = {} if mod is jckpt else {"root": root}
        for ep, v in ((1, float("nan")), (2, 0.3), (3, 0.1), (4, 0.2), (5, 0.4)):
            mod.save_train_state(mod.train_state_path("d", ep, **kw), {"w": np.zeros(2)}, [],
                                 val_metric=v)
        mod.prune_train_states("d", keep=1, **kw)
    jbest = jckpt.best_train_state("d")
    assert jbest[1] == 1 and np.isnan(jbest[2])
    assert ckpt.best_train_state("d", str(tmp_path / "port"))[1:] == (3, 0.1)
    left = sorted(p.name for p in (tmp_path / "port" / "d").iterdir())
    assert left == ["train_state_ep00003.npz", "train_state_ep00005.npz"]
    assert "train_state_ep00001.npz" in [p.name for p in (tmp_path / "saved_models" / "d")
                                         .iterdir()]


# --- the CLI branch ---


def test_cli_mt_branch_runs_at_a_reduced_size(tmp_path, capsys):
    """lv/noise99_sym.cfg through run() at hidden width 16, 2 layers: the
    JAX CLI's printouts, the metrics log, snapshots and the artifacts under
    --save_root, which convert.laligan_from_npz reads."""
    args = vars(get_args(["--config", "lv/noise99_sym.cfg", "--hidden_dim", "16",
                          "--n_layers", "2", "--batch_size", "128", "--num_epochs", "2",
                          "--save_interval", "1", "--save_root", str(tmp_path)]))
    x = _mt_data(400)[:, 0].reshape(2, 200, 2)
    out = cli_main.run(args, train_data=(x, x), device="cpu")
    text = capsys.readouterr().out
    assert "Epoch 1, loss_ae:" in text and "Saved LaLiGAN artifacts to" in text
    assert len(out["history"]) == 2
    assert all(np.isfinite(v) for h in out["history"] for v in h.values())
    assert len(load_metrics("laligan-noise99-lv", str(tmp_path / "runs"))) == 2
    d = tmp_path / "laligan-noise99-lv"
    assert {"autoencoder.npz", "discriminator.npz", "generator.npz",
            "generator_mask.npz"} <= {p.name for p in d.iterdir()}
    assert ckpt.latest_train_state("laligan-noise99-lv", str(tmp_path))[1] == 2
    sd, g_state = convert.laligan_from_npz(str(d), "cpu")
    assert g_state.Li[0].shape == (1, 2, 2)


@pytest.mark.parametrize("flags, match", [
    (["--dp_devices", "2"], "2-device mesh but only 0 CUDA devices"),
    (["--include_sindy", "--dp_devices", "2"], "2-device mesh but only 0 CUDA devices"),
])
def test_cli_mt_branch_unported_options_raise(tmp_path, flags, match):
    """--dp_devices N takes the first N CUDA devices and raises when fewer
    exist, before anything is written."""
    args = vars(get_args(["--config", "lv/noise99_sym.cfg", "--save_root", str(tmp_path)]
                         + flags))
    x = _mt_data(40)[:, 0].reshape(2, 20, 2)
    with pytest.raises(ValueError, match=match):
        cli_main.run(args, train_data=(x, x), device="cpu")
    assert not any(tmp_path.iterdir())


def test_cli_mt_branch_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = vars(get_args(["--config", "lv/noise99_sym.cfg", "--save_root", str(tmp_path)]))
    x = _mt_data(40)[:, 0].reshape(2, 20, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main.run(args, train_data=(x, x))
    assert not any(tmp_path.iterdir())
