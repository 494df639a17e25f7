"""The port's LaLiGAN epochs against the JAX trainer's on the CPU: three
epochs with thresholding after each (each epoch's mean components within
1e-3 relative, the generator masks equal), and the --lassi dump of
tools/dump_jax_draws.py replayed by cli/replay_lassi.py. Set-up as in
test_torch_lassi.py (hidden width 32, 2 layers, batch 128, the port's LV
windows, the JAX trainer's init and draws).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg

from symmetry_ode_discovery_tpu_torch.cli import replay_lassi

from test_torch_lassi import DUMP, _init, _pair, windows  # noqa: F401 (a fixture)


@pytest.mark.parametrize("repr_str", ["(2,1,2)", "(2,sim2)"])
def test_three_epochs_with_thresholding_match_jax(windows, repr_str):
    jtr, ptr, spec = _pair(repr_str, gan_st_freq=1, gan_st_thres=0.3, num_epochs=3)
    x = windows
    n = len(x)
    key, bundle, bstats, opt, sc = _init(jtr, ptr, x)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for e in range(3):
        key, sub = jax.random.split(key)
        perm, coef = DUMP.lassi_epoch_draws(jtr, bundle["g"], sub, n)
        bundle, bstats, opt, sc, jm = jtr.epoch(bundle, bstats, opt, sc, xj, xj, sub)
        bundle = dict(bundle, g=jlg.set_threshold(jtr.spec, bundle["g"], 0.3))
        pm = ptr.epoch(xt, perm=perm, coef=torch.tensor(coef))
        ptr.set_threshold()
        for name, v in jm.items():
            assert abs(float(pm[name]) - float(v)) <= 1e-3 * max(abs(float(v)), 1e-6), (e, name)
        for a, b in zip(ptr.g_state.masks, bundle["g"].masks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_replay_of_a_jax_dump(tmp_path, windows):
    """tools/dump_jax_draws.py --lassi's record at a small width (its fed
    draws reproduce trainer.epoch bit for bit), replayed by the port's
    cli/replay_lassi.py on the CPU: batch 0's components within 1e-5, each
    epoch's means within 1e-3."""
    from symmetry_ode_discovery_tpu.utils.config import get_args as jax_get_args

    flags = ["--hidden_dim", "16", "--n_layers", "2", "--batch_size", "128",
             "--gan_st_freq", "1"]
    args = vars(jax_get_args(["--config", "lv/noise99_sym.cfg"] + flags))
    args["input_dim"] = 2
    rec = DUMP.lassi_record(args, windows, n_batches=3, epochs=2, flags=flags)
    assert rec["bit_equal"].all()
    np.savez(tmp_path / "lassi.npz", **rec)
    out = json.loads(json.dumps(replay_lassi.replay(str(tmp_path / "lassi.npz"), "cpu")))
    assert out["batch0_ok"] and out["epoch_ok"], (out["batch0"], out["epoch_rel"])
    assert out["final_rel"]["masks_equal"]
