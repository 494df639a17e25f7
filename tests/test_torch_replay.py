"""The replay tool (cli/replay_isymreg.py) end to end on the CPU, on a tiny
stand-in of the recorded files: it reads the draws, runs them as lanes of the
flagship's stepper on the tracked checkpoint, and reports agreement. The
real replay needs the JAX package's untracked data cache, so this test
checks the plumbing and the report, not parity (the stepper's parity is
tests/test_torch_stepper.py's)."""

import os

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.cli.replay_isymreg import replay
from symmetry_ode_discovery_tpu_torch.evaluation.eval_eq import sindy_truth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [
    ("--symmpen_pallas", "--lbfgs_dir_backend", "pallas"),  # the flagship's switches
    (),                                                     # kernels off
])
def test_replay_reports_agreement(tmp_path, monkeypatch, flags):
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    x = rng.uniform(0.3, 2.0, (2, 300, 2)).astype(np.float32)
    dx = (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    np.save(data / "lv-train-noise99-gp-x.npy", x)
    np.save(data / "lv-train-noise99-gp-dx.npy", dx)
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(data))
    epochs, ones = 2, np.ones((2, 2, 8), np.float32)
    for s in (0, 1):
        xi0 = rng.standard_normal((2, 8)).astype(np.float32)
        recorded = epochs - s  # seed 1's record stopped after one epoch
        np.savez(tmp_path / f"seed{s}_traj.npz", perm=rng.permutation(600), xi0=xi0,
                 xi=np.stack([xi0] * recorded), mask_after=ones[:recorded],
                 mask_final=ones[0])
        np.savez(tmp_path / f"seed{s}_ours.npz", xi=np.stack([xi0] * epochs), mask=ones)
        np.savez(tmp_path / f"seed{s}_ref_eval.npz", correct_form=np.zeros(2),
                 coefficients=np.zeros((2, 8), np.float32))
    out = replay(str(tmp_path), [0, 1], epochs=epochs, st_freq=1, device="cpu",
                 ckpt_root=os.path.join(REPO, "saved_models"), flags=flags)
    assert out["seeds"] == [0, 1] and len(out["per_seed"]) == 2
    assert out["symmpen_pallas"] == bool(flags)
    assert out["lbfgs_dir_backend"] == ("pallas" if flags else "xla")
    for rec in out["per_seed"]:
        assert len(rec["mask_equal_jax"]) == len(rec["mask_equal_ref"]) == epochs
        assert np.isfinite(rec["max_dxi_jax"]).all()
        assert rec["ref_correct_form"] == [0.0, 0.0]
        assert rec["max_coef_diff_ref"] >= 0.0
    # st_freq 1 thresholds every epoch, so the all-ones records disagree
    assert out["masks_equal_ref_every_epoch"] == 0
    assert sindy_truth["lv"].shape == (2, 8)
