"""The port's config parser and CLI.

- get_args on run_configs/lv/noise99_eq_isymreg.cfg with the flagship's
  command-line flags equals the JAX package's get_args, key for key (the
  port adds two keys, eval_root and save_root).
- cli.main.run on the CPU at a tiny size: the EquivSINDy-r sweep branch
  (chunks with a padded tail, one npz per seed, resume), the single-seed
  branch, and the plain sweep branch; the branches that stay unported
  (--mesh_devices, LaLiGAN's --dp_devices) raise, as do distillation
  without --use_latent and a missing checkpoint;
- the EquivSINDy-r sweep with --ae_dtype bf16, through the K2/K3 kernels'
  plain versions and through autograd: its npz files and coefficients, and
  the same chunk in f32 for contrast.
"""

import os

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

from symmetry_ode_discovery_tpu_torch.cli.main import build_models, run, truncated_L_list
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = ["--config", "lv/noise99_eq_isymreg.cfg", "--symmpen_pallas", "--ae_dtype", "f32",
            "--n_seeds", "50"]
LV_TRUTH = np.array([[2 / 3, 0, 0, 0, 0, 0, 0, -4 / 3], [-1, 0, 0, 0, 0, 0, 1, 0]], np.float32)


@pytest.mark.parametrize("argv", [FLAGSHIP, ["--config", "growth/noise05_esindy.cfg", "--seed", "3"],
                                  ["--task", "dosc", "--lr_sindy", "0.5"]],
                         ids=["lv_isymreg", "growth_esindy", "no_config"])
def test_get_args_matches_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)  # the JAX parser resolves run_configs/ from the working directory
    got = vars(get_args(argv))
    want = vars(jget_args(argv))
    assert got.pop("eval_root") == "eval_results"
    assert got.pop("save_root") is None
    assert got == want


@pytest.fixture(autouse=True)
def _few_threads():
    """The full-width checkpoint's products on a few threads: the suite runs
    several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _lv_data(n=10000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.3, 2.0, (n, 2)).astype(np.float32)
    theta = np.concatenate([np.ones_like(x[:, :1]), x, x[:, :1] ** 2, x[:, :1] * x[:, 1:],
                            x[:, 1:] ** 2, np.exp(x)], axis=1)
    return x, (theta @ LV_TRUTH.T).astype(np.float32)


def _args(extra, tmp_path):
    return vars(get_args(["--config", "lv/noise99_eq_isymreg.cfg", "--symmpen_pallas",
                          "--ae_dtype", "f32", "--lbfgs_dir_backend", "pallas",
                          "--eval_root", str(tmp_path)] + extra))


def test_symreg_sweep_chunks_and_resume(tmp_path):
    args = _args(["--seed", "0", "--n_seeds", "3", "--seed_chunk", "2", "--num_epochs", "1"],
                 tmp_path)
    out = run(args, train_data=_lv_data(), device="cpu", ckpt_root=os.path.join(REPO, "saved_models"))
    files = sorted(os.listdir(tmp_path / "symreg2-noise99-lv"))
    assert files == ["seed0.npz", "seed1.npz", "seed2.npz"]
    assert out["Xi"].shape == (3, 2, 8) and np.isfinite(out["Xi"]).all()
    assert out["epochs_run"] == [1, 1] and out["seeds_run"] == [0, 1, 2]
    with np.load(tmp_path / "symreg2-noise99-lv" / "seed2.npz") as z:
        assert set(z.files) == {"coefficients", "correct_form", "mse", "correct_form_all",
                                "mse_all"}
    again = run(args, train_data=_lv_data(), device="cpu",
                ckpt_root=os.path.join(REPO, "saved_models"))
    assert again["seeds_run"] == []
    np.testing.assert_allclose(again["Xi"], out["Xi"] * out["mask"], atol=1e-7)


def test_single_seed_runs_the_stepper(tmp_path):
    args = _args(["--seed", "7", "--num_epochs", "1"], tmp_path)
    out = run(args, train_data=_lv_data(), device="cpu", ckpt_root=os.path.join(REPO, "saved_models"))
    assert out["correct_form"].shape == (2,) and out["epochs_run"] == [1]
    assert os.path.exists(tmp_path / "symreg2-noise99-lv" / "seed7.npz")


def test_plain_sweep_branch(tmp_path):
    args = vars(get_args(["--config", "lv/noise99_eq_sindy_2.cfg", "--n_seeds", "4",
                          "--eval_root", str(tmp_path)]))
    out = run(args, train_data=_lv_data(), device="cpu")
    assert out["mask"].shape == (4, 2, 8)
    assert len(os.listdir(tmp_path / args["save_dir"])) == 4


@pytest.mark.parametrize("pallas", [True, False], ids=["kernels", "autodiff"])
def test_symreg_sweep_bf16(tmp_path, pallas):
    """--ae_dtype bf16 runs the flagship's path: every seed's npz, finite
    coefficients of the flagship's shape, and another fit than f32's on the
    same seeds and rows (the penalty is rounded to bf16)."""
    flags = ["--seed", "0", "--n_seeds", "2", "--num_epochs", "1", "--ae_dtype", "bf16"]
    args = _args(flags, tmp_path / "bf16")
    if not pallas:
        args["symmpen_pallas"] = False
    assert args["ae_dtype"] == "bf16"
    out = run(args, train_data=_lv_data(), device="cpu", ckpt_root=os.path.join(REPO, "saved_models"))
    assert sorted(os.listdir(tmp_path / "bf16" / "symreg2-noise99-lv")) == ["seed0.npz", "seed1.npz"]
    assert out["Xi"].shape == (2, 2, 8) and np.isfinite(out["Xi"]).all()
    f32 = run(dict(args, ae_dtype="f32", eval_root=str(tmp_path / "f32")), train_data=_lv_data(),
              device="cpu", ckpt_root=os.path.join(REPO, "saved_models"))
    assert not np.array_equal(out["Xi"], f32["Xi"])


@pytest.mark.parametrize("extra,exc", [
    (["--mesh_devices", "2"], ValueError),  # make_mesh: only 0 CUDA devices here
    (["--task", "mt_lv", "--dp_devices", "2"], ValueError),
    (["--distill_latent"], ValueError),
    (["--use_latent", "--load_laligan", "no-such-checkpoint"], FileNotFoundError),
    (["--load_laligan", "no-such-checkpoint"], FileNotFoundError),
])
def test_unported_branches_raise(tmp_path, extra, exc):
    with pytest.raises(exc):
        run(_args(extra, tmp_path), train_data=_lv_data(200), device="cpu",
            ckpt_root=os.path.join(REPO, "saved_models"))
    assert not any(tmp_path.iterdir())


def test_constraint_generators_from_fixed_group():
    args = vars(get_args(["--config", "growth/noise05_esindy.cfg"]))
    args["input_dim"] = 2
    _, spec = build_models(args)
    state = lg.init_generator(spec, torch.Generator().manual_seed(0))
    (L,) = truncated_L_list(spec, state, args["n_comps"])
    np.testing.assert_array_equal(L, np.array([[2.0, 0.0], [0.0, 1.0]], np.float32))
