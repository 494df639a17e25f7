"""The port's cli/main.py on the branches this slice adds, end to end on
the CPU at a tiny size, against the JAX CLI on the same rows and the same
draws (tools/dump_jax_draws.py's): --sindy_optimizer adam, --use_latent,
--distill_latent, --sym_reg_type f and r, --symmreg_slow and
--no_fused_rollout, each on selkov/noise20_eq_symreg.cfg with the tracked
laligan-noise20-selkov checkpoint (4 x 128); the Adam case from a copy of
the config with --sindy_optimizer adam written in it (both parsers drop a
command-line flag that equals its default, and adam is the default, so
the config's lbfgs would win). The JAX CLI runs in a scratch
directory (it writes eval_results/ under the working directory) on a cache
of the same 400 rows. Each run writes the JAX CLI's seed-npz schema; the
masks (the nonzero pattern of the stored coefficients) are equal and the
coefficients within 1e-3. Adam runs 2 epochs of batches of 64 (st_freq 1),
the L-BFGS branches 1 epoch (the latent ones 20), 2 seeds.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli import main as jmain
from symmetry_ode_discovery_tpu.data import datasets as jds
from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

from symmetry_ode_discovery_tpu_torch.cli.main import run
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "selkov/noise20_eq_symreg.cfg"
SEEDS = [0, 1]
CASES = {
    "adam": ["--num_epochs", "2", "--batch_size", "64",
             "--st_freq", "1", "--lr_sindy", "0.01", "--threshold", "0.05"],
    "latent": ["--use_latent", "--w_sym_reg", "0", "--num_epochs", "20", "--st_freq", "10"],
    "distill": ["--use_latent", "--distill_latent", "--w_sym_reg", "0", "--num_epochs", "20",
                "--st_freq", "10"],
    "sym_f": ["--sym_reg_type", "f", "--num_epochs", "1"],
    "sym_r": ["--sym_reg_type", "r", "--num_epochs", "1"],
    "symreg_slow": ["--symreg_slow", "--num_epochs", "1"],
    "no_fused_rollout": ["--no_fused_rollout", "--num_epochs", "1"],
}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dump_jax_draws", os.path.join(REPO, "tools", "dump_jax_draws.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DUMP = _tool()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A scratch working directory for the JAX CLI (run_configs and the
    checkpoint linked in) holding the selkov cache of 400 rows."""
    d = tmp_path_factory.mktemp("cli")
    os.symlink(os.path.join(REPO, "run_configs"), d / "run_configs")
    (d / "saved_models").mkdir()
    os.symlink(os.path.join(REPO, "saved_models", "laligan-noise20-selkov"),
               d / "saved_models" / "laligan-noise20-selkov")
    rng = np.random.default_rng(0)
    # rows over [-1.5, 1.5]: on selkov's own range poly3's columns are so
    # nearly collinear that the distillation's fixed-lr L-BFGS amplifies
    # rounding to O(0.1) in either package (its float32 and float64 runs
    # differ so); here both packages' runs agree to rounding
    x = rng.uniform(-1.5, 1.5, (2, 200, 2))
    dx = np.stack([0.75 - 0.1 * x[..., 0] - x[..., 0] * x[..., 1] ** 2,
                   -x[..., 1] + 0.1 * x[..., 0] + x[..., 0] * x[..., 1] ** 2], -1)
    dx = dx + 0.01 * rng.standard_normal(dx.shape)
    text = open(os.path.join(REPO, "run_configs", CONFIG)).read()
    (d / "adam.cfg").write_text(text.replace("--sindy_optimizer lbfgs", "--sindy_optimizer adam"))
    for mode in ("train", "val"):
        np.save(d / f"selkov-{mode}-noise20-gp-x.npy", x.astype(np.float32))
        np.save(d / f"selkov-{mode}-noise20-gp-dx.npy", dx.astype(np.float32))
    return d


def _draws(config, case, flags, x, path):
    """The JAX CLI's own draws for ``flags``, written as --subsample_perms."""
    args = vars(jget_args(["--config", config] + flags))
    args["input_dim"] = 2
    cfg, Q = DUMP.fit_setup(args)
    n = x.shape[0]
    k = int(n * args["lbfgs_subsample"])
    if case == "adam":
        tr = DUMP.adam_trainer(args)
        bs = min(args["batch_size"], n)
        theta0, perm = [], []
        for s in SEEDS:
            key, kinit = jax.random.split(jax.random.PRNGKey(s))
            theta0.append(DUMP._flat_params(tr.init(kinit)[0]).reshape(-1))
            perms = []
            for _ in range(args["num_epochs"]):
                key, sub = jax.random.split(key)
                perms.append(np.asarray(jax.random.permutation(sub, n)[: (n // bs) * bs]))
            perm.append(np.stack(perms))
        rec = dict(theta0=np.stack(theta0), perm=np.stack(perm))
    elif args["use_latent"]:
        idx, th0, th0_dst = DUMP.latent_draws(args, cfg, Q, n, k, SEEDS)
        rec = dict(idx=idx, theta0=th0, theta0_dst=th0_dst)
    else:
        idx, th0 = DUMP.stepped_draws(cfg, Q, n, k, SEEDS)
        rec = dict(idx=idx, theta0=th0)
    np.savez(path, seeds=np.asarray(SEEDS, np.int32), **rec)


@pytest.mark.parametrize("case", list(CASES))
def test_cli_branch_matches_jax(case, workdir, tmp_path, monkeypatch):
    flags = CASES[case] + ["--seed", str(SEEDS[0]), "--n_seeds", str(len(SEEDS)),
                           "--save_dir", f"cli-{case}"]
    config = str(workdir / "adam.cfg") if case == "adam" else CONFIG
    x = np.load(workdir / "selkov-train-noise20-gp-x.npy").reshape(-1, 2)
    dx = np.load(workdir / "selkov-train-noise20-gp-dx.npy").reshape(-1, 2)
    monkeypatch.chdir(workdir)
    monkeypatch.setattr(jds, "DATA_PATH", str(workdir))
    jargs = vars(jget_args(["--config", config] + flags))
    assert (jargs["sindy_optimizer"] == "adam") == (case == "adam")
    jmain.run(jargs)
    draws = tmp_path / "draws.npz"
    _draws(config, case, flags, x, draws)
    args = vars(get_args(["--config", config] + flags + [
        "--subsample_perms", str(draws), "--eval_root", str(tmp_path / "eval"),
        "--save_root", str(tmp_path / "saved")]))
    run(args, train_data=(x, dx), device="cpu", ckpt_root=os.path.join(REPO, "saved_models"))
    for s in SEEDS:
        with np.load(workdir / "eval_results" / f"cli-{case}" / f"seed{s}.npz") as z:
            want = {k: z[k] for k in z.files}
        with np.load(tmp_path / "eval" / f"cli-{case}" / f"seed{s}.npz") as z:
            got = {k: z[k] for k in z.files}
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["coefficients"] != 0, want["coefficients"] != 0)
        np.testing.assert_allclose(got["coefficients"], want["coefficients"], atol=1e-3)
        np.testing.assert_array_equal(got["correct_form"], want["correct_form"])
    if case == "adam":
        assert os.path.isfile(tmp_path / "saved" / f"cli-{case}" / "regressor.npz")
