"""The port's post-hoc rd latent fit (cli/rd_fit_latent_sindy.py) against
the JAX package's LassiTrainer._sindy_lstsq_update, which the repository's
tools/rd_fit_latent_sindy.py runs, on the CPU.

Small size: the reaction-diffusion data on a 4 x 4 grid (the port's
solver, written as reaction_diffusion.mat; its 158 train windows of two
snapshots, 16 inputs), rd/sym_eq.cfg with the autoencoder cut to 2 x 32. A
LaLiGAN source checkpoint is the JAX trainer's initialisation from a seed,
saved by the JAX package's save_laligan: seed 2 at the config's threshold
0.1 (three terms kept), seed 0 at threshold 0.01 (four), and seed 1 at 0.1
(none). Bars, float32: the
masks equal; Xi within 1e-4 of the largest |Xi| and the residual within
1e-4 relative. The output directory loads in the JAX package
(load_laligan, load_pytree of regressor.npz: the port's Xi and mask) and
in the port's cli/eval_rd_ltp.py; a port snapshot (--epoch) fits as the
artifacts of the same trainer do. On the tracked
laligan-rd-nonjoint-s42-ep90 at full size, Xi is masked to 0, as
RESULTS.md reports of the JAX tool.
"""

import os

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.cli import eval_rd_ltp
from symmetry_ode_discovery_tpu_torch.cli import rd_fit_latent_sindy as posthoc
from symmetry_ode_discovery_tpu_torch.data.datasets import MultiTimestepReactionDiffusionDataset
from symmetry_ode_discovery_tpu_torch.data.rd_solver import save_rd_mat, simulate_rd
from symmetry_ode_discovery_tpu_torch.utils import checkpoint as ckpt
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--hidden_dim", "32", "--n_layers", "2"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rd_dir(tmp_path_factory):
    """A data directory holding the 4 x 4 grid's reaction_diffusion.mat,
    and its train windows (x, dx) as numpy float32."""
    d = tmp_path_factory.mktemp("rd")
    sim = simulate_rd(n=4, device="cpu")
    save_rd_mat(str(d / "reaction_diffusion.mat"), *sim)
    t, xg, yg, uf, duf = sim
    data = {"t": t.reshape(-1, 1), "x": xg.reshape(-1, 1), "y": yg.reshape(-1, 1),
            "uf": uf.numpy(), "duf": duf.numpy()}
    ds = MultiTimestepReactionDiffusionDataset(data, "train", device="cpu")
    return d, ds.x.numpy(), ds.dx.numpy()


@pytest.fixture
def data_env(rd_dir, monkeypatch):
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(rd_dir[0]))
    return rd_dir


def _jax_source(root, x, seed, extra=()):
    """The JAX trainer's initialisation from PRNGKey(seed), saved as
    root/src; returns the JAX trainer, bundle, batch statistics and fresh
    joint state."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.cli.main import build_models
    from symmetry_ode_discovery_tpu.training.lassi import LassiHParams, LassiTrainer
    from symmetry_ode_discovery_tpu.utils import checkpoint as jckpt
    from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args

    args = dict(vars(jget_args(["--config", "rd/sym_eq.cfg"] + SMALL + list(extra))),
                input_dim=x.shape[-1])
    ae_def, spec, disc = build_models(args)
    hp = LassiHParams(
        include_sindy=True, eq_constraint=args["eq_constraint"], poly_order=args["poly_order"],
        w_sindy_z=args["w_sindy_z"], w_sindy_x=args["w_sindy_x"],
        w_sindy_reg=args["w_sindy_reg"], sindy_reg_type=args["sindy_reg_type"], lr_sindy=0.0,
        st_freq=args["st_freq"], threshold=args["threshold"])
    trainer = LassiTrainer(ae_def, spec, disc, hp, steps_per_epoch=1)
    bundle, bstats, _, carry = trainer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    jckpt.save_laligan("src", bundle, bstats, root=str(root))
    return trainer, bundle, bstats, carry


def _jax_fit(trainer, bundle, bstats, carry, x, dx):
    """The tool's fit (tools/rd_fit_latent_sindy.py:128-143)."""
    import jax.numpy as jnp

    resid, carry = trainer._sindy_lstsq_update(bundle["ae"], bstats, bundle["g"],
                                               jnp.asarray(x), jnp.asarray(dx), carry,
                                               is_last=True)
    return float(resid), np.asarray(carry["Xi"]), np.asarray(carry["mask"])


@pytest.mark.parametrize("seed, extra, terms", [(2, [], 3), (0, ["--threshold", "0.01"], 4),
                                                (1, [], 0)], ids=["thr0.1", "thr0.01", "zero"])
def test_fit_matches_jax_and_loads_everywhere(tmp_path, data_env, seed, extra, terms):
    import jax

    from symmetry_ode_discovery_tpu.models import lie_generator as jlg
    from symmetry_ode_discovery_tpu.utils import checkpoint as jckpt

    _, x, dx = data_env
    trainer, bundle, bstats, carry = _jax_source(tmp_path / "saved_models", x, seed, extra)
    resid, Xi, mask = _jax_fit(trainer, bundle, bstats, carry, x, dx)
    out = posthoc.run("src", ckpt_root=str(tmp_path / "saved_models"),
                      save_root=str(tmp_path / "out"), extra=SMALL + extra, device="cpu")
    assert out["windows"] == 158 and out["dir"] == str(tmp_path / "out" / "src-sindy")
    np.testing.assert_array_equal(out["mask"], mask)
    assert mask.sum() == terms
    assert np.abs(out["Xi"] - Xi).max() <= 1e-4 * max(np.abs(Xi).max(), 1e-6)
    assert abs(out["resid"] - resid) <= 1e-4 * abs(resid)

    # the JAX package reads the output directory
    k = jax.random.PRNGKey(0)
    params, bs = trainer.ae_def.init(k)
    like = {"ae": params, "d": bundle["d"], "g": jlg.init_generator(k, trainer.spec)}
    got, got_bs = jckpt.load_laligan("src-sindy", like, bs, root=str(tmp_path / "out"))
    for a, b in zip(jax.tree_util.tree_leaves((got["ae"], got_bs, got["g"])),
                    jax.tree_util.tree_leaves((bundle["ae"], bstats, bundle["g"]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    reg = jckpt.load_pytree(os.path.join(out["dir"], "regressor.npz"),
                            {"Xi": np.zeros_like(Xi), "mask": np.zeros_like(mask)})
    np.testing.assert_array_equal(np.asarray(reg["Xi"]), out["Xi"])
    np.testing.assert_array_equal(np.asarray(reg["mask"]), out["mask"])

    # and so does the port's rd LTP evaluation
    args = vars(get_args(["--config", "rd/sym_eq.cfg", "--load_laligan", out["dir"],
                          "--eval_root", str(tmp_path / "ltp")] + SMALL))
    ltp = eval_rd_ltp.run(args, device="cpu")
    np.testing.assert_array_equal(ltp["Xi"], out["Xi_masked"])
    assert np.isfinite(ltp["rel_rollout"]).all() and ltp["z_pred"].shape == (19, 2)


def test_snapshot_fits_as_its_artifacts(tmp_path, data_env):
    """--epoch reads the port's train_state_ep<N>.npz: a trainer's snapshot
    and its artifacts give the same fit."""
    args = dict(vars(get_args(["--config", "rd/sym_eq.cfg"] + SMALL)), input_dim=16)
    trainer = posthoc.build(args, "cpu")
    trainer.init(7)  # not the config's seed, which the CLI's trainer starts from
    gen = torch.Generator().manual_seed(0)
    root = str(tmp_path / "saved_models")
    ckpt.save_train_state(ckpt.train_state_path("run", 7, root),
                          {"trainer": trainer.state(), "generator": gen.get_state()})
    ckpt.save_laligan("run", trainer, root)
    from_snap = posthoc.run("run", epoch=7, ckpt_root=root, save_root=str(tmp_path / "out"),
                            extra=SMALL, device="cpu")
    from_art = posthoc.run("run", ckpt_root=root, save_root=str(tmp_path / "out"),
                           extra=SMALL, device="cpu")
    assert from_snap["dir"].endswith("run-sindy-ep7") and from_art["dir"].endswith("run-sindy")
    np.testing.assert_array_equal(from_snap["Xi"], from_art["Xi"])
    np.testing.assert_array_equal(from_snap["mask"], from_art["mask"])
    assert from_snap["resid"] == from_art["resid"]
    fresh = posthoc.fit(posthoc.build(args, "cpu"), *(torch.as_tensor(a) for a in data_env[1:]))
    assert fresh["resid"] != from_snap["resid"]


def test_tracked_nonjoint_ep90_fits_to_zero(tmp_path, monkeypatch):
    """The tracked non-joint rd checkpoint at epoch 90, full width, on the
    port's full-size rd data: Xi masked to 0 (RESULTS.md's negative result
    of the JAX tool)."""
    sim = simulate_rd(device="cpu")
    save_rd_mat(str(tmp_path / "reaction_diffusion.mat"), *sim)
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", str(tmp_path))
    out = posthoc.run("laligan-rd-nonjoint-s42-ep90",
                      ckpt_root=os.path.join(REPO, "saved_models"),
                      save_root=str(tmp_path / "out"), device="cpu")
    assert out["windows"] == 158 and np.isfinite(out["resid"]) and out["resid"] > 0
    assert not out["mask"].any() and not out["Xi_masked"].any()
