"""The slice as a whole: the port's host-stepped EquivSINDy-r L-BFGS sweep
(training/siged.py::make_lbfgs_stepper with the fused-rollout penalty of
training/symmreg.py) against the JAX package's make_lbfgs_stepper driven the
same way.

3 lanes of 200 rows, drawn from one dataset by the JAX package's per-seed
subsample (cli/main.py's fold_in / split / permutation) and started from
its per-seed initial coefficients, both fed to the port. Small AE (hidden
64, 3 layers), '(2,1,2)' generator, poly2 library, lr 1.0, 6 epochs with
st_freq 2 and threshold 5e-2, so thresholding and convergence stops fire.
The bar is the repository's (tests/test_pallas_lbfgs.py:68-69): masks equal
at every epoch, stop epochs equal, coefficients within 1e-3.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.training import siged as jsiged
from symmetry_ode_discovery_tpu.training.symmreg import make_symmreg_i_fast as jfast

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.cli.main import _run_stepped
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams, make_lbfgs_stepper
from symmetry_ode_discovery_tpu_torch.training.symmreg import make_symmreg_i_fast

SEEDS = (0, 1, 2)
N, K, EPOCHS = 2000, 200, 6
HP = dict(num_epochs=EPOCHS, lr_sindy=1.0, w_sindy_x=1.0, w_sindy_reg=0.0,
          sindy_reg_type="l1", w_sym_reg=0.1, st_freq=2, threshold=5e-2)


@pytest.fixture(scope="module")
def reference():
    kw = dict(input_dim=2, hidden_dim=64, latent_dim=2, n_layers=3, n_comps=2,
              batch_norm=True, ortho_ae=True)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(3))
    spec_j = jlg.parse_repr("(2,1,2)", "0")
    gs = jlg.init_generator(jax.random.PRNGKey(4), spec_j)
    rng = np.random.default_rng(5)
    x_all = rng.standard_normal((N, 2)).astype(np.float32)
    A = np.array([[-0.1, -1.0], [1.0, -0.1]], np.float32)
    dx_all = (x_all @ A.T + 0.05 * rng.standard_normal((N, 2))).astype(np.float32)

    cfg_j, _ = jmake_config(2, poly_order=2)
    init_params, _ = jsiged._make_param_fns(cfg_j, None)
    idx, theta0 = [], []
    for s in SEEDS:  # the JAX CLI's per-seed draws (cli/main.py:359-363)
        kk = jax.random.fold_in(jax.random.PRNGKey(0), s)
        kperm, kfit, _ = jax.random.split(kk, 3)
        idx.append(np.asarray(jax.random.permutation(kperm, N)[:K]))
        theta0.append(np.asarray(init_params(kfit)["Xi"]).reshape(-1))
    idx, theta0 = np.stack(idx), np.stack(theta0)

    prep_j, pen_j = jfast(ae_def, params, bstats, spec_j, gs, 0.1, 0.01,
                          fused_rollout_lib=cfg_j.library)
    init_f, step_f, ext_f = jsiged.make_lbfgs_stepper(
        cfg_j, None, jsiged.LBFGSHParams(**HP), pen_j, sym_reg_prep=prep_j, epochs_per_call=1)
    carry = jax.jit(jax.vmap(lambda x, dx, p: init_f(x, dx, None, params0={"Xi": p})))(
        jnp.asarray(x_all[idx]), jnp.asarray(dx_all[idx]), jnp.asarray(theta0.reshape(-1, 2, 6)))
    step_j = jax.jit(jax.vmap(step_f, in_axes=(0, None)))
    per_epoch = []
    for e in range(EPOCHS):
        carry = step_j(carry, e)
        Xi, mask = jax.vmap(ext_f)(carry)
        per_epoch.append((np.asarray(Xi), np.asarray(mask)))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in f)
                                for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks)))
    return dict(ae=ae.eval(), state=state, x=x_all[idx], dx=dx_all[idx], theta0=theta0,
                per_epoch=per_epoch, stop=np.asarray(carry["stop_epoch"]), x_all=x_all,
                dx_all=dx_all, idx=idx, cfg_j=cfg_j)


def _penalty(ref, pallas):
    cfg, _ = make_config(2, poly_order=2)
    prep, pen = make_symmreg_i_fast(ref["ae"], lg.parse_repr("(2,1,2)", "0"), ref["state"],
                                    0.1, 0.01, pallas=pallas, fused_rollout_lib=cfg.library)
    return cfg, prep, pen


def _port_run(ref, pallas, dir_backend, epochs_per_call):
    cfg, prep, pen = _penalty(ref, pallas)
    init, step, extract = make_lbfgs_stepper(
        cfg, None, LBFGSHParams(dir_backend=dir_backend, **HP), pen, prep,
        epochs_per_call=epochs_per_call)
    carry = init(torch.tensor(ref["x"]), torch.tensor(ref["dx"]), torch.tensor(ref["theta0"]))
    per_call = []
    for e in range(0, EPOCHS, epochs_per_call):
        carry = step(carry, e)
        Xi, mask = extract(carry)
        per_call.append((Xi.detach().numpy(), mask.numpy()))
    return per_call, carry["stop_epoch"].numpy()


@pytest.mark.parametrize("pallas,dir_backend", [(False, "xla"), (True, "pallas")],
                         ids=["autodiff-xla", "kernels-pallas"])
def test_stepper_matches_jax_every_epoch(reference, pallas, dir_backend):
    per_epoch, stop = _port_run(reference, pallas, dir_backend, 1)
    for e, ((Xi, mask), (Xi_j, mask_j)) in enumerate(zip(per_epoch, reference["per_epoch"])):
        np.testing.assert_array_equal(mask, mask_j, err_msg=f"epoch {e}")
        np.testing.assert_allclose(Xi * mask, Xi_j * mask_j, atol=1e-3, err_msg=f"epoch {e}")
    np.testing.assert_array_equal(stop, reference["stop"])
    # thresholding fired: some term was cut on every lane
    assert (per_epoch[-1][1] == 0).any(axis=(1, 2)).all()


def test_stepper_epochs_past_budget_are_no_ops(reference):
    """4 epochs per call over a 6-epoch budget: the second call's epochs 6
    and 7 change nothing, so the result equals the JAX run's after epoch 5."""
    per_call, stop = _port_run(reference, False, "xla", 4)
    Xi, mask = per_call[-1]
    Xi_j, mask_j = reference["per_epoch"][-1]
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_allclose(Xi * mask, Xi_j * mask_j, atol=1e-3)
    np.testing.assert_array_equal(stop, reference["stop"])


def test_cli_stepper_on_dumped_draws(reference, tmp_path):
    """The CLI's host-stepped fit (cli/main.py::_run_stepped) fed the draws
    file tools/dump_jax_draws.py writes (theta0 in the JAX layout, Xi (d, p))
    equals the JAX stepper on the same draws, in chunks of 2 with the tail
    chunk padded by its last seed."""
    spec = importlib.util.spec_from_file_location(
        "dump_jax_draws", Path(__file__).resolve().parents[1] / "tools" / "dump_jax_draws.py")
    dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dump)
    idx, theta0 = dump.stepped_draws(reference["cfg_j"], None, N, K, SEEDS)
    np.testing.assert_array_equal(idx, reference["idx"])
    np.testing.assert_array_equal(theta0.reshape(len(SEEDS), -1), reference["theta0"])
    assert theta0.shape == (len(SEEDS), 2, 6)
    path = tmp_path / "draws.npz"
    np.savez(path, seeds=np.asarray(SEEDS, np.int32), idx=idx, theta0=theta0)
    cfg, prep, pen = _penalty(reference, True)
    args = {"save_dir": "stepped", "epochs_per_call": 1, "seed_chunk": 2,
            "subsample_perms": str(path)}
    out = _run_stepped(args, cfg, None, LBFGSHParams(dir_backend="pallas", **HP), pen, prep,
                       torch.tensor(reference["x_all"]), torch.tensor(reference["dx_all"]), K,
                       list(SEEDS), None, str(tmp_path / "ev"), "cpu", resume=False)
    Xi_j, mask_j = reference["per_epoch"][-1]
    np.testing.assert_array_equal(out["mask"], mask_j)
    np.testing.assert_allclose(out["Xi"] * out["mask"], Xi_j * mask_j, atol=1e-3)
    np.testing.assert_array_equal(out["stop_epoch"], reference["stop"])
    assert len(out["epochs_run"]) == 2  # seeds (0, 1), then (2, 2)
    assert not (tmp_path / "ev").exists()
