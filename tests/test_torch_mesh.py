"""The port's multi-device layer (parallel/mesh.py) against its single-device
runs and the JAX package's mesh runs, on the CPU.

The port shards over an explicit 8-entry CPU ``Mesh`` (make_mesh takes CUDA
devices only); the JAX package over ``make_mesh(8)`` on the eight virtual
CPU devices of tests/conftest.py. Bars:
- a sweep's lanes are independent, so a sharded K1 or STLSQ sweep equals
  the port's unsharded one bit for bit; the WSINDy sweep's batched matrix
  products round by their batch's size, so its masks and forms are equal
  and its coefficients within 1e-5 of their scale (tests/test_torch_wsindy.py's
  bar); against the JAX package's mesh run, masks and forms equal and
  coefficients within 1e-3 (the repository's bar,
  tests/test_pallas_lbfgs.py:68-69);
- the host-stepped EquivSINDy-r sweep (shard_stepper): masks identical to
  the port's unsharded run and the JAX package's shard_stepper, the
  coefficients within tests/test_sweep.py's rtol 0.1 and atol 5e-3 of
  JAX's, and in float64 within 1e-9 of the port's unsharded run;
- the GP sweep with 6 units on 8 shards (padded): tapes identical, best_fit
  and constants within 1e-4 (tests/test_gp_sweep.py:66-93).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.cli.main_gp import _task_spec as j_task_spec
from symmetry_ode_discovery_tpu.evaluation import sindy_truth as jax_truth
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.parallel import mesh as jmesh
from symmetry_ode_discovery_tpu.symgp import evolve as je
from symmetry_ode_discovery_tpu.symgp import sweep as js
from symmetry_ode_discovery_tpu.training import sweep as jsweep
from symmetry_ode_discovery_tpu.training.siged import LBFGSHParams as JaxHParams

from symmetry_ode_discovery_tpu_torch.cli.main_gp import _task_spec
from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_sweep
from symmetry_ode_discovery_tpu_torch.symgp import evolve as te
from symmetry_ode_discovery_tpu_torch.symgp import sweep as ts
from symmetry_ode_discovery_tpu_torch.training import sweep
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams

from test_torch_sweep import SO2, _data

CPU8 = Mesh(("cpu",) * 8)
SEEDS = list(range(8))


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads: the suite runs several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_idx(n, k, seeds):
    """The JAX package's per-seed subsample rows (training/sweep.py)."""
    return np.stack([np.asarray(jax.random.permutation(jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), s))[0], n)[:k]) for s in seeds])


def _assert_same(got, want):
    for a, b in zip((got.Xi, got.mask, got.correct_form, got.mse),
                    (want.Xi, want.mask, want.correct_form, want.mse)):
        np.testing.assert_array_equal(a, b)


def test_make_mesh_needs_cuda_devices():
    assert jax.device_count() == 8
    for n in (2, None):
        with pytest.raises(ValueError, match="only 0 CUDA devices exist"):
            make_mesh(n)


def test_mesh_slices_and_gather_keep_lane_order():
    mesh = Mesh(("cpu",) * 4, axis="batch")
    assert mesh.size == 4 and mesh.devices[0] == torch.device("cpu")
    assert mesh.slices(8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="do not divide"):
        mesh.slices(6)
    seen = []

    def run(lanes, dev):
        seen.append(list(lanes))
        return torch.tensor(lanes, device=dev), {"twice": 2 * torch.tensor(lanes)}

    out, d = shard_sweep(run, mesh)(list(range(8)))
    assert seen == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert out.tolist() == list(range(8)) and d["twice"].tolist() == list(range(0, 16, 2))


@pytest.mark.parametrize("constrained", [False, True], ids=["sindy", "esindy"])
def test_sharded_k1_sweep_matches_unsharded_and_jax(constrained):
    ckw = dict(L_list=[SO2]) if constrained else {}
    x, dx = _data("dosc", 20, 200, 0.01, 0.02)
    hp_kw = dict(num_epochs=30, sindy_reg_type="none", lr_sindy=1.0, st_freq=10,
                 threshold=5e-2)
    cfg, Q = make_config(2, poly_order=2, threshold=5e-2, **ckw)
    k = x.shape[0] // 2
    idx = _jax_idx(x.shape[0], k, SEEDS)
    jcfg, jQ = jmake_config(2, poly_order=2, threshold=5e-2, **ckw)
    _, _, n_params = jsweep._pallas_setup(jcfg, jQ, JaxHParams(**hp_kw))
    th0 = np.asarray(jsweep._prep_normal_eq(jcfg, k, n_params, jnp.asarray(x), jnp.asarray(dx),
                                            jnp.asarray(SEEDS), jnp.asarray(idx))[4])
    run = lambda **kw: sweep.sweep_sindy_lbfgs(
        cfg, Q, x, dx, sindy_truth["dosc"], LBFGSHParams(**hp_kw), SEEDS, lbfgs_subsample=0.5,
        subsample_idx=idx, theta0=th0, device="cpu", **kw)
    one, sharded = run(), run(mesh=CPU8)
    _assert_same(sharded, one)
    ref = jsweep._pallas_lbfgs_sweep(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx),
                                     jax_truth["dosc"], JaxHParams(**hp_kw), np.asarray(SEEDS),
                                     k, interpret=True, subsample_idx=idx,
                                     mesh=jmesh.make_mesh(8))
    np.testing.assert_array_equal(sharded.mask, np.asarray(ref.mask).reshape(sharded.mask.shape))
    np.testing.assert_array_equal(sharded.correct_form, np.asarray(ref.correct_form))
    np.testing.assert_allclose(sharded.Xi, np.asarray(ref.Xi), atol=1e-3)


def test_sharded_stacked_sweep_matches_unsharded_and_jax():
    cfg, Q = make_config(2, poly_order=2, L_list=[SO2], threshold=5e-2)
    hp_kw = dict(num_epochs=20, lr_sindy=1.0, sindy_reg_type="none", st_freq=10,
                 threshold=5e-2)
    sets = [_data("dosc", 20, 200, 0.01, noise, seed=s) for s, noise in enumerate([0.0, 0.05])]
    xs, dxs = [d[0] for d in sets], [d[1] for d in sets]
    run = lambda **kw: sweep.sweep_sindy_lbfgs_stacked(
        cfg, Q, xs, dxs, sindy_truth["dosc"], LBFGSHParams(**hp_kw), SEEDS,
        lbfgs_subsample=0.5, device="cpu", **kw)
    one, sharded = run(), run(mesh=Mesh(("cpu",) * 4))
    assert len(sharded) == 2
    for a, b in zip(sharded, one):
        _assert_same(a, b)
    # each dataset's lanes against the JAX package's stacked sweep on its
    # mesh, fed the port's draws of the first dataset's N
    jcfg, jQ = jmake_config(2, poly_order=2, L_list=[SO2], threshold=5e-2)
    k = xs[0].shape[0] // 2
    for (x, dx), res in zip(sets, sharded):
        idx = sweep._subsample_idx(SEEDS, x.shape[0], k, "cpu").numpy()
        ref = jsweep._pallas_lbfgs_sweep(jcfg, jQ, jnp.asarray(x), jnp.asarray(dx),
                                         jax_truth["dosc"], JaxHParams(**hp_kw),
                                         np.asarray(SEEDS), k, interpret=True, subsample_idx=idx,
                                         mesh=jmesh.make_mesh(8))
        # the JAX sweep draws its own theta0; the protocol converges to the
        # subsample's optimum, so its masks and forms must still agree
        np.testing.assert_array_equal(res.mask, np.asarray(ref.mask).reshape(res.mask.shape))
        np.testing.assert_array_equal(res.correct_form, np.asarray(ref.correct_form))
        np.testing.assert_allclose(res.Xi, np.asarray(ref.Xi), atol=1e-3)


def test_sharded_stlsq_matches_unsharded_and_jax_8_devices():
    x, dx = _data("dosc", 20, 200, 0.01, 0.02)
    cfg, _ = make_config(2, poly_order=2)
    k = x.shape[0] // 2
    idx = _jax_idx(x.shape[0], k, SEEDS)
    run = lambda **kw: sweep.sweep_sindy_stlsq(cfg, None, x, dx, sindy_truth["dosc"], SEEDS,
                                               threshold=5e-2, subsample=0.5, subsample_idx=idx,
                                               device="cpu", **kw)
    one, sharded = run(), run(mesh=CPU8)
    _assert_same(sharded, one)
    jcfg, _ = jmake_config(2, poly_order=2)
    ref = jsweep.sweep_sindy_stlsq(jcfg, None, jnp.asarray(x), jnp.asarray(dx),
                                   jax_truth["dosc"], seeds=np.asarray(SEEDS), threshold=5e-2,
                                   subsample=0.5)  # every one of the 8 devices
    np.testing.assert_array_equal(sharded.mask, np.asarray(ref.mask))
    np.testing.assert_array_equal(sharded.correct_form, np.asarray(ref.correct_form))
    np.testing.assert_allclose(sharded.Xi, np.asarray(ref.Xi), atol=1e-3)
    assert sharded.correct_form.all()


def test_sharded_wsindy_matches_unsharded_and_jax_8_devices():
    from symmetry_ode_discovery_tpu.data import datasets as jax_datasets
    from test_torch_wsindy import _configs, _trajs

    task, cfg, jcfg, gamma, thr = _configs("growth_ridge")
    x = _trajs(task, n_ics=5, seed=3, noise=0.01)
    dt = jax_datasets.ode_dt_dict[task]
    n_ics, n_steps, _ = x.shape
    w = int(0.8 * n_steps)
    # the JAX package's per-seed windows (training/sweep.py, subsample_rng "jax")
    windows = []
    for s in SEEDS:
        k1, k2, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), s), 3)
        windows.append((int(jax.random.randint(k1, (), 0, n_steps - w)),
                        int(jax.random.randint(k2, (), 0, n_ics))))
    run = lambda **kw: sweep.sweep_wsindy(cfg, x, dt, jax_truth[task], SEEDS, w_sindy_reg=gamma,
                                          threshold=thr, windows=np.asarray(windows),
                                          device="cpu", **kw)
    one, sharded = run(), run(mesh=CPU8)
    for a, b in ((sharded.mask, one.mask), (sharded.correct_form, one.correct_form)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(sharded.Xi, one.Xi, rtol=0, atol=1e-5 * np.abs(one.Xi).max())
    ref = jsweep.sweep_wsindy(jcfg, jnp.asarray(x), dt, jax_truth[task], np.asarray(SEEDS),
                              w_sindy_reg=gamma, threshold=thr)  # every one of the 8 devices
    np.testing.assert_array_equal(sharded.mask, np.asarray(ref.mask))
    np.testing.assert_array_equal(sharded.correct_form, np.asarray(ref.correct_form))
    np.testing.assert_allclose(sharded.Xi, np.asarray(ref.Xi), rtol=0, atol=1e-3)


def test_unsharded_when_the_mesh_does_not_divide_the_seeds(capsys):
    x, dx = _data("dosc", 20, 200, 0.01, 0.02)
    cfg, _ = make_config(2, poly_order=2)
    got = sweep.sweep_sindy_stlsq(cfg, None, x, dx, sindy_truth["dosc"], SEEDS[:6],
                                  subsample=0.5, device="cpu", mesh=Mesh(("cpu",) * 4))
    assert "6 seeds not divisible by 4 devices; running on one device" in capsys.readouterr().out
    one = sweep.sweep_sindy_stlsq(cfg, None, x, dx, sindy_truth["dosc"], SEEDS[:6],
                                  subsample=0.5, device="cpu")
    _assert_same(got, one)


@pytest.mark.parametrize("mode", ["plain", "system"])
def test_sharded_gp_sweep_pads_and_matches(mode):
    """6 units on 8 shards: 2 padding units that never breed."""
    from test_torch_gp import _assert_same_tapes, _lv_data

    X, dX, gx, Jg = _lv_data(S=3 if mode == "plain" else 6, N=64)
    kw = dict(pop_size=64, n_generations=5)
    cfg_j, cfg_t = je.GPConfig(**kw), te.GPConfig(**kw)
    seeds = list(range(X.shape[0]))
    if mode == "plain":
        run = lambda **m: ts.gp_sweep_plain(X, dX, _task_spec("lv", 2), cfg_t, seeds,
                                            const_subsample=32, device="cpu", **m)
        pj, rj = js.gp_sweep_plain(X, dX, j_task_spec("lv", 2), cfg_j, seeds,
                                   const_subsample=32, mesh=jmesh.make_mesh(8, axis="seed"))
    else:
        run = lambda **m: ts.gp_sweep_system(X, dX, _task_spec("lv", 2), cfg_t, seeds,
                                             gx_all=gx, Jgx_all=Jg, w_sym_reg=0.1,
                                             const_subsample=32, device="cpu", **m)
        pj, rj = js.gp_sweep_system(X, dX, j_task_spec("lv", 2), cfg_j, seeds, gx_all=gx,
                                    Jgx_all=Jg, w_sym_reg=0.1, const_subsample=32,
                                    mesh=jmesh.make_mesh(8, axis="seed"))
    p1, r1 = run()
    p8, r8 = run(mesh=CPU8)
    assert len(r8.best_fit) == 6
    flat = lambda p: [b for s in p for b in s]
    for a, b in zip(flat(p8), flat(p1)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(r8.best_fit, r1.best_fit)
    np.testing.assert_allclose(r8.best_fit, np.asarray(rj.best_fit), rtol=1e-4)
    _assert_same_tapes(flat(pj), flat(p8))


@pytest.fixture(scope="module")
def stepper_setup():
    """tests/test_sweep.py:92-145's set-up: a small BatchNorm autoencoder,
    the '(2,1,2)' generator, 8 seeds of 64 dosc rows, 4 epochs of L-BFGS
    with the symreg_i penalty; the JAX package's shard_stepper run on its
    8-device mesh, and its per-seed draws for the port."""
    from symmetry_ode_discovery_tpu.models import lie_generator as jlg
    from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
    from symmetry_ode_discovery_tpu.ops.integrators import solve_ode_batch
    from symmetry_ode_discovery_tpu.data.systems import SYSTEMS
    from symmetry_ode_discovery_tpu.training import siged as jsiged
    from symmetry_ode_discovery_tpu.training.symmreg import make_symmreg_i_fast as jfast

    kw = dict(input_dim=2, hidden_dim=16, latent_dim=2, n_layers=2, n_comps=2,
              batch_norm=True, ortho_ae=True)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    spec = jlg.parse_repr("(2,1,2)", "0")
    g_state = jlg.init_generator(jax.random.PRNGKey(1), spec)
    prep, pen = jfast(ae_def, params, bstats, spec, g_state, 0.1, 0.01)
    sys_ = SYSTEMS["dosc"]
    x, dx = solve_ode_batch(sys_.f, sys_.sample_ics(jax.random.PRNGKey(0), 8), dt=0.01,
                            num_steps=50)
    xf, dxf = x.reshape(-1, 2), dx.reshape(-1, 2)
    n = xf.shape[0]
    cfg, _ = jmake_config(2, poly_order=2)
    hp = dict(num_epochs=4, inner_iters=5, lr_sindy=0.5, sindy_reg_type="none", st_freq=2,
              threshold=5e-2, w_sym_reg=0.1)
    init_f, step_f, extract_f = jsiged.make_lbfgs_stepper(
        cfg, None, JaxHParams(**hp), pen, sym_reg_prep=prep, epochs_per_call=2)
    init_params = jsiged._make_param_fns(cfg, None)[0]

    def prep_seed(s):
        kk = jax.random.fold_in(jax.random.PRNGKey(0), s)
        kperm, kfit, _ = jax.random.split(kk, 3)
        idx = jax.random.permutation(kperm, n)[:64]
        return xf[idx], dxf[idx], kfit

    prep_j, init_j, step_j, ext_j = jmesh.shard_stepper(prep_seed, init_f, step_f, extract_f,
                                                        jmesh.make_mesh(8))
    carry = init_j(*prep_j(jnp.arange(8)))
    for e in range(0, hp["num_epochs"], 2):
        carry = step_j(carry, e)
    Xi_j, mask_j = ext_j(carry)
    idx, theta0 = [], []
    for s in SEEDS:
        kk = jax.random.fold_in(jax.random.PRNGKey(0), s)
        kperm, kfit, _ = jax.random.split(kk, 3)
        idx.append(np.asarray(jax.random.permutation(kperm, n)[:64]))
        theta0.append(np.asarray(init_params(kfit)["Xi"]))
    from symmetry_ode_discovery_tpu_torch import convert
    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.models.autoencoder import (
        AutoEncoder, AutoEncoderConfig)

    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in f)
                                for f in (g_state.Li, g_state.sigma, g_state.struct_const,
                                          g_state.masks)))
    return dict(ae=ae.eval().requires_grad_(False), state=state, x=np.asarray(xf),
                dx=np.asarray(dxf), idx=np.stack(idx), theta0=np.stack(theta0), hp=hp,
                Xi_j=np.asarray(Xi_j), mask_j=np.asarray(mask_j))


def _port_stepped(setup, tmp_path, mesh=None):
    """cli/main.py's host-stepped fit on the JAX draws (a draws file, as
    tools/dump_jax_draws.py writes it), sharded over ``mesh``."""
    from symmetry_ode_discovery_tpu_torch.cli.main import _run_stepped
    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.training.symmreg import make_symmreg_i_fast

    path = tmp_path / "draws.npz"
    np.savez(path, seeds=np.asarray(SEEDS), idx=setup["idx"], theta0=setup["theta0"])
    prep, pen = make_symmreg_i_fast(setup["ae"], lg.parse_repr("(2,1,2)", "0"), setup["state"],
                                    0.1, 0.01)
    cfg, _ = make_config(2, poly_order=2)
    args = {"save_dir": "stepped", "epochs_per_call": 2, "seed_chunk": 8,
            "subsample_perms": str(path)}
    return _run_stepped(args, cfg, None, LBFGSHParams(**setup["hp"]), pen, prep,
                        torch.tensor(setup["x"]), torch.tensor(setup["dx"]), 64, SEEDS, None,
                        str(tmp_path / "ev"), "cpu", resume=False, mesh=mesh)


def test_sharded_stepper_matches_unsharded_and_jax_shard_stepper(stepper_setup, tmp_path):
    one = _port_stepped(stepper_setup, tmp_path)
    sharded = _port_stepped(stepper_setup, tmp_path, mesh=CPU8)
    np.testing.assert_array_equal(sharded["mask"], one["mask"])
    np.testing.assert_array_equal(sharded["mask"], stepper_setup["mask_j"])
    np.testing.assert_allclose(sharded["Xi"], stepper_setup["Xi_j"], rtol=0.1, atol=5e-3)
    assert sharded["stop_epoch"] == one["stop_epoch"]


def test_sharded_stepper_float64_matches_unsharded(stepper_setup):
    """In float64 (the composed symreg_i penalty: the fused one runs in f32
    or bf16) the sharded and unsharded runs differ only by the batch size
    of their batched products: within 1e-9."""
    import copy

    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.parallel.mesh import shard_stepper
    from symmetry_ode_discovery_tpu_torch.training.siged import (
        make_lbfgs_stepper, make_sym_reg_fn)

    f64 = torch.float64
    ae = copy.deepcopy(stepper_setup["ae"]).to(f64)
    st = stepper_setup["state"]
    state = lg.GeneratorState(*(tuple(t.to(f64) for t in f)
                                for f in (st.Li, st.sigma, st.struct_const, st.masks)))
    pen = make_sym_reg_fn(ae, lg.parse_repr("(2,1,2)", "0"), state, "i", 0.1, 0.01)
    cfg, _ = make_config(2, poly_order=2)
    init, step, extract = make_lbfgs_stepper(cfg, None, LBFGSHParams(**stepper_setup["hp"]),
                                             pen, None, epochs_per_call=2)
    x, dx = (torch.tensor(stepper_setup[k], dtype=f64) for k in ("x", "dx"))
    idx = torch.as_tensor(stepper_setup["idx"])
    th0 = torch.tensor(stepper_setup["theta0"], dtype=f64).reshape(8, -1)

    def prep(lanes, dev):
        lanes = list(lanes)
        return x[idx[lanes]].to(dev), dx[idx[lanes]].to(dev), th0[lanes].to(dev)

    carry = init(*prep(SEEDS, "cpu"))
    for e in (0, 2):
        carry = step(carry, e)
    Xi1, m1 = extract(carry)
    prep_s, init_s, step_s, ext_s = shard_stepper(prep, init, step, extract, CPU8)
    carry = init_s(prep_s(SEEDS))
    for e in (0, 2):
        carry = step_s(carry, e)
    Xi8, m8 = ext_s(carry)
    assert Xi8.dtype == f64
    np.testing.assert_array_equal(m8.numpy(), m1.numpy())
    np.testing.assert_allclose(Xi8.detach().numpy(), Xi1.detach().numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("cli", ["main_sindy", "main_wsindy"])
def test_sindy_and_wsindy_clis_no_longer_ignore_mesh_devices(cli, tmp_path):
    """--mesh_devices 2 reaches the sweep, which asks make_mesh for two CUDA
    devices: here there are none."""
    from symmetry_ode_discovery_tpu_torch.cli import main_sindy, main_wsindy
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    mod = {"main_sindy": main_sindy, "main_wsindy": main_wsindy}[cli]
    cfg = "dosc/noise20_sindy.cfg" if cli == "main_sindy" else "dosc/noise20_wsindy.cfg"
    args = vars(get_args(["--config", cfg, "--n_seeds", "4", "--mesh_devices", "2",
                          "--eval_root", str(tmp_path), "--save_root", str(tmp_path)]))
    x = _data("dosc", 4, 100, 0.01, 0.02)[0].reshape(4, 100, 2)
    with pytest.raises(ValueError, match="2-device mesh but only 0 CUDA devices"):
        mod.run(args, train_data=(x, x), device="cpu")
    assert not any(tmp_path.iterdir())


def test_cli_stepper_on_an_explicit_mesh_equals_unsharded(tmp_path):
    """cli/main.py::run with ``mesh``: the EquivSINDy-r chunk of 3 seeds is
    rounded up to 4 lanes over a 2-entry mesh (the tail padded with its last
    seed), with the same result as the unsharded run."""
    import os

    from symmetry_ode_discovery_tpu_torch.cli.main import run
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args
    from test_torch_cli import _lv_data

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--config", "lv/noise99_eq_isymreg.cfg", "--n_seeds", "3", "--seed", "0",
            "--seed_chunk", "3", "--num_epochs", "4", "--epochs_per_call", "2"]
    outs = []
    for mesh in (None, Mesh(("cpu",) * 2)):
        args = vars(get_args(argv + ["--eval_root", str(tmp_path / str(mesh is None))]))
        outs.append(run(args, train_data=_lv_data(2000), device="cpu",
                        ckpt_root=os.path.join(repo, "saved_models"), mesh=mesh))
    one, sharded = outs
    np.testing.assert_array_equal(sharded["mask"], one["mask"])
    np.testing.assert_allclose(sharded["Xi"], one["Xi"], rtol=0, atol=1e-6)
    assert sharded["epochs_run"] == one["epochs_run"]
