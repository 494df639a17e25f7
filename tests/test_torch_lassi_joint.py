"""The port's joint SINDy-in-latent LaLiGAN training (training/lassi.py's
include_sindy branches) and what it runs, against the JAX package's on the
same inputs, on the CPU.

Small size: the reaction-diffusion pipeline on a 4 x 4 grid (the port's
solver, 201 samples, the 158 train windows of two snapshots, 16 inputs),
autoencoder and discriminator 2 x 32, batch 64, repr (2,1,2) with
rd/sym_eq.cfg's weights. The JAX trainer's init passes to the port through
convert.lassi_from_jax; its coefficient draws are rebuilt from its keys
(tools/dump_jax_draws.py). Tolerances:
- the pushforwards compute_dz, compute_dx and iga (mlp and mlp_split, with
  BatchNorm and the orthogonal layer) and their parameter gradients:
  float64 within 1e-10 relative (a tensor's max |diff| over its max
  |value|); mlp_split's forward on converted weights in f32 within 1e-6;
- m_weight_tensor equal; get_Q_padded's projector Q Q^T (the basis is
  unique only up to rotation and sign) within 1e-10 in float64 on both
  det branches, a two-channel stack and a full-rank constraint;
- one joint step (least squares with and without the constraint, two
  steps with the stale Q in between, and the Adam branch) in float64: the
  loss components, every updated parameter, Xi, the mask, Q Q^T and L_prev
  within 1e-9 relative of the JAX trainer's under jax.enable_x64 (the
  biases feeding a training BatchNorm whose exact gradient is 0 apart:
  their step within lr);
- three epochs with thresholding after each and the last batch's Q
  recompute: in float64 within 1e-9 of the JAX trainer's float64 run on the
  same draws, in f32 within 1e-3 of it, and within 1e-3 of the JAX f32
  epochs or twice their own distance from their float64 run; the masks
  equal;
- --resume with the joint state bit-identical to an uninterrupted run;
  regressor.npz read by the JAX package's load_pytree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.discriminator import Discriminator as JDisc
from symmetry_ode_discovery_tpu.ops import constraint as jcon
from symmetry_ode_discovery_tpu.ops.library import FunctionLibrary as JLib
from symmetry_ode_discovery_tpu.training import lassi as jlassi
from symmetry_ode_discovery_tpu.utils import checkpoint as jckpt

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.data.datasets import MultiTimestepReactionDiffusionDataset
from symmetry_ode_discovery_tpu_torch.data.rd_solver import simulate_rd
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.discriminator import Discriminator
from symmetry_ode_discovery_tpu_torch.models.mlp import init_flax_
from symmetry_ode_discovery_tpu_torch.ops import constraint
from symmetry_ode_discovery_tpu_torch.ops.library import FunctionLibrary
from symmetry_ode_discovery_tpu_torch.training import lassi
from symmetry_ode_discovery_tpu_torch.utils import checkpoint as ckpt

from test_torch_lassi import DUMP, _bn_fed_biases, _nrel, _rel

AE_KW = dict(ae_arch="mlp", input_dim=16, hidden_dim=32, latent_dim=2, n_layers=2, n_comps=2,
             batch_norm=True, ortho_ae=True)
# rd/sym_eq.cfg's weights
HP_KW = dict(batch_size=64, lr_ae=3e-4, w_gan=0.01, w_reg_norm=0.0, w_reg_sim=0.1,
             gan_st_thres=0.05, include_sindy=True, eq_constraint=True, w_sindy_z=0.1,
             w_sindy_x=0.0)


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
def rd_windows():
    """(x, dx): the 158 train windows (2, 16) of the port's solver on a 4 x 4
    grid, as numpy float32."""
    t, xg, yg, uf, duf = simulate_rd(n=4, device="cpu")
    data = {"t": t.reshape(-1, 1), "x": xg.reshape(-1, 1), "y": yg.reshape(-1, 1),
            "uf": uf.numpy(), "duf": duf.numpy()}
    ds = MultiTimestepReactionDiffusionDataset(data, "train", device="cpu")
    return ds.x.numpy(), ds.dx.numpy()


# --- the pushforwards ---


def _ae_pair(arch, seed=0):
    """(JAX def, params, batch stats with random running statistics, port
    AutoEncoder in float64 with the same weights)."""
    kw = dict(AE_KW, ae_arch=arch)
    jdef = AutoEncoderDef(**kw)
    params, bstats = jdef.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    bstats = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape) if "var" in str(path[-1])
                                    else rng.normal(0.0, 0.3, a.shape), jnp.float32), bstats)
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    return jdef, params, bstats, ae.double()


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("arch", ["mlp", "mlp_split"])
def test_pushforwards_and_their_gradients_match_jax(arch):
    jdef, params, bstats, ae = _ae_pair(arch)
    rng = np.random.default_rng(1)
    x, dx = rng.normal(size=(2, 8, 2, 16))
    dz = rng.normal(size=(8, 2, 2))
    g = rng.normal(size=(4, 4))
    ct_z, ct_x = rng.normal(size=(8, 2, 2)), rng.normal(size=(8, 2, 16))
    named = dict(ae.named_parameters())
    jfns = {
        "compute_dz": (lambda p, bs: jdef.compute_dz(p, bs, x, dx), ct_z),
        "compute_dx": (lambda p, bs: jdef.compute_dx(p, jdef.encode(p, bs, x)[0], dz), ct_x),
        "iga": (lambda p, bs: jdef.iga(p, bs, g, x), ct_x),
    }
    tfns = {
        "compute_dz": lambda: ae.compute_dz(torch.tensor(x), torch.tensor(dx)),
        "compute_dx": lambda: ae.compute_dx(ae.encode(torch.tensor(x)), torch.tensor(dz)),
        "iga": lambda: ae.iga(torch.tensor(g), torch.tensor(x)),
    }
    with jax.enable_x64(True):
        p64, bs64 = _f64(params), _f64(bstats)
        for name, (jf, ct) in jfns.items():
            val = np.asarray(jf(p64, bs64))
            gw = jax.grad(lambda p: jnp.sum(jf(p, bs64) * ct))(p64)
            got = tfns[name]()
            assert _rel(got.detach(), val) <= 1e-10, name
            grads = torch.autograd.grad((got * torch.tensor(ct)).sum(), list(named.values()),
                                        allow_unused=True)
            want_g = convert.autoencoder_from_jax(
                jax.tree_util.tree_map(np.asarray, gw), jax.tree_util.tree_map(np.asarray, bs64),
                "cpu", torch.float64)
            scale = max(float(want_g[k].abs().max()) for k in named)
            for (k, _), gt in zip(named.items(), grads):
                gt = torch.zeros_like(want_g[k]) if gt is None else gt
                assert float((gt - want_g[k]).abs().max()) <= 1e-10 * scale, (name, k)


def test_mlp_split_forward_on_converted_weights(tmp_path):
    jdef, params, bstats, _ = _ae_pair("mlp_split", seed=3)
    ae = AutoEncoder(AutoEncoderConfig(**dict(AE_KW, ae_arch="mlp_split")))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    x = np.random.default_rng(2).normal(size=(32, 2, 16)).astype(np.float32)
    zj, xj, _ = jdef.forward(params, bstats, jnp.asarray(x))
    z, xhat = ae.eval()(torch.tensor(x))
    assert _rel(z.detach(), zj) <= 1e-6 and _rel(xhat.detach(), xj) <= 1e-6
    # the round trip back to flax's layout
    p2, bs2 = convert.autoencoder_to_jax(ae.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves((params, bstats)),
                    jax.tree_util.tree_leaves((p2, bs2))):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a split checkpoint in the JAX layout reads back through laligan_from_npz
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    g = jlg.init_generator(jax.random.PRNGKey(0), jlg.parse_repr("(2,1,2)", "0"))
    ckpt.save_pytree(str(tmp_path / "autoencoder.npz"),
                     {"params": as_np(params), "batch_stats": as_np(bstats)})
    ckpt.save_pytree(str(tmp_path / "generator.npz"), as_np(
        {"Li": g.Li, "sigma": g.sigma, "struct_const": g.struct_const}))
    ckpt.save_pytree(str(tmp_path / "generator_mask.npz"), as_np(g.masks))
    sd, _ = convert.laligan_from_npz(str(tmp_path), "cpu")
    for k, v in ae.state_dict().items():
        assert torch.equal(sd[k], v), k
    # and flax's initialiser layout covers both halves
    fresh = init_flax_(AutoEncoder(AutoEncoderConfig(**dict(AE_KW, ae_arch="mlp_split"))),
                       torch.Generator().manual_seed(0))
    assert {k for k, _ in fresh.named_parameters()} == set(dict(ae.named_parameters()))


# --- the constraint on the device ---


@pytest.mark.parametrize("d, order", [(2, 2), (2, 3), (3, 2)])
def test_m_weight_tensor_matches_jax(d, order):
    np.testing.assert_array_equal(constraint.m_weight_tensor(FunctionLibrary(d, order)),
                                  jcon.m_weight_tensor(JLib(d, order)))


Q_CASES = {
    "kron": [[[0.3, -1.0], [1.0, 0.2]]],                       # det > 0
    "sylvester": [[[0.0, -1.0], [0.0, 0.0]]],                  # det 0
    "two_channels": [[[0.0, -1.0], [1.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]]],
    "kron_then_sylvester": [[[0.0, -1.0], [1.0, 0.0]], [[1.0, 0.0], [0.0, -1.0]]],
    # the linear identity solves every constraint, so no real one is full
    # rank: a negative cutoff makes every column non-null
    "full_rank": [[[1.3, 0.4], [-0.7, 2.1]]],
}


@pytest.mark.parametrize("case", sorted(Q_CASES))
def test_get_Q_padded_projector_matches_jax(case):
    L = np.asarray(Q_CASES[case], np.float64)
    lib = FunctionLibrary(2, 2)
    cut = -1.0 if case == "full_rank" else 5e-3
    with jax.enable_x64(True):
        W = jnp.asarray(jcon.m_weight_tensor(JLib(2, 2)), jnp.float64)
        Qj = np.asarray(jcon.get_Q_padded_jnp(W, jnp.asarray(L), cut))
    Q, S = constraint.get_Q_padded(torch.tensor(constraint.m_weight_tensor(lib)),
                                   torch.tensor(L), cut, return_s=True)
    np.testing.assert_allclose((Q @ Q.T).numpy(), Qj @ Qj.T, rtol=0, atol=1e-10)
    assert int((Q.abs().sum(0) > 0).sum()) == int((np.abs(Qj).sum(0) > 0).sum())
    if case == "full_rank":  # no null column: all of V, Xi unconstrained
        assert float(S.min()) > cut
        np.testing.assert_allclose((Q @ Q.T).numpy(), np.eye(12), atol=1e-10)


# --- one joint step ---


def _pair(**hp_kw):
    """(JAX trainer, port trainer (no state), port spec) for rd's repr."""
    kw = dict(HP_KW, **hp_kw)
    spe = kw.pop("steps_per_epoch", 2)
    jspec = jlg.parse_repr("(2,1,2)", "0", keep_center=True, gan_st_thres=kw["gan_st_thres"])
    jtr = jlassi.LassiTrainer(AutoEncoderDef(**AE_KW), jspec, JDisc(hidden_dim=32, n_layers=2),
                              jlassi.LassiHParams(**kw), steps_per_epoch=spe)
    spec = lg.parse_repr("(2,1,2)", "0", keep_center=True, gan_st_thres=kw["gan_st_thres"])
    ptr = lassi.LassiTrainer(AutoEncoder(AutoEncoderConfig(**AE_KW)), spec,
                             Discriminator(4, hidden_dim=32, n_layers=2),
                             lassi.LassiHParams(**kw), device="cpu", steps_per_epoch=spe)
    return jtr, ptr, spec


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else a, tree)


def _jax_steps(jtr, bundle, bstats, opt, sc, batches, dtype):
    """The JAX trainer's steps on ``batches`` [(x, dx, key, draws, is_last)]
    with the draws fed, in ``dtype``: the last step's metrics and the state
    after all of them."""
    fed = [None]
    b, bs, o, s = (_cast(t, dtype) for t in (bundle, bstats, opt, sc))

    def step(b, bs, o, s, xj, dxj, key, ds, is_last):
        fed[0] = list(ds)
        (_, (new_bs, new_sc, m)), grads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
            b, bs, xj, dxj, s, key, is_last=is_last)
        updates, o = jtr.tx.update(grads, o, b)
        return m, optax.apply_updates(b, updates), new_bs, o, new_sc

    with DUMP.fed_coefficients(fed):
        for x, dx, key, draws, is_last in batches:
            m, b, bs, o, s = jax.jit(step, static_argnums=8)(
                b, bs, o, s, jnp.asarray(x, dtype), jnp.asarray(dx, dtype), key,
                [jnp.asarray(d, dtype) for d in draws], is_last)
    return {k: float(v) for k, v in m.items()}, b, bs, s


STEP_CASES = {
    "lstsq_constrained": dict(steps=[True]),
    "lstsq_constrained_stale_q": dict(steps=[False, False]),
    "lstsq_constrained_epoch": dict(steps=[False, True]),
    "lstsq_unconstrained": dict(eq_constraint=False, steps=[False]),
    "adam": dict(w_sindy_x=0.1, w_sindy_z=1e-3, eq_constraint=False, steps=[False, False]),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_joint_steps_match_jax_in_float64(rd_windows, case):
    """From the JAX init, the same batches and draws: one step (two with
    stale_q: the second, not an epoch's last, keeps the first's Q as the
    drift stays under 0.1; the Adam case takes two to cross its
    steps_per_epoch 1 boundary of the x10 schedule)."""
    kw = dict(STEP_CASES[case])
    steps = kw.pop("steps")
    jtr, ptr, spec = _pair(steps_per_epoch=1, **kw)
    x, dx = rd_windows
    key = jax.random.PRNGKey(42)
    key, kinit = jax.random.split(key)
    bundle, bstats, opt, sc = jtr.init(kinit, jnp.asarray(x))
    batches = []
    for i, is_last in enumerate(steps):
        key, sub = jax.random.split(key)
        idx = slice(64 * i, 64 * (i + 1))
        draws = DUMP.lassi_coef_draws_from_state(jtr.spec, bundle["g"], sub, 64)
        batches.append((x[idx], dx[idx], sub, draws, is_last))
    with jax.enable_x64(True):
        jm, b64, bs64, sc64 = _jax_steps(jtr, bundle, bstats, opt, sc, batches, jnp.float64)
        to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
        b64, bs64, sc64 = to_np(b64), to_np(bs64), to_np(sc64)
    ptr.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu", torch.float64,
                                           sindy_carry=sc), dtype=torch.float64)
    for xb, dxb, _, draws, is_last in batches:
        m = ptr.step(torch.tensor(xb, dtype=torch.float64), None,
                     [torch.tensor(d, dtype=torch.float64) for d in draws],
                     torch.tensor(dxb, dtype=torch.float64), is_last)
    assert set(m) == set(jm)
    for name, ref in jm.items():
        assert abs(float(m[name]) - ref) <= 1e-9 * max(abs(ref), 1e-6), (name, float(m[name]), ref)
    want_ae, want_d, want_g, want_s = convert.lassi_from_jax(b64, bs64, "cpu", torch.float64,
                                                             sindy_carry=sc64)
    init_ae = convert.lassi_from_jax(bundle, bstats, "cpu", torch.float64)[0]
    noise = set() if ptr.sindy_lstsq else _bn_fed_biases(ptr)
    for name, got in ptr.ae.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name in noise:  # exact gradient 0: Adam steps the rounding's sign
            for t in (got, want_ae[name]):
                assert float((t - init_ae[name]).abs().max()) <= \
                    len(steps) * ptr.hp.lr_ae * (1 + 1e-4), name
            continue
        assert _nrel(got, want_ae[name]) <= 1e-9, name
    for name, got in ptr.disc.state_dict().items():
        assert _nrel(got, want_d[name]) <= 1e-9, name
    for a, b in zip(ptr.g_state.Li, want_g.Li):
        assert _nrel(a.detach(), b) <= 1e-9
    s = ptr.sindy
    assert _nrel(s["Xi"].detach(), want_s["Xi"]) <= 1e-9
    assert torch.equal(s["mask"], want_s["mask"])
    if "Q" in want_s:
        Qp, Qw = s["Q"], want_s["Q"]
        assert float((Qp @ Qp.T - Qw @ Qw.T).abs().max()) <= 1e-9
        assert torch.equal(s["L_prev"], want_s["L_prev"]) or _nrel(s["L_prev"],
                                                                  want_s["L_prev"]) <= 1e-9
    if "resid" in want_s:
        assert abs(float(s["resid"]) - float(want_s["resid"])) <= 1e-9 * float(want_s["resid"])
    if case == "lstsq_constrained_stale_q":
        assert ptr.q_sv_margin()["recomputes"] == 1


def test_adam_branch_needs_steps_per_epoch():
    with pytest.raises(ValueError, match="steps_per_epoch"):
        lassi.LassiTrainer(AutoEncoder(AutoEncoderConfig(**AE_KW)), lg.parse_repr("(2,1,2)", "0"),
                           Discriminator(4, hidden_dim=32, n_layers=2),
                           lassi.LassiHParams(**dict(HP_KW, w_sindy_x=0.1)), device="cpu")


def test_sindy_lr_schedule_matches_optax():
    sched = jax.jit(optax.piecewise_constant_schedule(1e-3, {3: 10.0, 6: 10.0, 9: 10.0}))
    fn = lassi.sindy_lr_schedule(1e-3, 3)
    for count in range(12):
        assert fn(count) == float(sched(count)), count


# --- epochs ---


@pytest.mark.parametrize("case", ["lstsq_constrained", "adam"])
def test_three_epochs_match_jax(rd_windows, case):
    """Three epochs (two batches each, the second the last: Q recomputed
    there), the generator thresholded after each (gan_st_freq 1) and, on
    the Adam branch, Xi too (st_freq 1), from the JAX init on the JAX
    draws. The JAX trainer's exact arithmetic is its float64 run on the
    same draws (tools/dump_jax_draws.py's replay under jax.enable_x64): the
    port's float64 epochs match it within 1e-9 relative, and the port's f32
    epochs within 1e-3 relative of it in every mean component. Against the
    JAX trainer's own f32 epochs: within 1e-3 relative, or within twice the
    JAX f32 run's own distance from its float64 one where that is larger
    (its f32 least squares drift 1.3e-3 from its float64 in loss_sindy_z by
    the third epoch here, where the port's f32 lie within 1e-5). The masks
    equal in either dtype."""
    kw = dict(gan_st_freq=1) if case == "lstsq_constrained" else dict(
        gan_st_freq=1, w_sindy_x=0.1, w_sindy_z=1e-3, eq_constraint=False, st_freq=1,
        threshold=0.05)
    jtr, ptr, spec = _pair(**kw)
    p64 = _pair(**kw)[1]
    x, dx = rd_windows
    n = len(x)
    key = jax.random.PRNGKey(43)
    key, kinit = jax.random.split(key)
    bundle, bstats, opt, sc = jtr.init(kinit, jnp.asarray(x))
    ptr.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu", sindy_carry=sc))
    p64.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu", torch.float64,
                                           sindy_carry=sc), dtype=torch.float64)
    xj, dxj = jnp.asarray(x), jnp.asarray(dx)
    f32, f64 = (bundle, bstats, opt, sc), (bundle, bstats, opt, sc)
    thr = jtr.hp.gan_st_thres

    def after_epoch(b, bs, o, s):
        b = dict(b, g=jlg.set_threshold(jtr.spec, b["g"], thr))
        if jtr.sindy_adam:
            s = dict(s, mask=jnp.logical_and(jnp.abs(b["sindy"]["Xi"]) > jtr.hp.threshold,
                                             s["mask"] > 0).astype(s["mask"].dtype))
        return b, bs, o, s

    for e in range(3):
        key, sub = jax.random.split(key)
        perm, coef = DUMP.lassi_epoch_draws(jtr, f32[0]["g"], sub, n)
        *st, jm = jtr.epoch(*f32, xj, dxj, sub)
        f32 = after_epoch(*st)
        with jax.enable_x64(True):
            b, bs, o, m64, s = DUMP.lassi_replay_epoch(jtr, *f64[:3], xj, jnp.asarray(perm),
                                                       jnp.asarray(coef), f64[3], dxj,
                                                       dtype=jnp.float64)
            f64 = after_epoch(b, bs, o, s)
            m64 = {k: float(np.mean(np.asarray(v))) for k, v in m64.items()}
        got = {}
        for tr, dtype in ((ptr, torch.float32), (p64, torch.float64)):
            got[dtype] = tr.epoch(torch.tensor(x, dtype=dtype), perm=perm,
                                  coef=torch.tensor(coef, dtype=dtype),
                                  dx_data=torch.tensor(dx, dtype=dtype))
            tr.set_threshold()
            if tr.sindy_adam:
                tr.set_sindy_threshold()
        assert set(got[torch.float32]) == set(jm) == set(m64)
        for name, v in jm.items():
            ref, exact = float(v), m64[name]
            rel = lambda a, b: abs(float(a) - b) / max(abs(b), 1e-6)
            assert rel(got[torch.float64][name], exact) <= 1e-9, (e, name)
            assert rel(got[torch.float32][name], exact) <= 1e-3, (e, name)
            bar = max(1e-3, 2 * rel(ref, exact))
            assert rel(got[torch.float32][name], ref) <= bar, (e, name)
        for tr, state in ((ptr, f32), (p64, f64)):
            for a, b in zip(tr.g_state.masks, state[0]["g"].masks):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(tr.sindy["mask"].numpy(), np.asarray(state[3]["mask"]))
    if ptr.sindy_lstsq:
        assert ptr.q_sv_margin()["recomputes"] >= 3


# --- state ---


def _port_trainer(num_epochs, **kw):
    _, ptr, _ = _pair(num_epochs=num_epochs, **kw)
    return ptr


def test_resume_with_the_joint_state_is_bit_identical(tmp_path, rd_windows):
    x, dx = (torch.tensor(a) for a in rd_windows)
    root = str(tmp_path)
    kw = dict(gan_st_freq=2)
    full = _port_trainer(4, **kw)
    hist_a = lassi.train_lassi(full, x, None, seed=5, verbose=False, dx_train=dx)
    lassi.train_lassi(_port_trainer(2, **kw), x, None, seed=5, verbose=False, save_interval=1,
                      save_dir="joint", root=root, dx_train=dx)
    rest = _port_trainer(4, **kw)
    hist_b = lassi.train_lassi(rest, x, None, seed=5, verbose=False, save_interval=2,
                               save_dir="joint", resume=True, root=root, dx_train=dx)
    assert hist_a == hist_b and len(hist_a) == 4
    a, b = ckpt.flatten(full.state()), ckpt.flatten(rest.state())
    assert a.keys() == b.keys() and any("sindy" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_regressor_npz_reads_in_the_jax_package(tmp_path):
    Xi = torch.tensor([[0.0, -0.05, 0.13, 0, 0, 0], [0, 0.47, 0.05, 0, 0, 0]])
    mask = (Xi != 0).float()
    path = ckpt.save_regressor(str(tmp_path), Xi, mask)
    like = {"Xi": jnp.zeros((2, 6)), "mask": jnp.zeros((2, 6))}
    got = jckpt.load_pytree(path, like)
    np.testing.assert_array_equal(np.asarray(got["Xi"]), Xi.numpy())
    np.testing.assert_array_equal(np.asarray(got["mask"]), mask.numpy())
    Xr, mr = ckpt.load_regressor(str(tmp_path))
    assert torch.equal(Xr, Xi) and torch.equal(mr, mask)


def test_tracked_joint_regressor_reads_in_the_port():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    Xi, mask = ckpt.load_regressor(os.path.join(repo, "saved_models", "laligan-sindy-rd-2"))
    assert Xi.shape == mask.shape == (2, 6) and Xi.dtype == torch.float32
    assert int(mask.sum()) >= 1


def test_lassi_state_round_trips_through_the_jax_layout(rd_windows):
    jtr, ptr, _ = _pair(w_sindy_x=0.1, w_sindy_z=1e-3, eq_constraint=False)
    bundle, bstats, _, sc = jtr.init(jax.random.PRNGKey(0), jnp.asarray(rd_windows[0]))
    ptr.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu", sindy_carry=sc))
    out = convert.lassi_to_jax(ptr.ae.state_dict(), ptr.disc.state_dict(), ptr.g_state,
                               ptr.sindy, sindy_adam=True)
    np.testing.assert_array_equal(out["sindy"]["Xi"], np.asarray(bundle["sindy"]["Xi"]))
    np.testing.assert_array_equal(out["sindy_carry"]["mask"], np.asarray(sc["mask"]))


def test_replay_of_a_joint_jax_dump(tmp_path, rd_windows):
    """tools/dump_jax_draws.py --lassi's record of rd/sym_eq.cfg at 2 x 32 on
    the small rd windows (all of them, two epochs, the generator thresholded
    after each), replayed by cli/replay_lassi.py on the CPU: batch 0 within
    1e-5, each epoch's means within 1e-3, the final mask equal to the JAX
    trainer's f32 and float64 runs', and the port's means as close to the
    float64 run's as the JAX f32 run's (twice its distance) or within
    1e-3."""
    import json

    from symmetry_ode_discovery_tpu.utils.config import get_args as jax_get_args

    from symmetry_ode_discovery_tpu_torch.cli import replay_lassi

    x, dx = rd_windows
    flags = ["--hidden_dim", "32", "--n_layers", "2", "--gan_st_freq", "1"]
    args = vars(jax_get_args(["--config", "rd/sym_eq.cfg"] + flags))
    args["input_dim"] = 16
    rec = DUMP.lassi_record(args, x, n_batches=0, epochs=2, flags=flags, dxw=dx, f64=True)
    assert rec["x"].shape == (158, 2, 16) and rec["perm"].shape == (2, 2, 64)
    np.savez(tmp_path / "joint.npz", **rec)
    out = json.loads(json.dumps(replay_lassi.replay(str(tmp_path / "joint.npz"), "cpu")))
    assert out["batch0_ok"] and out["epoch_ok"], (out["batch0"], out["epoch_rel"])
    assert out["mask_ok"] and out["sindy_final"]["mask_equal_jax_f64"]
    # against the JAX float64 run, as far as the JAX f32 run is (bce's log(1 -
    # p) of a saturated discriminator puts loss_d_fake 9-10% from it in
    # either package's f32) or within 1e-3
    for got, own in zip(out["epoch_rel_jax_f64"], out["jax_f32_epoch_rel_jax_f64"]):
        for k, v in got.items():
            assert v <= max(1e-3, 2 * own[k]), (k, v, own[k])
    assert out["q_sv"]["recomputes"] >= 2
