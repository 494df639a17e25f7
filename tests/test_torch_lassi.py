"""The port's LaLiGAN training (training/lassi.py and what it runs) against
the JAX package's on the same inputs, on the CPU.

Small size: hidden width 32, 2 layers, batch 128, about 500 two-step windows
of the port's LV generator. The JAX trainer's init passes to the port through
convert.lassi_from_jax; the batches and coefficient draws are rebuilt from
the JAX keys (tools/dump_jax_draws.py, the functions the --lassi dump
uses) and fed to the port's epoch. Tolerances:
- the primitives (bce, expm2x2, the regularisers, set_threshold, the three
  coef_dist modes, training-mode BatchNorm): values and gradients within
  1e-6 relative to their scale;
- one batch step: every loss component, every gradient and every updated
  parameter within 1e-5 relative (a tensor's max |diff| over its max |value|);
- three epochs with gan_st_freq 1 (test_torch_lassi_epochs.py): each
  epoch's mean components within 1e-3 relative, the generator masks after
  every thresholding equal.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.discriminator import Discriminator as JDisc
from symmetry_ode_discovery_tpu.ops.lie import expm2x2 as jexpm2x2
from symmetry_ode_discovery_tpu.training import lassi as jlassi

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
from symmetry_ode_discovery_tpu_torch.data.datasets import MTODEDataset
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.discriminator import Discriminator
from symmetry_ode_discovery_tpu_torch.models.mlp import BatchNorm
from symmetry_ode_discovery_tpu_torch.ops.lie import expm2x2
from symmetry_ode_discovery_tpu_torch.training import lassi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AE_KW = dict(ae_arch="mlp", input_dim=2, hidden_dim=32, latent_dim=2, n_layers=2, n_comps=2,
             batch_norm=True, ortho_ae=True)
HP_KW = dict(batch_size=128, w_gan=0.01, w_reg_norm=0.01)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "dump_jax_draws", os.path.join(REPO, "tools", "dump_jax_draws.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DUMP = _tool()


@pytest.fixture(scope="module")
def windows():
    """About 500 two-step windows (interval 10) of the port's LV data."""
    gen = torch.Generator().manual_seed(0)
    x, dx = gen_data(SYSTEMS["lv"], gen, n_ics=4, num_steps=1500, subsample_rate=10,
                     device="cpu")
    return MTODEDataset(x, dx, interval=10).materialize()[0].numpy()


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _nrel(got, want):
    """||got - want|| over ||want|| (Frobenius): a tensor's relative error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pair(repr_str="(2,1,2)", n_layers=2, ae_kw=(), **hp_kw):
    """(JAX trainer, port trainer (no state yet), port spec)."""
    ae_kw = dict(AE_KW, n_layers=n_layers, **dict(ae_kw))
    kw = dict(HP_KW, **hp_kw)
    gkw = {k: kw.pop(k) for k in ("keep_center", "coef_dist") if k in kw}
    jspec = jlg.parse_repr(repr_str, "0", gan_st_thres=kw.get("gan_st_thres", 0.3), **gkw)
    jtr = jlassi.LassiTrainer(AutoEncoderDef(**ae_kw), jspec, JDisc(hidden_dim=32,
                                                                    n_layers=n_layers),
                              jlassi.LassiHParams(**kw))
    spec = lg.parse_repr(repr_str, "0", gan_st_thres=kw.get("gan_st_thres", 0.3), **gkw)
    x_dim = 4 if kw.get("use_original_x") else 0
    ptr = lassi.LassiTrainer(AutoEncoder(AutoEncoderConfig(**ae_kw)), spec,
                             Discriminator(4, hidden_dim=32, n_layers=n_layers, x_dim=x_dim),
                             lassi.LassiHParams(**kw), device="cpu")
    return jtr, ptr, spec


def _init(jtr, ptr, x, seed=43):
    key = jax.random.PRNGKey(seed)
    key, kinit = jax.random.split(key)
    bundle, bstats, opt, sc = jtr.init(kinit, jnp.asarray(x))
    ptr.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu"))
    return key, bundle, bstats, opt, sc


# --- primitives ---


def test_bce_values_and_gradients_match_jax():
    p = np.array([0.0, 1e-45, 1e-30, 1e-8, 0.2, 0.5, 0.8, 1 - 1e-7, 1.0], np.float32)
    for target in (0.0, 1.0):
        want, gw = jax.value_and_grad(lambda q: jlassi.bce(q, target))(jnp.asarray(p))
        pt = torch.tensor(p, requires_grad=True)
        got = lassi.bce(pt, target)
        got.backward()
        assert np.isfinite(got.item())
        assert _rel(got.item(), float(want)) <= 1e-6
        gw = np.asarray(gw)
        fin = np.isfinite(gw)
        np.testing.assert_array_equal(np.isfinite(pt.grad.numpy()), fin)
        np.testing.assert_allclose(pt.grad.numpy()[fin], gw[fin], rtol=1e-6)


def _expm2x2_case(delta):
    """8 matrices A = a I + B with B^2 = delta I, and a cotangent."""
    rng = np.random.default_rng(0)
    b01 = rng.uniform(0.3, 1.0, 8)
    b00 = rng.uniform(-0.5, 0.5, 8) if delta != 0.0 else np.zeros(8)
    b10 = (delta - b00 * b00) / b01
    a = rng.uniform(-0.3, 0.3, 8)
    A = np.stack([np.stack([a + b00, b01], -1), np.stack([b10, a - b00], -1)], -2)
    return A.astype(np.float32), rng.normal(size=A.shape).astype(np.float32)


def _expm2x2_torch(A, ct, dtype=torch.float32):
    At = torch.tensor(A, dtype=dtype, requires_grad=True)
    got = expm2x2(At)
    (got * torch.tensor(ct, dtype=dtype)).sum().backward()
    return got.detach(), At.grad


@pytest.mark.parametrize("delta", [-1.5, -0.1, -5e-7, 0.0, 5e-7, 0.1, 2.0])
def test_expm2x2_values_and_gradients_match_jax(delta):
    """delta on both sides of 0 and at 0 (the Taylor branch below |delta|
    1e-6)."""
    A, ct = _expm2x2_case(delta)
    want, vjp = jax.vjp(jexpm2x2, jnp.asarray(A))
    (gw,) = vjp(jnp.asarray(ct))
    got, grad = _expm2x2_torch(A, ct)
    assert torch.isfinite(grad).all()
    assert _rel(got, want) <= 1e-6
    assert _rel(grad, gw) <= 1e-6


@pytest.mark.parametrize("delta", [-1e-3, 1e-3])
def test_expm2x2_gradient_just_above_the_taylor_branch(delta):
    """Just above |delta| 1e-6 the closed form's gradient cancels (d/d delta
    of sinh(r)/r): an ulp of sin or cosh moves it by ~1e-5 relative, in
    the JAX package as in the port. Here both f32 gradients are held to the
    same formula in float64, the port's no further from it than twice the
    reference's own distance (and the values within 1e-6)."""
    A, ct = _expm2x2_case(delta)
    want, vjp = jax.vjp(jexpm2x2, jnp.asarray(A))
    (gw,) = vjp(jnp.asarray(ct))
    got, grad = _expm2x2_torch(A, ct)
    _, grad64 = _expm2x2_torch(A, ct, torch.float64)
    assert _rel(got, want) <= 1e-6
    assert _rel(grad, grad64) <= 2 * _rel(gw, grad64) + 1e-6


def _gen_states(repr_str, seed=0):
    jspec = jlg.parse_repr(repr_str, "0")
    st = jlg.init_generator(jax.random.PRNGKey(seed), jspec)
    spec = lg.parse_repr(repr_str, "0")
    rng = np.random.default_rng(seed)
    masks = tuple(jnp.asarray((rng.uniform(size=m.shape) > 0.2).astype(np.float32))
                  for m in st.masks)
    sc = tuple(jnp.asarray(rng.normal(size=c.shape).astype(np.float32)) for c in st.struct_const)
    st = st.replace(masks=masks, struct_const=sc)
    return jspec, st, spec


@pytest.mark.parametrize("repr_str", ["(2,1,2)", "(1,3,3)", "(1,2,3,o)"])
@pytest.mark.parametrize("reg", ["reg_norm", "reg_ortho", "reg_closure"])
def test_regularisers_match_jax(repr_str, reg):
    jspec, st, spec = _gen_states(repr_str)
    want, gw = jax.value_and_grad(lambda Li, c: getattr(jlg, reg)(
        jspec, st.replace(Li=Li, struct_const=c)), argnums=(0, 1))(st.Li, st.struct_const)
    Li = tuple(torch.tensor(np.asarray(a), requires_grad=True) for a in st.Li)
    sc = tuple(torch.tensor(np.asarray(a), requires_grad=True) for a in st.struct_const)
    state = lg.GeneratorState(Li, tuple(torch.tensor(np.asarray(a)) for a in st.sigma), sc,
                              tuple(torch.tensor(np.asarray(a)) for a in st.masks))
    got = getattr(lg, reg)(spec, state)
    if got.requires_grad:  # a single channel has no pair to close
        got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * max(abs(float(want)), 1.0)
    for t, g in zip(Li + sc, gw[0] + gw[1]):
        grad = np.zeros(t.shape) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(g), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("repr_str", ["(2,1,2)", "(1,3,3)", "(1,2,3,o)"])
def test_set_threshold_and_basis_match_jax(repr_str):
    jspec, st, spec = _gen_states(repr_str, seed=3)
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in getattr(st, f))
                                for f in ("Li", "sigma", "struct_const", "masks")))
    for thr in (0.0, 0.3, 0.7):
        want = jlg.set_threshold(jspec, st, thr)
        got = lg.set_threshold(spec, state, thr)
        for a, b in zip(got.masks, want.masks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(lg.getLi(spec, got), jlg.getLi(jspec, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(1).normal(size=(16, jspec.n_dims)).astype(np.float32)
    np.testing.assert_allclose(
        lg.infinitesimal_transform(spec, state, torch.tensor(x), 0).numpy(),
        np.asarray(jlg.infinitesimal_transform(jspec, st, jnp.asarray(x), 0)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("coef_dist", ["normal", "uniform", "uniform_int_grid"])
def test_coefficients_and_group_action_match_jax(coef_dist):
    """The three coef_dist modes on the JAX package's own draws, and the
    random transformation of a batch (the generator's forward)."""
    for repr_str, sigma_init in (("(2,1,2)", 2.7), ("(2,sim2)", 1.0)):
        jspec = jlg.parse_repr(repr_str, "0", coef_dist=coef_dist, sigma_init=sigma_init)
        spec = lg.parse_repr(repr_str, "0", coef_dist=coef_dist, sigma_init=sigma_init)
        st = jlg.init_generator(jax.random.PRNGKey(5), jspec)
        state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in getattr(st, f))
                                    for f in ("Li", "sigma", "struct_const", "masks")))
        key = jax.random.PRNGKey(11)
        draws = DUMP.lassi_coef_draws_from_state(jspec, st, key, 64)
        _, sub = jax.random.split(key)
        want = jlg.sample_coefficient(jspec, sub, 64, 1, st.sigma[0])
        got = lg.sample_coefficient(spec, None, 64, 1, state.sigma[0],
                                    draw=torch.tensor(draws[0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        z = np.random.default_rng(2).normal(size=(64, 2, 2)).astype(np.float32)
        want = jlg.generator_forward(jspec, st, key, jnp.asarray(z))
        got = lg.generator_forward(spec, state, None, torch.tensor(z),
                                   coef=[torch.tensor(d) for d in draws])
        assert _rel(got, want) <= 1e-6


def test_training_batchnorm_matches_flax():
    """Training-mode statistics (biased fast variance), the momentum-0.9
    running update, the output and its input gradient."""
    from flax import linen as nn

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 2, 16)) * 3 + 1).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.normal(size=16)
    mean0, var0 = rng.normal(size=16), rng.uniform(0.5, 2.0, 16)
    v = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                    "bias": jnp.asarray(bias, jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(mean0, jnp.float32),
                         "var": jnp.asarray(var0, jnp.float32)}}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    ct = rng.normal(size=x.shape).astype(np.float32)

    def f(xx):
        y, mut = bn.apply(v, xx, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut["batch_stats"])

    (_, (want, stats)), gw = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    m = BatchNorm(16)
    with torch.no_grad():
        m.weight.copy_(torch.tensor(scale)), m.bias.copy_(torch.tensor(bias))
        m.running_mean.copy_(torch.tensor(mean0)), m.running_var.copy_(torch.tensor(var0))
    xt = torch.tensor(x, requires_grad=True)
    got = m(xt, train=True)
    (got * torch.tensor(ct)).sum().backward()
    assert _rel(got.detach(), want) <= 1e-6
    assert _rel(xt.grad, gw) <= 1e-6
    assert _rel(m.running_mean, stats["mean"]) <= 1e-6
    assert _rel(m.running_var, stats["var"]) <= 1e-6


# --- one batch step ---


STEP_CASES = {
    "(2,1,2)": dict(),
    "(2,sim2)": dict(repr_str="(2,sim2)"),
    "w_reg_sim": dict(w_reg_norm=0.0, w_reg_sim=0.05),
    "keep_center": dict(keep_center=True),
    "use_original_x": dict(use_original_x=True),
}


_STEPS = {}


def _jax_step(jtr, bundle, bstats, opt, sc, x, key, draws, dtype):
    """The JAX trainer's loss components, gradients, updated bundle and
    batch statistics of one batch with the draws fed, in ``dtype`` (float64
    under jax.enable_x64), jitted once per trainer and dtype."""
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else a, t)
    fed = [None]

    def step(b, bs, o, xj, ds):
        fed[0] = list(ds)
        (_, (new_bs, _, m)), grads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
            b, bs, xj, xj, sc, key)
        updates, _ = jtr.tx.update(grads, o, b)
        return m, grads, optax.apply_updates(b, updates), new_bs

    fn = _STEPS.setdefault((id(jtr), jnp.dtype(dtype).name), jax.jit(step))
    with DUMP.fed_coefficients(fed):
        m, grads, b, new_bs = fn(cast(bundle), cast(bstats), cast(opt), jnp.asarray(x, dtype),
                                 [jnp.asarray(d, dtype) for d in draws])
    return {k: float(v) for k, v in m.items()}, grads, b, new_bs


def _bn_fed_biases(ptr):
    """The encoder's biases that feed a training-mode BatchNorm: the batch
    mean removes them, so their exact gradient is 0 and what either package
    computes is rounding (Adam then steps them by up to lr either way)."""
    if ptr.ae.encoder.bn is None:
        return set()
    n = len(ptr.ae.encoder.dense)
    return {f"encoder.dense.{k}.bias" for k in range(n)} | {"encoder.out.bias"}


def _port_step(ptr, bundle, bstats, x, draws, spec, dtype):
    """The port's components, gradients (by part and name; "g": the
    learnable Li) and state after one step from the JAX init, in dtype."""
    ptr.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu"), dtype=dtype)
    xt = torch.tensor(x, dtype=dtype)
    coef = [torch.tensor(d, dtype=dtype) for d in draws]
    loss, _ = ptr.loss_fn(xt, None, coef, train=True)
    names = {"ae": dict(ptr.ae.named_parameters()), "d": dict(ptr.disc.named_parameters())}
    learn = [i for i, b in enumerate(spec.blocks) if b.learnable]
    flat = (list(names["ae"].values()) + list(names["d"].values())
            + [ptr.g_state.Li[i] for i in learn])
    pg = iter(torch.autograd.grad(loss, flat))
    grads = {part: {n: next(pg) for n in names[part]} for part in names}
    grads["g"] = {i: next(pg) for i in learn}
    ptr.load_state(*convert.lassi_from_jax(bundle, bstats, "cpu"), dtype=dtype)
    m = ptr.step(xt, None, coef)
    after = {"ae": ptr.ae.state_dict(), "d": ptr.disc.state_dict(),
             "g": {i: ptr.g_state.Li[i].detach() for i in learn}}
    return {k: float(v) for k, v in m.items()}, grads, after


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_step_matches_jax(windows, case):
    """One batch step from the JAX trainer's init on the same batch and
    coefficient draws.
    - float64 (the arithmetic, free of f32 rounding): the port's loss
      components, every gradient and every updated parameter within 1e-9
      relative of the JAX trainer's under jax.enable_x64.
    - float32: the components within 1e-5 of the JAX trainer's f32 run;
      every gradient and updated parameter or statistic within 1e-5
      relative (a tensor's Frobenius norm) of the float64 result. Where the
      JAX package's own f32 result lies further than 5e-6 from it (its distance in either row
      order of the batch, or between the two orders, which are equal in
      exact arithmetic: the first encoder layer's is 6-8e-5 here, its
      pre-activations' mean large against their spread, the BatchNorm's
      E[x^2] - E[x]^2 cancelling; the port's lies as far on the other
      side), the port's is held within twice that distance.
    The BatchNorm-fed biases, whose exact gradient is 0 (the batch mean
    removes them): |gradient| within 1e-5 of the encoder's weight-gradient
    scale and the step within lr, in both packages."""
    jtr, ptr, spec = _pair(**STEP_CASES[case])
    x = windows[:128]
    key, bundle, bstats, opt, sc = _init(jtr, ptr, x)
    key, sub = jax.random.split(key)
    draws = DUMP.lassi_coef_draws_from_state(jtr.spec, bundle["g"], sub, 128)
    jm, g32, b32, bs32 = _jax_step(jtr, bundle, bstats, opt, sc, x, sub, draws, jnp.float32)
    # the same loss with the rows in reverse order: equal in exact arithmetic
    _, g32r, b32r, bs32r = _jax_step(jtr, bundle, bstats, opt, sc, x[::-1], sub,
                                     [d[::-1] for d in draws], jnp.float32)
    with jax.enable_x64(True):
        jm64, g64, b64, bs64 = _jax_step(jtr, bundle, bstats, opt, sc, x, sub, draws,
                                         jnp.float64)
        to64 = lambda *ts: [jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
                            for t in ts]
        g32, g32r, b32, bs32, b32r, bs32r, g64, b64, bs64 = to64(
            g32, g32r, b32, bs32, b32r, bs32r, g64, b64, bs64)

    def parts(tree, bs):
        ae, d, g = convert.lassi_from_jax(tree, bs, "cpu", torch.float64)
        learn = [i for i, b in enumerate(spec.blocks) if b.learnable]
        return {"ae": ae, "d": d, "g": {i: g.Li[i] for i in learn}}

    want_g, want_p, ref_g = parts(g64, bstats), parts(b64, bs64), parts(g32, bstats)
    ref_r, ref_p, ref_pr = parts(g32r, bstats), parts(b32, bs32), parts(b32r, bs32r)

    def floor(ref, rev, want, part, name):
        """The JAX package's own f32 error on one tensor: its distance from
        the float64 one in either row order, and between the two orders."""
        r, v, w = ref[part][name], rev[part][name], want[part][name]
        return max(_nrel(r, w), _nrel(v, w), _nrel(v, r))

    init = parts(bundle, bstats)
    noise = _bn_fed_biases(ptr)
    lr = ptr.hp.lr_ae
    w_scale = max(float(want_g["ae"][n].abs().max()) for n in want_g["ae"]
                  if n.endswith("weight"))
    for dtype in (torch.float64, torch.float32):
        m, pg, after = _port_step(ptr, bundle, bstats, x, draws, spec, dtype)
        f64 = dtype == torch.float64
        for name in jm:
            ref = jm64[name] if f64 else jm[name]
            assert abs(m[name] - ref) <= (1e-9 if f64 else 1e-5) * max(abs(ref), 1e-6), name
        for part in ("ae", "d", "g"):
            for name, grad in pg[part].items():
                if part == "ae" and name in noise:
                    assert float(grad.abs().max()) <= 1e-5 * w_scale, name
                    assert float(ref_g[part][name].abs().max()) <= 1e-5 * w_scale, name
                    continue
                err = _nrel(grad, want_g[part][name])
                bar = 1e-9 if f64 else max(1e-5, 2 * floor(ref_g, ref_r, want_g, part, name))
                assert err <= bar, (str(dtype), part, name, err, bar)
            for name, got in after[part].items():
                if str(name).endswith("num_batches_tracked"):
                    continue
                if part == "ae" and name in noise:
                    for t in (got, want_p[part][name]):
                        assert float((t.double() - init[part][name].double()).abs().max()) \
                            <= lr * (1 + 1e-4), name
                    continue
                bar = 1e-9 if f64 else max(1e-5, 2 * floor(ref_p, ref_pr, want_p, part, name))
                assert _nrel(got, want_p[part][name]) <= bar, (str(dtype), part, name)


def test_ae_ema_matches_jax_formula(windows):
    """--ae_ema: after one epoch (one batch) the autoencoder the port
    returns is the EMA decay * init + (1 - decay) * trained of the JAX
    trainer's parameters."""
    decay = 0.9
    jtr, ptr, _ = _pair(ae_ema=decay, gan_st_freq=0)
    x = windows[:128]
    key, bundle, bstats, opt, sc = _init(jtr, ptr, x)
    key, sub = jax.random.split(key)
    perm, coef = DUMP.lassi_epoch_draws(jtr, bundle["g"], sub, 128)
    out = jtr.epoch(bundle, bstats, opt, sc, jnp.asarray(x), jnp.asarray(x), sub)
    ema = jax.tree_util.tree_map(lambda a, b: decay * a + (1.0 - decay) * b, bundle["ae"],
                                 out[0]["ae"])
    want = convert.lassi_from_jax(dict(out[0], ae=ema), out[1], "cpu")[0]
    epoch = ptr.epoch
    ptr.epoch = lambda xd, gen: epoch(xd, gen, perm=perm, coef=torch.tensor(coef))
    ptr.hp = dataclasses.replace(ptr.hp, num_epochs=1)
    hist = lassi.train_lassi(ptr, torch.tensor(x), None, seed=0, verbose=False)
    assert len(hist) == 1
    got = ptr.ae.state_dict()
    init = convert.lassi_from_jax(bundle, bstats, "cpu")[0]
    noise = _bn_fed_biases(ptr)
    for name, w in want.items():
        if name in noise:  # the EMA of a step of at most lr
            for t in (got[name], w):
                assert float((t - init[name]).abs().max()) <= (1 - decay) * ptr.hp.lr_ae * 1.0001
        elif not name.endswith("num_batches_tracked"):
            assert _rel(got[name], w) <= 1e-5, name
