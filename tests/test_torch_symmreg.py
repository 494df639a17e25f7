"""The EquivSINDy-r penalty pieces against the JAX package on the same
inputs: the library's explicit directional derivative, the Euler rollout,
the fused Euler pair (value and gradients) and
the fused-rollout penalty of make_symmreg_i_fast (value and gradient in the
masked coefficients), with the frozen-chain kernels off and on (on the CPU
the port's kernels run their plain versions; the JAX side runs its Pallas
kernels in interpret mode).

Small AE (hidden 64, 3 layers), '(2,1,2)' generator, poly2 library, 3 lanes
of 60 rows. Tolerances: values rtol 1e-5; gradients rtol 1e-4 / atol 1e-6
(f32, another summation order), as tests/test_pallas_symmpen.py holds the
JAX kernels to the JAX autodiff path.

The bf16 autoencoder (ae_dtype bfloat16): the penalty and its gradient in
the coefficients within 2e-2 relative of the JAX package's bf16 penalty
(both round at the same points; flax and torch may round a bias add or a
BatchNorm step apart, and the kernels' plain versions sum in another order
than the JAX bodies), with the kernels' plain versions and without; and,
on the reference's own setup and path of tests/test_symmreg_fast.py, within
its 0.15 of the f32 penalty.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.ops.integrators import make_euler_pair as jeuler_pair
from symmetry_ode_discovery_tpu.ops.integrators import odeint as jodeint
from symmetry_ode_discovery_tpu.training.symmreg import make_symmreg_i_fast as jfast

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.ops.integrators import make_euler_pair, odeint
from symmetry_ode_discovery_tpu_torch.training.symmreg import make_symmreg_i_fast

LANES, ROWS = 3, 60


@pytest.fixture(scope="module")
def setup():
    kw = dict(input_dim=2, hidden_dim=64, latent_dim=2, n_layers=3, n_comps=2,
              batch_norm=True, ortho_ae=True)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    spec_j = jlg.parse_repr("(2,1,2)", "0")
    gs = jlg.init_generator(jax.random.PRNGKey(10), spec_j)
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in f)
                                for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((LANES, ROWS, 2)).astype(np.float32)
    Xi = (0.3 * rng.standard_normal((LANES, 2, 6))).astype(np.float32)
    return dict(ae_def=ae_def, params=params, bstats=bstats, ae=ae.eval(), spec_j=spec_j, gs=gs,
                spec=lg.parse_repr("(2,1,2)", "0"), state=state, x=x, Xi=Xi,
                cfg_j=jmake_config(2, poly_order=2)[0], cfg=make_config(2, poly_order=2)[0])


def test_odeint_matches_jax(setup):
    cfg, cfg_j, x, Xi = setup["cfg"], setup["cfg_j"], setup["x"][0], setup["Xi"][0]
    want = jodeint(lambda q: cfg_j.library(q) @ jnp.asarray(Xi).T, jnp.asarray(x), 0.1, 0.01)
    got = odeint(lambda q: cfg.library(q) @ torch.tensor(Xi).T, torch.tensor(x), 0.1, 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(poly_order=2), dict(poly_order=2, include_exp=True),
                                dict(poly_order=3, include_sine=True)],
                         ids=["poly2", "poly2_exp", "poly3_sine"])
def test_library_jvp_matches_jax(kw):
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.5, 1.5, (3, 50, 2)).astype(np.float32)
    t = rng.standard_normal((3, 50, 2)).astype(np.float32)
    lib_j, lib = jmake_config(2, **kw)[0].library, make_config(2, **kw)[0].library
    want_f, want_t = jax.jvp(lib_j, (jnp.asarray(x),), (jnp.asarray(t),))
    got_f, got_t = lib.jvp(torch.tensor(x), torch.tensor(t))
    np.testing.assert_array_equal(got_f.numpy(), lib(torch.tensor(x)).numpy())
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("explicit", [False, True], ids=["torch_func_jvp", "library_jvp"])
def test_euler_pair_value_and_grads_match_jax(setup, explicit):
    cfg, cfg_j, x, Xi = setup["cfg"], setup["cfg_j"], setup["x"][0], setup["Xi"][0]
    v = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    ep_j = jeuler_pair(lambda A: (lambda q: cfg_j.library(q) @ A), 10, 0.01)

    def loss_j(x0, v0, A):
        fx, iv = ep_j(x0, v0, A)
        return jnp.sum(fx * w) + jnp.sum(iv ** 2)

    vj, gj = jax.value_and_grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(Xi.T))
    if explicit:
        def field_jvp(A):
            return lambda q, tq: tuple(th @ A for th in cfg.library.jvp(q, tq))
    else:
        def field_jvp(A):
            return lambda q, tq: torch.func.jvp(lambda y: cfg.library(y) @ A, (q,), (tq,))
    ep = make_euler_pair(field_jvp, 10, 0.01)
    ins = [torch.tensor(a, requires_grad=True) for a in (x, v, Xi.T.copy())]
    fx, iv = ep(*ins)
    vt = (fx * torch.tensor(w)).sum() + (iv ** 2).sum()
    gt = torch.autograd.grad(vt, ins)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pallas", [False, True], ids=["autodiff", "kernels"])
def test_penalty_fused_matches_jax(setup, pallas):
    s = setup
    prep_j, pen_j = jfast(s["ae_def"], s["params"], s["bstats"], s["spec_j"], s["gs"], 0.1, 0.01,
                          ae_dtype=jnp.float32 if pallas else None, pallas=pallas,
                          pallas_interpret=True, fused_rollout_lib=s["cfg_j"].library)
    prep, pen = make_symmreg_i_fast(s["ae"], s["spec"], s["state"], 0.1, 0.01, pallas=pallas,
                                    fused_rollout_lib=s["cfg"].library)
    assert pen.wants_coefs
    ctx = prep(torch.tensor(s["x"]))
    Xi = torch.tensor(s["Xi"], requires_grad=True)
    vt = pen(Xi, torch.tensor(s["x"]), ctx)
    (gt,) = torch.autograd.grad(vt.sum(), Xi)
    for lane in range(LANES):
        xj = jnp.asarray(s["x"][lane])
        ctx_j = prep_j(xj)
        np.testing.assert_allclose(ctx["z_x"][lane].numpy(), np.asarray(ctx_j["z_x"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ctx["v_xs"][lane].numpy(), np.asarray(ctx_j["v_xs"]),
                                   rtol=1e-4, atol=1e-6)
        vj, gj = jax.value_and_grad(lambda X: pen_j(X, xj, ctx_j))(jnp.asarray(s["Xi"][lane]))
        np.testing.assert_allclose(float(vt[lane].detach()), float(vj), rtol=1e-5)
        np.testing.assert_allclose(gt[lane].numpy(), np.asarray(gj), rtol=1e-4, atol=1e-6)


def test_unported_penalty_options_raise(setup):
    s = setup
    with pytest.raises(ValueError, match="ae_dtype"):
        make_symmreg_i_fast(s["ae"], s["spec"], s["state"], 0.1, 0.01, ae_dtype=torch.float16,
                            fused_rollout_lib=s["cfg"].library)
    # without the fused rollout the penalty is the closure form (ported
    # since; tests/test_torch_symmreg_composed.py holds it to the JAX one)
    _, pen = make_symmreg_i_fast(s["ae"], s["spec"], s["state"], 0.1, 0.01)
    assert not getattr(pen, "wants_coefs", False)


BF16_REL = 2e-2  # against the JAX package's bf16 penalty (module docstring)


@pytest.mark.parametrize("pallas", [False, True], ids=["autodiff", "kernels"])
def test_penalty_bf16_matches_jax(setup, pallas):
    """The bf16 penalty and its gradient in XiM per lane against the JAX
    package's ae_dtype=bfloat16 penalty (its kernels in interpret mode),
    within BF16_REL of the value and of the gradient's largest entry; z_x
    and v_x of prep likewise."""
    s = setup
    prep_j, pen_j = jfast(s["ae_def"], s["params"], s["bstats"], s["spec_j"], s["gs"], 0.1, 0.01,
                          ae_dtype=jnp.bfloat16, pallas=pallas, pallas_interpret=True,
                          fused_rollout_lib=s["cfg_j"].library)
    prep, pen = make_symmreg_i_fast(s["ae"], s["spec"], s["state"], 0.1, 0.01,
                                    ae_dtype=torch.bfloat16, pallas=pallas,
                                    fused_rollout_lib=s["cfg"].library)
    ctx = prep(torch.tensor(s["x"]))
    Xi = torch.tensor(s["Xi"], requires_grad=True)
    vt = pen(Xi, torch.tensor(s["x"]), ctx)
    (gt,) = torch.autograd.grad(vt.sum(), Xi)
    assert vt.dtype == gt.dtype == torch.float32
    for lane in range(LANES):
        xj = jnp.asarray(s["x"][lane])
        ctx_j = prep_j(xj)
        for key in ("z_x", "v_xs"):
            want = np.asarray(ctx_j[key])
            np.testing.assert_allclose(ctx[key][lane].numpy(), want, rtol=0,
                                       atol=BF16_REL * np.abs(want).max())
        vj, gj = jax.value_and_grad(lambda X: pen_j(X, xj, ctx_j))(jnp.asarray(s["Xi"][lane]))
        np.testing.assert_allclose(float(vt[lane].detach()), float(vj), rtol=BF16_REL)
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt[lane].numpy(), gj, rtol=0, atol=BF16_REL * np.abs(gj).max())


def test_penalty_bf16_close_to_f32():
    """The reference's tests/test_symmreg_fast.py::test_fast_symmreg_bf16_close
    on the port: its setup (hidden 16, 2 layers, BatchNorm, orthogonal latent
    layer, key 7, 64 rows), its path (autograd through the autoencoder) and
    its bound, the bf16 penalty within 0.15 of the f32 one, on one lane."""
    kw = dict(input_dim=2, hidden_dim=16, latent_dim=2, n_layers=2, n_comps=2,
              batch_norm=True, ortho_ae=True)
    params, bstats = AutoEncoderDef(ae_arch="mlp", **kw).init(jax.random.PRNGKey(7))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    gs = jlg.init_generator(jax.random.PRNGKey(8), jlg.parse_repr("(2,1,2)", "0"))
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in f)
                                for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks)))
    cfg = make_config(2, poly_order=2, include_exp=True)[0]
    x = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(9), (1, 64, 2))))
    Xi = torch.tensor(np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(10),
                                                         (1, 2, cfg.n_terms))))
    vals = {}
    for dtype in (torch.float32, torch.bfloat16):
        prep, pen = make_symmreg_i_fast(ae.eval(), lg.parse_repr("(2,1,2)", "0"), state, 0.1,
                                        0.01, ae_dtype=dtype, fused_rollout_lib=cfg.library)
        vals[dtype] = float(pen(Xi, x, prep(x))[0])
    v16, v32 = vals[torch.bfloat16], vals[torch.float32]
    assert np.isfinite(v16)
    assert abs(v16 - v32) / (abs(v32) + 1e-9) < 0.15, (v16, v32)
