"""The plain versions of K2 and K3 (ops/symmpen.py) against the JAX
package's Pallas kernels (ops/pallas_symmpen.py, float32, interpret mode)
on the same folded autoencoder and inputs: values and gradients, and the
ReLU masks the forwards return for the backwards (against the JAX bodies'
_chain_fwd, element for element; the autograd Functions keep them as their
residual).

Small AE (hidden 64, 3 layers, BatchNorm, orthogonal latent layer), and the
selkov checkpoint's shape (hidden 128, 4 layers), 70 rows (three 32-row
tiles on the JAX side, padded). Tolerance rtol 1e-5 / atol
1e-6 for values and rtol 1e-4 / atol 1e-5 for gradients: both sides do the
same f32 products, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.ops import pallas_symmpen as jsp

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.ops import symmpen


@pytest.fixture(scope="module")
def chains():
    kw = dict(input_dim=2, hidden_dim=64, latent_dim=2, n_layers=3, n_comps=2,
              batch_norm=True, ortho_ae=True)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    zm = ae_def.encoder_final_bias(params)
    return {"enc": (jsp.fold_encoder(ae_def, params, bstats, z_mean=zm),
                    symmpen.fold_encoder(ae.eval(), ae.encoder_final_bias())),
            "dec": (jsp.fold_decoder(ae_def, params), symmpen.fold_decoder(ae))}


def _inputs(seed, rows=70):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, 2)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("plain", [True, False], ids=["enc_apply_plain", "enc_apply_cpu"])
def test_enc_apply_value_and_grad(chains, plain):
    jf, tf = chains["enc"]
    enc_j = jsp.make_enc_apply(jf, dtype=jnp.float32, interpret=True, row_tile=32)
    x, w = _inputs(1)
    vj, gj = jax.value_and_grad(lambda a: jnp.sum(jnp.sin(enc_j(a) * 3.0) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    enc = symmpen.enc_apply_plain if plain else symmpen.enc_apply
    vt = (torch.sin(enc(tf, xt) * 3.0) * torch.tensor(w)).sum()
    (gt,) = torch.autograd.grad(vt, xt)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("plain", [True, False], ids=["dec_jvp_plain", "dec_jvp_cpu"])
def test_dec_jvp_value_and_grad(chains, plain):
    jf, tf = chains["dec"]
    djvp = jsp.make_dec_jvp(jf, dtype=jnp.float32, interpret=True, row_tile=32)
    z, u = _inputs(2)
    np.testing.assert_allclose(
        (symmpen.dec_jvp_plain if plain else symmpen.dec_jvp)(tf, torch.tensor(z),
                                                             torch.tensor(u)).numpy(),
        np.asarray(djvp(jnp.asarray(z), jnp.asarray(u))), rtol=1e-5, atol=1e-6)
    gzj, guj = jax.grad(lambda a, b: jnp.mean((djvp(a, b) - 0.3) ** 2), argnums=(0, 1))(
        jnp.asarray(z), jnp.asarray(u))
    zt, ut = torch.tensor(z, requires_grad=True), torch.tensor(u, requires_grad=True)
    fn = symmpen.dec_jvp_plain if plain else symmpen.dec_jvp
    gzt, gut = torch.autograd.grad(((fn(tf, zt, ut) - 0.3) ** 2).mean(), (zt, ut))
    np.testing.assert_allclose(gut.numpy(), np.asarray(guj), rtol=1e-4, atol=1e-5)
    # the gradient in z is exactly 0 on both sides (ReLU masks are piecewise constant)
    assert not gzt.any() and not np.asarray(gzj).any()


@pytest.mark.parametrize("kind", ["enc_bwd", "dec_jvp_bwd"])
def test_backward_chains_match_jax_kernels(chains, kind):
    """The plain backward functions (what the kernels' backward computes),
    fed the plain forward's masks, against the JAX kernel's VJP for a given
    cotangent."""
    x, c = _inputs(3)
    if kind == "enc_bwd":
        jf, tf = chains["enc"]
        enc_j = jsp.make_enc_apply(jf, dtype=jnp.float32, interpret=True, row_tile=32)
        want = jax.vjp(enc_j, jnp.asarray(x))[1](jnp.asarray(c))[0]
        got = symmpen.enc_bwd_plain(tf, symmpen.enc_fwd_plain(tf, torch.tensor(x))[1],
                                    torch.tensor(c))
    else:
        jf, tf = chains["dec"]
        djvp = jsp.make_dec_jvp(jf, dtype=jnp.float32, interpret=True, row_tile=32)
        u = np.ones_like(x)
        want = jax.vjp(lambda b: djvp(jnp.asarray(x), b), jnp.asarray(u))[1](jnp.asarray(c))[0]
        masks = symmpen.dec_jvp_fwd_plain(tf, torch.tensor(x), torch.tensor(u))[1]
        got = symmpen.dec_jvp_bwd_plain(tf, masks, torch.tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_kernel_path_refuses_without_cuda(chains):
    """The kernel launchers never run on a CPU tensor (the Function picks the
    plain version there)."""
    _, tf = chains["enc"]
    with pytest.raises(ValueError, match="cuda"):
        symmpen.enc_fwd_kernel(tf, torch.zeros((4, 2)))


def _zero_chain(widths):
    return symmpen.FoldedMLP.make([torch.zeros(a, b) for a, b in zip(widths[:-1], widths[1:])],
                                  [torch.zeros(b) for b in widths[1:]])


def test_kernel_shape_limits(chains):
    """The kernels take any one hidden width up to 512 (64 here, 128 for the
    selkov checkpoint, 512 for LV) and raise, naming the limit, above it."""
    _, tf = chains["enc"]
    symmpen.check_chain(tf)
    for h in (1, 128, 200, 512):
        symmpen.check_chain(_zero_chain([2, h, h, 2]))
    with pytest.raises(ValueError, match="hidden widths up to 512, got 513"):
        symmpen.check_chain(_zero_chain([2, 513, 513, 2]))
    with pytest.raises(ValueError, match="one hidden width"):
        symmpen.check_chain(_zero_chain([2, 128, 64, 2]))


@pytest.fixture(scope="module")
def chains_128():
    """The selkov checkpoint's shape: hidden 128, 4 layers, BatchNorm and an
    orthogonal latent layer (random init from a fixed key)."""
    kw = dict(input_dim=2, hidden_dim=128, latent_dim=2, n_layers=4, n_comps=2,
              batch_norm=True, ortho_ae=True)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(3))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    zm = ae_def.encoder_final_bias(params)
    return {"enc": (jsp.fold_encoder(ae_def, params, bstats, z_mean=zm),
                    symmpen.fold_encoder(ae.eval(), ae.encoder_final_bias())),
            "dec": (jsp.fold_decoder(ae_def, params), symmpen.fold_decoder(ae))}


@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_width_128_chains_match_jax_kernels(chains_128, kind):
    """All four plain chains at hidden width 128 and 4 layers against the JAX
    bodies (float32, interpret mode), 70 rows from a seed: rtol 1e-5 / atol
    1e-6 (values) and rtol 1e-4 / atol 1e-5 (VJPs), as above."""
    x, c = _inputs(4)
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    xt, ct = torch.tensor(x), torch.tensor(c)
    (jfe, tfe), (jfd, tfd) = chains_128["enc"], chains_128["dec"]
    assert tfe.hidden == 128 and len(tfe.Ws) == 5
    symmpen.check_chain(tfe)
    symmpen.check_chain(tfd)
    enc_j = jsp.make_enc_apply(jfe, dtype=jnp.float32, interpret=True, row_tile=32)
    djvp = jsp.make_dec_jvp(jfd, dtype=jnp.float32, interpret=True, row_tile=32)
    if kind == "enc_fwd":
        got, want, tol = symmpen.enc_fwd_plain(tfe, xt)[0], enc_j(xj), (1e-5, 1e-6)
    elif kind == "enc_bwd":
        got = symmpen.enc_bwd_plain(tfe, symmpen.enc_fwd_plain(tfe, xt)[1], ct)
        want, tol = jax.vjp(enc_j, xj)[1](cj)[0], (1e-4, 1e-5)
    elif kind == "dec_jvp":
        got, want, tol = symmpen.dec_jvp_fwd_plain(tfd, xt, ct)[0], djvp(xj, cj), (1e-5, 1e-6)
    else:
        masks = symmpen.dec_jvp_fwd_plain(tfd, xt, torch.ones_like(xt))[1]
        got = symmpen.dec_jvp_bwd_plain(tfd, masks, ct)
        want = jax.vjp(lambda b: djvp(xj, b), jnp.ones_like(xj))[1](cj)[0]
        tol = (1e-4, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol[0], atol=tol[1])


# ---- the mask residual: forwards return their masks, backwards take them ----

AE_FIXTURES = ["chains", "chains_128"]


@pytest.mark.parametrize("chain", ["enc", "dec"])
@pytest.mark.parametrize("fixture", AE_FIXTURES)
def test_plain_masks_match_jax_chain_fwd(request, fixture, chain):
    """The masks the plain forward returns (enc_fwd_plain; dec_jvp_fwd_plain,
    whose masks are the decoder's primal chain at z) equal those of the JAX
    package's in-kernel _chain_fwd in float32, element for element."""
    jf, tf = request.getfixturevalue(fixture)[chain]
    x, u = _inputs(5)
    _, want = jsp._chain_fwd(jnp.asarray(x), jf.Ws, jf.bs, jnp.float32)
    if chain == "enc":
        _, got = symmpen.enc_fwd_plain(tf, torch.tensor(x))
    else:
        _, got = symmpen.dec_jvp_fwd_plain(tf, torch.tensor(x), torch.tensor(u))
    assert len(got) == len(want) == len(tf.Ws) - 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and tuple(g.shape) == (70, tf.hidden)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["enc_bwd", "dec_jvp_bwd"])
@pytest.mark.parametrize("fixture", AE_FIXTURES)
def test_plain_backward_fed_forward_masks_matches_jax_vjp(request, fixture, kind):
    """The plain backward fed the masks its forward returned, at another
    input and cotangent than above, against the VJP of make_enc_apply /
    make_dec_jvp (float32, interpret mode): rtol 1e-4 / atol 1e-5."""
    x, c = _inputs(6)
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    xt, ct = torch.tensor(x), torch.tensor(c)
    if kind == "enc_bwd":
        jf, tf = request.getfixturevalue(fixture)["enc"]
        enc_j = jsp.make_enc_apply(jf, dtype=jnp.float32, interpret=True, row_tile=32)
        want = jax.vjp(enc_j, xj)[1](cj)[0]
        got = symmpen.enc_bwd_plain(tf, symmpen.enc_fwd_plain(tf, xt)[1], ct)
    else:
        jf, tf = request.getfixturevalue(fixture)["dec"]
        djvp = jsp.make_dec_jvp(jf, dtype=jnp.float32, interpret=True, row_tile=32)
        u = 0.5 * np.ones_like(x)
        want = jax.vjp(lambda b: djvp(xj, b), jnp.asarray(u))[1](cj)[0]
        got = symmpen.dec_jvp_bwd_plain(tf, symmpen.dec_jvp_fwd_plain(tf, xt, torch.tensor(u))[1],
                                        ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "cpu_tensors"])
@pytest.mark.parametrize("fixture", AE_FIXTURES)
def test_functions_with_mask_residual_keep_their_gradients(request, fixture, plain):
    """enc_apply / dec_jvp on CPU tensors, whose backward reads the saved
    masks, give the gradients of the recomputing backward they replace:
    autograd through the plain chains themselves (mlp_ref for the encoder,
    the plain tangent chain for the JVP), within rtol 1e-6 / atol 1e-7 (the
    same products; autograd multiplies by W^T as a view); z's gradient is
    exactly 0."""
    chains = request.getfixturevalue(fixture)
    _, fe = chains["enc"]
    _, fd = chains["dec"]
    x, u = _inputs(7)
    enc = symmpen.enc_apply_plain if plain else symmpen.enc_apply
    jvp = symmpen.dec_jvp_plain if plain else symmpen.dec_jvp

    def loss(enc_fn, jvp_fn, xt, ut):
        z = enc_fn(xt)
        v = jvp_fn(z, ut + z)
        return ((v - 0.3) ** 2).mean() + (torch.sin(3.0 * z) ** 2).mean()

    xt, ut = torch.tensor(x, requires_grad=True), torch.tensor(u, requires_grad=True)
    got = torch.autograd.grad(loss(lambda a: enc(fe, a), lambda a, b: jvp(fd, a, b), xt, ut),
                              (xt, ut))
    xr, ur = torch.tensor(x, requires_grad=True), torch.tensor(u, requires_grad=True)
    want = torch.autograd.grad(loss(lambda a: symmpen.mlp_ref(fe, a),
                                    lambda a, b: symmpen.dec_jvp_fwd_plain(fd, a, b)[0], xr, ur),
                               (xr, ur))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
    zt = torch.tensor(_inputs(8)[0], requires_grad=True)
    (gz,) = torch.autograd.grad(jvp(fd, zt, torch.tensor(u)).sum(), (zt,))
    assert not gz.any()


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_mask_residual_kept_only_for_a_backward(chains, monkeypatch, grad):
    """The forward's masks live as long as the graph that needs them: under
    torch.no_grad nothing keeps them after the call."""
    import weakref

    _, tf = chains["enc"]
    refs = []

    def recording_fwd(f, x):
        z, masks = symmpen.enc_fwd_plain(f, x)
        refs.extend(weakref.ref(m) for m in masks)
        return z, masks

    monkeypatch.setattr(symmpen, "_PLAIN", (recording_fwd,) + symmpen._PLAIN[1:])
    x = torch.tensor(_inputs(9)[0], requires_grad=True)
    with torch.set_grad_enabled(grad):
        z = symmpen.enc_apply_plain(tf, x)
    assert len(refs) == len(tf.Ws) - 1
    assert all(r() is not None for r in refs) == grad
    if grad:
        z.sum().backward()
        del z
        assert all(r() is None for r in refs)


def test_unpack_masks_layout():
    """unpack_masks reads the kernels' layout: per row W / 16 little-endian
    16-bit words, bit j of word g for column (j // 4) * (W / 4) + 4 g + j % 4;
    the columns past the hidden width are dropped."""
    for W, hidden in ((128, 100), (256, 256), (512, 512)):
        rng = np.random.default_rng(W)
        want = rng.random((2, 3, W)) < 0.5
        words = np.zeros((2, 3, W // 16), dtype=np.uint16)
        for g in range(W // 16):
            for j in range(16):
                words[..., g] |= want[..., (j // 4) * (W // 4) + 4 * g + j % 4].astype(
                    np.uint16) << j
        packed = torch.from_numpy(words.astype("<u2").view(np.uint8).copy())
        assert tuple(packed.shape) == (2, 3, W // 8)
        got = symmpen.unpack_masks(packed, hidden)
        np.testing.assert_array_equal(got.numpy(), want[..., :hidden])
    assert [symmpen.tile_width(h) for h in (1, 128, 129, 200, 256, 257, 512)] == \
        [128, 128, 256, 256, 256, 512, 512]
