"""The bf16 mode of K2 and K3's plain versions (ops/symmpen.py, dtype
bfloat16) against the JAX package's Pallas bodies in bf16
(make_enc_apply / make_dec_jvp(dtype=jnp.bfloat16), _chain_fwd, interpret
mode) on the same folded autoencoders and inputs.

Autoencoders: hidden 64 with 3 layers, 128 with 4 (the selkov checkpoint's
shape) and 200 with 3 (a width no tile fits exactly), BatchNorm and an
orthogonal latent layer, random from fixed keys; 70 rows from numpy seeds.

Tolerances: each output within 1e-2 of its scale (max |JAX output|), and
at most 0.1% of the mask positions differing. Both sides round the same
values to bf16 at the same points and form each bf16 x bf16 product exactly
in f32; only the order of the f32 sums parts them, and that moves a value
across a bf16 rounding boundary (2^-8 of it) or a pre-activation across 0
only rarely.
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

BF16 = torch.bfloat16
SCALE_REL = 1e-2      # max |diff| over the output's scale
MASK_SHARE = 1e-3     # mask positions that may differ
SHAPES = {"h64": (64, 3, 0), "h128": (128, 4, 3), "h200": (200, 3, 5)}  # hidden, layers, key


@pytest.fixture(scope="module", params=sorted(SHAPES))
def chains(request):
    hidden, n_layers, key = SHAPES[request.param]
    kw = dict(input_dim=2, hidden_dim=hidden, latent_dim=2, n_layers=n_layers, n_comps=2,
              batch_norm=True, ortho_ae=True)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(key))
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, bstats),
        "cpu"))
    zm = ae_def.encoder_final_bias(params)
    return {"enc": (jsp.fold_encoder(ae_def, params, bstats, z_mean=zm),
                    symmpen.fold_encoder(ae.eval(), ae.encoder_final_bias())),
            "dec": (jsp.fold_decoder(ae_def, params), symmpen.fold_decoder(ae)),
            "hidden": hidden}


def _inputs(seed, rows=70):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, 2)).astype(np.float32) for _ in range(2)]


def _assert_scale_close(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got.numpy() - want).max()
    assert err <= SCALE_REL * scale, (err, scale)


def _mask_share_differing(got, want):
    differ = sum(int((g.numpy() != np.asarray(w)).sum()) for g, w in zip(got, want))
    total = sum(g.numel() for g in got)
    return differ / total


@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_bf16_bodies_match_jax(chains, kind):
    """Each of the four plain functions in bf16 against the JAX body in bf16:
    the forwards' outputs, and the backwards fed their own forward's masks
    against the JAX VJP (which recomputes the masks)."""
    x, c = _inputs(11)
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    xt, ct = torch.tensor(x), torch.tensor(c)
    (jfe, tfe), (jfd, tfd) = chains["enc"], chains["dec"]
    enc_j = jsp.make_enc_apply(jfe, dtype=jnp.bfloat16, interpret=True, row_tile=32)
    djvp = jsp.make_dec_jvp(jfd, dtype=jnp.bfloat16, interpret=True, row_tile=32)
    if kind == "enc_fwd":
        got, want = symmpen.enc_fwd_plain(tfe, xt, BF16)[0], enc_j(xj)
    elif kind == "enc_bwd":
        got = symmpen.enc_bwd_plain(tfe, symmpen.enc_fwd_plain(tfe, xt, BF16)[1], ct, BF16)
        want = jax.vjp(enc_j, xj)[1](cj)[0]
    elif kind == "dec_jvp":
        got, want = symmpen.dec_jvp_fwd_plain(tfd, xt, ct, BF16)[0], djvp(xj, cj)
    else:
        u = 0.5 * np.ones_like(x)
        masks = symmpen.dec_jvp_fwd_plain(tfd, xt, torch.tensor(u), BF16)[1]
        got = symmpen.dec_jvp_bwd_plain(tfd, masks, ct, BF16)
        want = jax.vjp(lambda b: djvp(xj, b), jnp.asarray(u))[1](cj)[0]
    _assert_scale_close(got, want)


@pytest.mark.parametrize("chain", ["enc", "dec"])
def test_bf16_masks_match_jax_chain_fwd(chains, chain):
    """The masks of the plain bf16 forwards against those of the JAX bodies'
    _chain_fwd in bf16 (the f32 pre-activation of the bf16 chain)."""
    jf, tf = chains[chain]
    x, u = _inputs(12, rows=300)
    _, want = jsp._chain_fwd(jnp.asarray(x), jf.Ws, jf.bs, jnp.bfloat16)
    if chain == "enc":
        _, got = symmpen.enc_fwd_plain(tf, torch.tensor(x), BF16)
    else:
        _, got = symmpen.dec_jvp_fwd_plain(tf, torch.tensor(x), torch.tensor(u), BF16)
    assert len(got) == len(want) == len(tf.Ws) - 1
    assert all(g.dtype == torch.bool and tuple(g.shape) == (300, tf.hidden) for g in got)
    assert _mask_share_differing(got, want) <= MASK_SHARE


def test_bf16_functions_match_jax_value_and_grad(chains):
    """enc_apply and dec_jvp with dtype bf16 on CPU tensors (the plain
    versions, the backward reading the forward's masks) against
    make_enc_apply / make_dec_jvp in bf16 under one loss: the loss and both
    input gradients within SCALE_REL of their scales."""
    (jfe, tfe), (jfd, tfd) = chains["enc"], chains["dec"]
    enc_j = jsp.make_enc_apply(jfe, dtype=jnp.bfloat16, interpret=True, row_tile=32)
    djvp = jsp.make_dec_jvp(jfd, dtype=jnp.bfloat16, interpret=True, row_tile=32)
    x, u = _inputs(13)

    def loss_j(a, b):
        z = enc_j(a)
        return jnp.mean((djvp(z, b + z) - 0.3) ** 2) + jnp.mean(jnp.sin(3.0 * z) ** 2)

    vj, gj = jax.value_and_grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
    xt, ut = torch.tensor(x, requires_grad=True), torch.tensor(u, requires_grad=True)
    z = symmpen.enc_apply(tfe, xt, BF16)
    vt = ((symmpen.dec_jvp(tfd, z, ut + z, BF16) - 0.3) ** 2).mean() \
        + (torch.sin(3.0 * z) ** 2).mean()
    gt = torch.autograd.grad(vt, (xt, ut))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=SCALE_REL)
    for g, w in zip(gt, gj):
        _assert_scale_close(g, w)


def test_bf16_padded_copy_of_the_chain(chains):
    """The kernels' bf16 copy (FoldedMLP.padded_bf16): every hidden width
    zero-padded to the tile width, the weights the bf16 rounding of the
    folded f32 ones, the transposes their transposes, the biases f32."""
    for f in (chains["enc"][1], chains["dec"][1]):
        W = symmpen.tile_width(f.hidden)
        Ws, WTs, bs = f.padded_bf16(W)
        assert Ws is f.padded_bf16(W)[0]  # made once
        K = len(f.Ws) - 1
        for k, (w, wt, b) in enumerate(zip(Ws, WTs, bs)):
            assert w.dtype == wt.dtype == torch.bfloat16 and b.dtype == torch.float32
            rows = W if k > 0 else f.d_in
            cols = W if k < K else f.d_out
            assert tuple(w.shape) == (rows, cols) and torch.equal(wt, w.T)
            r, c = f.Ws[k].shape
            assert torch.equal(w[:r, :c], f.Ws[k].to(torch.bfloat16))
            assert not w[r:].any() and not w[:, c:].any()
            assert torch.equal(b[:f.bs[k].shape[0]], f.bs[k]) and not b[f.bs[k].shape[0]:].any()


def test_bf16_plain_rounds_where_the_reference_rounds(chains):
    """The plain bf16 chain equals the f32 chain run on bf16-rounded input
    and weights with each activation rounded after its ReLU, bit for bit
    (the rounding points named in ops/symmpen.py), and the f32 mode is
    untouched by the bf16 one."""
    _, tf = chains["enc"]
    x = torch.tensor(_inputs(14)[0])
    h = x.to(BF16).float()
    for k, (W, b) in enumerate(zip(tf.Ws, tf.bs)):
        p = h @ W.to(BF16).float() + b
        h = torch.relu(p).to(BF16).float() if k < tf.n_relu else p
    assert torch.equal(symmpen.enc_fwd_plain(tf, x, BF16)[0], h)
    assert torch.equal(symmpen.enc_fwd_plain(tf, x)[0], symmpen.mlp_ref(tf, x))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        symmpen.enc_fwd_plain(tf, x, torch.float16)


def _forward_masks(tf, chain, x, u):
    if chain == "enc":
        return list(symmpen.enc_fwd_plain(tf, x, BF16)[1])
    return list(symmpen.dec_jvp_fwd_plain(tf, x, u, BF16)[1])


@pytest.mark.parametrize("chain", ["enc", "dec"])
def test_mask_flips_no_flip_gives_no_rows(chains, chain):
    """The plain forward's own masks: no flip row, no differing bit."""
    _, tf = chains[chain]
    x, u = (torch.tensor(a) for a in _inputs(15, rows=40))
    rows, flips, unexplained = symmpen.mask_flips(tf, x, _forward_masks(tf, chain, x, u),
                                                  1e-2, BF16)
    assert rows.dtype == torch.bool and tuple(rows.shape) == (40,)
    assert not bool(rows.any()) and flips == 0 and unexplained == 0


@pytest.mark.parametrize("chain", ["enc", "dec"])
def test_mask_flips_marks_the_row_of_a_flipped_bit(chains, chain):
    """One bit flipped in hidden layer k (each k in turn) marks exactly its
    row as a flip row and counts one differing bit; two flips in one row
    mark that row once."""
    _, tf = chains[chain]
    x, u = (torch.tensor(a) for a in _inputs(16, rows=40))
    masks = _forward_masks(tf, chain, x, u)
    for k in range(tf.n_relu):
        r, c = 3 + 5 * k, (7 * k + 2) % tf.hidden
        flipped = [m.clone() for m in masks]
        flipped[k][r, c] = ~flipped[k][r, c]
        rows, flips, _ = symmpen.mask_flips(tf, x, flipped, 1e-2, BF16)
        assert rows.nonzero().flatten().tolist() == [r] and flips == 1, (k, r, c)
        flipped[0][r, (c + 1) % tf.hidden] = ~flipped[0][r, (c + 1) % tf.hidden]
        rows, flips, _ = symmpen.mask_flips(tf, x, flipped, 1e-2, BF16)
        assert rows.nonzero().flatten().tolist() == [r] and flips == 2, (k, r, c)


@pytest.mark.parametrize("chain", ["enc", "dec"])
def test_mask_flips_counts_a_flip_far_from_0_as_unexplained(chains, chain):
    """A flipped bit whose |p| is the largest of its layer relative to the sum
    of |terms| behind it counts as unexplained; a flipped bit whose p the
    bias has moved to within rounding of 0 does not."""
    _, tf = chains[chain]
    x, u = (torch.tensor(a) for a in _inputs(17, rows=40))
    masks = _forward_masks(tf, chain, x, u)
    Ws, _ = tf.rounded(BF16)
    a = x.to(BF16).float()
    for k in range(tf.n_relu):
        p = a @ Ws[k] + tf.bs[k]
        scale = a.abs() @ Ws[k].abs() + tf.bs[k].abs()
        r, c = divmod(int((p.abs() / scale).argmax()), tf.hidden)
        flipped = [m.clone() for m in masks]
        flipped[k][r, c] = ~flipped[k][r, c]
        assert symmpen.mask_flips(tf, x, flipped, 1e-2, BF16)[1:] == (1, 1), k
        # the same unit of another row, its pre-activation moved to 0 by the bias
        r0 = (r + 1) % x.shape[0]
        bs = list(tf.bs)
        bs[k] = bs[k].clone()
        bs[k][c] -= p[r0, c]
        near = symmpen.FoldedMLP.make(tf.Ws, bs)
        masks0 = _forward_masks(near, chain, x, u)
        masks0[k][r0, c] = ~masks0[k][r0, c]
        rows, flips, unexplained = symmpen.mask_flips(near, x, masks0, 1e-2, BF16)
        assert rows.nonzero().flatten().tolist() == [r0] and (flips, unexplained) == (1, 0), k
        a = torch.relu(p).to(BF16).float()
