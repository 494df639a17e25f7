"""The port's autoencoder, generator basis and checkpoint conversion against
the JAX package on the same parameters and inputs.

Parameters come from the JAX package's own initialisers (a small AE:
hidden 64, 3 layers, BatchNorm, orthogonal latent layer) or from the tracked
checkpoint saved_models/laligan-noise99-lv at full width, and pass to the
port as numpy arrays. Tolerances: the folded and unfolded chains agree to
rtol 1e-5 / atol 1e-6 (f32 products summed in another order); the
checkpoint's encode/decode to atol 1e-5 at full width (512-term sums).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.mlp import OrthoDense as JOrthoDense
from symmetry_ode_discovery_tpu.ops import pallas_symmpen as jsp
from symmetry_ode_discovery_tpu.utils.checkpoint import load_laligan

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.mlp import ortho_weight
from symmetry_ode_discovery_tpu_torch.ops import symmpen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "saved_models", "laligan-noise99-lv")
SMALL = dict(ae_arch="mlp", input_dim=2, hidden_dim=64, latent_dim=2, n_layers=3,
             n_comps=2, batch_norm=True, ortho_ae=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_ae(cfg_kw, params, bstats):
    kw = {k: v for k, v in cfg_kw.items()}
    ae = AutoEncoder(AutoEncoderConfig(**kw))
    ae.load_state_dict(convert.autoencoder_from_jax(_np(params), _np(bstats), "cpu"))
    return ae.eval()


@pytest.fixture(scope="module")
def small_ae():
    ae_def = AutoEncoderDef(**SMALL)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    # non-trivial running statistics, as a trained checkpoint has them
    rng = np.random.default_rng(0)
    bstats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.uniform(0.1, 0.5, a.shape), jnp.float32), bstats)
    return ae_def, params, bstats, _port_ae(SMALL, params, bstats)


def test_ortho_weight_matches_jax_qr():
    V = np.random.default_rng(1).standard_normal((64, 2)).astype(np.float32)
    jq = JOrthoDense(2).apply({"params": {"V": jnp.asarray(V), "bias": jnp.zeros(2)}},
                              jnp.eye(64))
    np.testing.assert_allclose(ortho_weight(torch.tensor(V)).numpy(), np.asarray(jq),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("part", ["encode", "decode"])
def test_autoencoder_matches_jax(small_ae, part):
    ae_def, params, bstats, ae = small_ae
    x = np.random.default_rng(2).standard_normal((37, 2, 2)).astype(np.float32)
    if part == "encode":
        want = ae_def.encode(params, bstats, jnp.asarray(x), train=False)[0]
        got = ae.encode(torch.tensor(x))
    else:
        want = ae_def.decode(params, jnp.asarray(x))
        got = ae.decode(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_encoder_final_bias_is_the_z_mean(small_ae):
    ae_def, params, _, ae = small_ae
    np.testing.assert_array_equal(ae.encoder_final_bias().detach().numpy(),
                                  np.asarray(ae_def.encoder_final_bias(params)))


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_folded_chain_matches_jax_fold(small_ae, which):
    ae_def, params, bstats, ae = small_ae
    if which == "encoder":
        zm = ae_def.encoder_final_bias(params)
        want = jsp.fold_encoder(ae_def, params, bstats, z_mean=zm)
        got = symmpen.fold_encoder(ae, ae.encoder_final_bias())
    else:
        want = jsp.fold_decoder(ae_def, params)
        got = symmpen.fold_decoder(ae)
    assert len(got.Ws) == len(want.Ws)
    for a, b in zip(got.Ws + got.bs, want.Ws + want.bs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    x = np.random.default_rng(3).standard_normal((29, 2)).astype(np.float32)
    np.testing.assert_allclose(symmpen.mlp_ref(got, torch.tensor(x)).numpy(),
                               np.asarray(jsp.mlp_ref(want, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("repr_str,group_idx", [("(2,1,2)", "0"), ("(1,so2)", "0"),
                                                ("(2,2,2,o)", "0"), ("(1,so3+1)", "0")])
def test_full_basis_list_matches_jax(repr_str, group_idx):
    spec_j = jlg.parse_repr(repr_str, group_idx)
    gs = jlg.init_generator(jax.random.PRNGKey(4), spec_j)
    mask = [np.asarray(m) * (np.random.default_rng(5).uniform(size=m.shape) > 0.3)
            for m in gs.masks]
    gs = gs.replace(masks=tuple(jnp.asarray(m, jnp.float32) for m in mask))
    spec = lg.parse_repr(repr_str, group_idx)
    assert spec.n_dims == spec_j.n_dims and len(spec.blocks) == len(spec_j.blocks)
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a)) for a in f)
                                for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks)))
    got = lg.get_full_basis_list(spec, state)
    want = jlg.get_full_basis_list(spec_j, gs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def checkpoint():
    ae_def = AutoEncoderDef(ae_arch="mlp", input_dim=2, hidden_dim=512, latent_dim=2,
                            n_layers=5, n_comps=2, batch_norm=True, ortho_ae=True)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    spec_j = jlg.parse_repr("(2,1,2)", "0")
    bundle = {"ae": params, "d": {}, "g": jlg.init_generator(jax.random.PRNGKey(1), spec_j)}
    bundle, bstats = load_laligan("laligan-noise99-lv", bundle, bstats,
                                  root=os.path.join(REPO, "saved_models"))
    sd, g_state = convert.laligan_from_npz(CKPT, "cpu")
    ae = AutoEncoder(AutoEncoderConfig(hidden_dim=512, n_layers=5, n_comps=2,
                                       batch_norm=True, ortho_ae=True))
    ae.load_state_dict(sd)
    return ae_def, bundle, bstats, spec_j, ae.eval(), g_state


@pytest.mark.parametrize("part", ["encode", "decode"])
def test_laligan_from_npz_matches_load_laligan(checkpoint, part):
    ae_def, bundle, bstats, _, ae, _ = checkpoint
    x = np.random.default_rng(6).uniform(0.2, 2.5, (100, 2)).astype(np.float32)
    if part == "encode":
        want = ae_def.encode(bundle["ae"], bstats, jnp.asarray(x), train=False)[0]
        got = ae.encode(torch.tensor(x))
    else:
        want = ae_def.decode(bundle["ae"], jnp.asarray(x))
        got = ae.decode(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_laligan_generator_state_matches(checkpoint):
    _, bundle, _, spec_j, _, g_state = checkpoint
    gj = bundle["g"]
    for a, b in zip(g_state.Li + g_state.sigma + g_state.struct_const + g_state.masks,
                    gj.Li + gj.sigma + gj.struct_const + gj.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    basis = lg.get_full_basis_list(lg.parse_repr("(2,1,2)", "0"), g_state)
    np.testing.assert_array_equal(basis[0].numpy(),
                                  np.asarray(jlg.get_full_basis_list(spec_j, gj)[0]))


def test_laligan_from_npz_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="autoencoder.npz"):
        convert.laligan_from_npz(str(tmp_path), "cpu")
