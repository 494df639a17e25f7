"""The latent-space L-BFGS fit and its distillation to data space against
the JAX package on the CPU (training/siged.py::train_sindy_lbfgs with
latent=, distill_to_data_space), on the JAX draws: the fit's and the
distillation's initial parameters from the JAX package's keys, fed to the
port.

The JAX package runs the fit as one fused scan, the port on its
host-stepped epochs with the same loss: w_z mean((dz_pred - dz)^2) + w_x
mean((J_dec(z) dz_pred - dx)^2), no normal equations; the distillation on
the normal-equation reduction in both. Small autoencoder (hidden 16, 2
layers), 400 rows, through the port CLI's chunk (cli/main.py::
fit_latent_chunk). Tolerances: one epoch in float64 (jax.enable_x64) to
1e-9, also with one distillation epoch; a full small fit and its distillation in float32: masks equal,
coefficients within 1e-3. With ae_arch none (the identity) the latent fit
is the data-space fit and the distillation reproduces it, in both packages
(masks equal, coefficients within 5e-3: each fit stops at a parameter step
of tol 1e-3), and the two packages agree (masks equal, within 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.training import siged as jsiged

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.cli.main import fit_latent_chunk
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams, train_sindy_lbfgs

N = 400
HP = dict(lr_sindy=1.0, w_sindy_x=1.0, w_sindy_reg=0.0, st_freq=10, threshold=0.05)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _selkov_rows(seed=0, lo=0.5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, 1.5, (N, 2))
    dx = np.stack([0.75 - 0.1 * x[:, 0] - x[:, 0] * x[:, 1] ** 2,
                   -x[:, 1] + 0.1 * x[:, 0] + x[:, 0] * x[:, 1] ** 2], -1)
    return x, dx + 0.01 * rng.standard_normal(dx.shape)


def _models(arch, constrained):
    kw = dict(input_dim=2, hidden_dim=16, latent_dim=2, n_layers=2, n_comps=1,
              batch_norm=True, ortho_ae=False)
    ae_def = AutoEncoderDef(ae_arch=arch, **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(4))
    params = jax.tree_util.tree_map(np.asarray, params)
    bstats = jax.tree_util.tree_map(np.asarray, bstats)
    ae = AutoEncoder(AutoEncoderConfig(ae_arch=arch, **kw))
    if arch != "none":
        ae.load_state_dict(convert.autoencoder_from_jax(params, bstats, "cpu"))
    L = []
    if constrained:
        spec = jlg.parse_repr("(2,1,1)", "0")
        L = [np.asarray(jlg.get_full_basis_list(spec, jlg.init_generator(
            jax.random.PRNGKey(2), spec))[0])]
    return ae_def, params, bstats, ae.eval().requires_grad_(False), L


def _flat(p):
    if "Xi" in p:
        return np.asarray(p["Xi"], np.float64).reshape(-1)
    return np.concatenate([np.asarray(p["beta"], np.float64)]
                          + ([np.asarray(p["const"], np.float64).reshape(-1)]
                             if "const" in p else []))


def _jax_fit(ae_def, params, bstats, L, x, dx, hp_kw, dtype, kfit, kdst, distill):
    """The JAX CLI's run_one on fixed rows: latent fit, then distillation."""
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
    params, bstats = cast(params), cast(bstats)
    cfg, Q = jmake_config(2, poly_order=2, L_list=L)
    Qj = None if Q is None else jnp.asarray(Q, dtype)
    hp = jsiged.LBFGSHParams(**HP, **hp_kw)
    latent = jsiged.LatentCtx(decode_jvp=lambda z, d: ae_def.compute_dx(params, z, d),
                              w_sindy_z=0.5)
    x, dx = jnp.asarray(x, dtype), jnp.asarray(dx, dtype)

    @jax.jit
    def go(x, dx):
        z, _ = ae_def.encode(params, bstats, x, train=False)
        dz = ae_def.compute_dz(params, bstats, x, dx)
        res = jsiged.train_sindy_lbfgs(cfg, Qj, z, (dz, dx), hp, kfit, latent=latent)
        if not distill:
            return res.Xi, res.mask, res.Xi, res.mask
        dz_pred = cfg.library(z) @ (res.Xi * res.mask).T
        dx_synth = ae_def.compute_dx(params, z, dz_pred)
        cfg_dst = jmake_config(2, poly_order=2)[0]
        dst = jsiged.distill_to_data_space(cfg_dst, x, dx_synth, hp, kdst)
        return res.Xi, res.mask, dst.Xi, dst.mask

    init = jsiged._make_param_fns(cfg, Qj)[0]
    init_dst = jsiged._make_param_fns(jmake_config(2, poly_order=2)[0], None)[0]
    th0 = _flat(cast(init(kfit)))
    th0_dst = _flat(cast(init_dst(kdst)))
    return [np.asarray(a, np.float64) for a in go(x, dx)], th0, th0_dst


def _port_fit(ae, L, x, dx, hp_kw, dtype, th0, th0_dst, distill):
    """The port CLI's chunk (cli/main.py::fit_latent_chunk) on all rows, in
    ``dtype``."""
    cfg, Q = make_config(2, poly_order=2, L_list=L)
    args = dict(w_sindy_z=0.5, distill_latent=distill, input_dim=2, poly_order=2,
                include_sine=False, include_exp=False, threshold=HP["threshold"])
    fit = dict(ae=ae, cfg=cfg, Q=Q, hp=LBFGSHParams(**HP, **hp_kw),
               x=torch.tensor(x, dtype=dtype), dx=torch.tensor(dx, dtype=dtype))
    res, dst = fit_latent_chunk(
        args, fit, torch.arange(len(x))[None], torch.tensor(th0, dtype=dtype)[None],
        None if th0_dst is None else torch.tensor(th0_dst, dtype=dtype)[None], dtype=dtype)
    out = [res.Xi[0], res.mask[0]]
    out += [dst.Xi[0], dst.mask[0]] if distill else out
    return [a.detach().double().numpy() for a in out]


def _keys(seed):
    kk = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    _, kfit, kdst = jax.random.split(kk, 3)
    return kfit, kdst


@pytest.mark.parametrize("constrained", [False, True], ids=["free", "constrained"])
def test_one_latent_epoch_float64(constrained):
    ae_def, params, bstats, ae, L = _models("mlp", constrained)
    x, dx = _selkov_rows()
    kfit, kdst = _keys(0)
    with jax.enable_x64(True):
        want, th0, _ = _jax_fit(ae_def, params, bstats, L, x, dx, dict(num_epochs=1),
                                jnp.float64, kfit, kdst, distill=False)
    got = _port_fit(ae, L, x, dx, dict(num_epochs=1), torch.float64, th0, None, distill=False)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9 * np.abs(want[0]).max())


def test_one_epoch_and_distillation_float64():
    """The CLI's chunk in float64 (as the smoke run's witness runs it): one
    latent epoch, then one distillation epoch, against the JAX package. On
    rows over [-1.5, 1.5]: on selkov's range the cubic library's columns are
    nearly collinear and the distillation amplifies summation order in
    float64 too (ROADMAP fault 11)."""
    ae_def, params, bstats, ae, L = _models("mlp", False)
    x, dx = _selkov_rows(2, lo=-1.5)
    kfit, kdst = _keys(2)
    with jax.enable_x64(True):
        want, th0, th0_dst = _jax_fit(ae_def, params, bstats, L, x, dx, dict(num_epochs=1),
                                      jnp.float64, kfit, kdst, distill=True)
    got = _port_fit(ae, L, x, dx, dict(num_epochs=1), torch.float64, th0, th0_dst,
                    distill=True)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-9,
                                   atol=1e-9 * np.abs(want[i]).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_full_fit_and_distillation(seed):
    ae_def, params, bstats, ae, L = _models("mlp", False)
    x, dx = _selkov_rows(seed)
    kfit, kdst = _keys(seed)
    hp_kw = dict(num_epochs=40)
    want, th0, th0_dst = _jax_fit(ae_def, params, bstats, L, x, dx, hp_kw, jnp.float32, kfit,
                                  kdst, distill=True)
    got = _port_fit(ae, L, x, dx, hp_kw, torch.float32, th0, th0_dst, distill=True)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 2):
        np.testing.assert_allclose(got[i] * got[i + 1], want[i] * want[i + 1], atol=1e-3)
    assert 0 < got[3].sum() < got[3].size


def test_identity_autoencoder_latent_is_data_space():
    """ae_arch none: the latent fit (w_sindy_z 0.5 on dz = dx, and J_dec the
    identity) is a data-space fit, and the distillation reproduces its
    equation; the JAX package and the port agree."""
    ae_def, params, bstats, ae, _ = _models("none", False)
    x, dx = _selkov_rows(3)
    kfit, kdst = _keys(3)
    hp_kw = dict(num_epochs=40)
    want, th0, th0_dst = _jax_fit(ae_def, params, bstats, [], x, dx, hp_kw, jnp.float32, kfit,
                                  kdst, distill=True)
    got = _port_fit(ae, [], x, dx, hp_kw, torch.float32, th0, th0_dst, distill=True)
    for pkg in (want, got):
        # each fit stops once its parameters move less than tol (1e-3) an
        # epoch, so the two fits of one equation agree to a few times that
        np.testing.assert_array_equal(pkg[3], pkg[1])
        np.testing.assert_allclose(pkg[2] * pkg[3], pkg[0] * pkg[1], atol=5e-3)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2] * got[3], want[2] * want[3], atol=1e-3)
    # the data-space fit of the same rows from the same start
    cfg, _ = make_config(2, poly_order=2)
    data = train_sindy_lbfgs(cfg, None, torch.tensor(x, dtype=torch.float32)[None],
                             torch.tensor(dx, dtype=torch.float32)[None],
                             LBFGSHParams(**HP, **hp_kw), torch.tensor(th0)[None])
    np.testing.assert_array_equal(data.mask[0].numpy(), got[1])
    np.testing.assert_allclose((data.Xi * data.mask)[0].numpy(), got[0] * got[1], atol=1e-3)
