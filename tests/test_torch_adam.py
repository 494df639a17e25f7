"""The Adam SIGED trainer (training/siged_adam.py) against the JAX
package's on the CPU, on fed draws: the JAX trainer's initial parameters
and each epoch's permutation, rebuilt from its key chain
(train_siged_adam: key, kinit = split(key); per epoch key, sub =
split(key), permutation(sub, n) cut to n_batches * bs rows).

Two branches:
- data space, unconstrained, with the composed symmreg_i hook of
  make_sym_reg_fn (what the CLI's Adam branch swaps in for the fast path);
- latent space (the frozen autoencoder's encode, J_enc dx and J_dec dz),
  constrained by the generator (beta and const), with the per-basis
  infinitesimal penalty.
Small autoencoder (hidden 16, 2 layers), 300 rows, batches of 64.
Tolerances: loss_fn (value, components, gradient) and one epoch in float64
(jax.enable_x64) to 1e-9 relative and in float32 to 1e-5; three epochs with
st_freq 1: masks equal, parameters within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.training.siged import make_sym_reg_fn as jmake_sym_reg_fn
from symmetry_ode_discovery_tpu.training.siged_adam import AdamHParams as JHP
from symmetry_ode_discovery_tpu.training.siged_adam import SIGEDAdamTrainer as JTrainer

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training.siged import make_sym_reg_fn
from symmetry_ode_discovery_tpu_torch.training.siged_adam import (AdamHParams, SIGEDAdamTrainer,
                                                                  train_siged_adam)

N, BS = 300, 64
BRANCHES = {
    "data": dict(n_comps=2, repr="(2,1,2)", constrained=False, use_latent=False, w_sym=0.1),
    "latent": dict(n_comps=1, repr="(2,1,1)", constrained=True, use_latent=True, w_sym=0.01),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _hp(cls, b, **kw):
    base = dict(num_epochs=3, batch_size=BS, lr_sindy=1e-2, w_sindy_z=0.5, w_sindy_x=1.0,
                w_sindy_reg=1e-3, w_sym_reg=b["w_sym"], st_freq=1, threshold=0.05,
                use_latent=b["use_latent"])
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module", params=list(BRANCHES))
def pair(request):
    """The branch's configuration and the JAX pieces both packages build from."""
    b = BRANCHES[request.param]
    kw = dict(input_dim=2, hidden_dim=16, latent_dim=2, n_layers=2, n_comps=b["n_comps"],
              batch_norm=True, ortho_ae=False)
    ae_def = AutoEncoderDef(ae_arch="mlp", **kw)
    params, bstats = ae_def.init(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, params)
    bstats = jax.tree_util.tree_map(np.asarray, bstats)
    spec_j = jlg.parse_repr(b["repr"], "0")
    gs = jlg.init_generator(jax.random.PRNGKey(2), spec_j)
    L = [np.asarray(jlg.get_full_basis_list(spec_j, gs)[0])[:2, :2]] if b["constrained"] else []
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 1.5, (N, 2))
    dx = np.stack([0.75 - 0.1 * x[:, 0] - x[:, 0] * x[:, 1] ** 2,
                   -x[:, 1] + 0.1 * x[:, 0] + x[:, 0] * x[:, 1] ** 2], -1)
    dx = dx + 0.01 * rng.standard_normal(dx.shape)
    return dict(name=request.param, b=b, kw=kw, ae_def=ae_def, params=params, bstats=bstats,
                spec_j=spec_j, gs=gs, L=L, x=x, dx=dx)


def _jax_trainer(p, dtype, **hp_kw):
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
    params, bstats = cast(p["params"]), cast(p["bstats"])
    gs = jlg.GeneratorState(*(tuple(jnp.asarray(a, dtype) for a in f)
                              for f in (p["gs"].Li, p["gs"].sigma, p["gs"].struct_const,
                                        p["gs"].masks)))
    cfg, Q = jmake_config(2, poly_order=2, L_list=p["L"])
    ae_def = p["ae_def"]
    kw = {}
    if p["b"]["use_latent"]:
        kw["latent_fns"] = {
            "encode": lambda x: ae_def.encode(params, bstats, x, train=False)[0],
            "compute_dz": lambda x, dx: ae_def.compute_dz(params, bstats, x, dx),
            "compute_dx": lambda z, dz: ae_def.compute_dx(params, z, dz)}
        kw["basis_list"] = jlg.get_full_basis_list(p["spec_j"], gs)
    else:
        kw["sym_reg_fn"] = jmake_sym_reg_fn(ae_def, params, bstats, p["spec_j"], gs, "i",
                                            0.03, 0.01)
    return JTrainer(cfg, None if Q is None else jnp.asarray(Q, dtype), _hp(JHP, p["b"], **hp_kw),
                    **kw)


def _port_trainer(p, dtype, **hp_kw):
    ae = AutoEncoder(AutoEncoderConfig(**p["kw"]))
    ae.load_state_dict(convert.autoencoder_from_jax(p["params"], p["bstats"], "cpu", dtype))
    ae = ae.to(dtype).eval().requires_grad_(False)
    gs = p["gs"]
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in f)
                                for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks)))
    spec = lg.parse_repr(p["b"]["repr"], "0")
    cfg, Q = make_config(2, poly_order=2, L_list=p["L"])
    kw = {}
    if p["b"]["use_latent"]:
        kw["latent_fns"] = {"encode": ae.encode, "compute_dz": ae.compute_dz,
                            "compute_dx": ae.compute_dx}
        kw["basis_list"] = [v.detach() for v in lg.get_full_basis_list(spec, state)]
    else:
        kw["sym_reg_fn"] = make_sym_reg_fn(ae, spec, state, "i", 0.03, 0.01)
    return SIGEDAdamTrainer(cfg, Q, _hp(AdamHParams, p["b"], **hp_kw), **kw)


def _flat(params):
    if "Xi" in params:
        return np.asarray(params["Xi"], np.float64).reshape(-1)
    return np.concatenate([np.asarray(params["beta"], np.float64)]
                          + ([np.asarray(params["const"], np.float64).reshape(-1)]
                             if "const" in params else []))


def _perm(key, n):
    bs = min(BS, n)
    return np.asarray(jax.random.permutation(key, n)[: (n // bs) * bs])


def _run(dtype_name, fn):
    if dtype_name == "float64":
        with jax.enable_x64(True):
            return fn(jnp.float64, torch.float64, 1e-9)
    return fn(jnp.float32, torch.float32, 1e-5)


def _nrel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loss_fn_matches_jax(pair, dtype):
    def check(jdt, tdt, tol):
        jtr = _jax_trainer(pair, jdt)
        params, mask, _ = jtr.init(jax.random.PRNGKey(7))
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
        x, dx = jnp.asarray(pair["x"][:BS], jdt), jnp.asarray(pair["dx"][:BS], jdt)
        (jl, jm), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(params, mask, x, dx)
        tr = _port_trainer(pair, tdt)
        theta = torch.tensor(_flat(params), dtype=tdt, requires_grad=True)
        mask_t = torch.ones((2, tr.cfg.n_terms), dtype=tdt)
        loss, metrics = tr.loss_fn(theta, mask_t, torch.tensor(pair["x"][:BS], dtype=tdt),
                                   torch.tensor(pair["dx"][:BS], dtype=tdt))
        (g,) = torch.autograd.grad(loss, theta)
        assert set(metrics) == set(jm)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=tol)
        for k in jm:
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=tol, err_msg=k)
        assert _nrel(g.double().numpy(), _flat(jg)) < tol

    _run(dtype, check)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_one_epoch_matches_jax(pair, dtype):
    def check(jdt, tdt, tol):
        jtr = _jax_trainer(pair, jdt)
        params, mask, opt_state = jtr.init(jax.random.PRNGKey(7))
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
        opt_state = jtr.tx.init(params)
        key = jax.random.PRNGKey(11)
        x, dx = jnp.asarray(pair["x"], jdt), jnp.asarray(pair["dx"], jdt)
        p1, _, jm = jtr.epoch(params, jnp.asarray(mask, jdt), opt_state, x, dx, key)
        tr = _port_trainer(pair, tdt)
        theta, mask_t, opt = tr.start(torch.tensor(_flat(params), dtype=tdt))
        metrics = tr.epoch(theta, mask_t, opt, torch.tensor(pair["x"], dtype=tdt),
                           torch.tensor(pair["dx"], dtype=tdt),
                           torch.tensor(_perm(key, N), dtype=torch.long))
        for k in jm:
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=tol, err_msg=k)
        assert _nrel(theta.detach().double().numpy(), _flat(p1)) < tol

    _run(dtype, check)


def test_three_epochs_with_thresholding(pair):
    """train_siged_adam on the JAX draws, st_freq 1: masks equal after the
    thresholds, parameters within 1e-4."""
    from symmetry_ode_discovery_tpu.training.siged_adam import train_siged_adam as jtrain

    jtr = _jax_trainer(pair, jnp.float32)
    key = jax.random.PRNGKey(5)
    Xi_j, mask_j, hist_j = jtrain(jtr, jnp.asarray(pair["x"], jnp.float32),
                                  jnp.asarray(pair["dx"], jnp.float32), key)
    key, kinit = jax.random.split(key)
    theta0 = _flat(jtr.init(kinit)[0])
    perms = []
    for _ in range(3):
        key, sub = jax.random.split(key)
        perms.append(_perm(sub, N))
    tr = _port_trainer(pair, torch.float32)
    Xi, mask, hist = train_siged_adam(tr, torch.tensor(pair["x"], dtype=torch.float32),
                                      torch.tensor(pair["dx"], dtype=torch.float32),
                                      theta0=torch.tensor(theta0, dtype=torch.float32),
                                      perms=perms)
    assert len(hist) == len(hist_j) == 3
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert 0 < mask.sum() < mask.numel()
    assert _nrel(Xi.numpy(), np.asarray(Xi_j)) < 1e-4


def test_permutation_cut_and_own_draws():
    """bs = min(batch_size, n) and the epoch cut to n_batches * bs rows; the
    port's own draws are reproducible from the seed."""
    cfg, _ = make_config(2, poly_order=2)
    tr = SIGEDAdamTrainer(cfg, None, AdamHParams(batch_size=64, num_epochs=2, st_freq=0))
    assert tr.batches(torch.arange(300), 300).shape == (4, 64)
    assert tr.batches(torch.arange(50), 50).shape == (1, 50)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(150, 2)), dtype=torch.float32)
    a = train_siged_adam(tr, x, -x, seed=3)
    b = train_siged_adam(tr, x, -x, seed=3)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert a[1].sum() == a[1].numel()  # st_freq 0: no thresholding
