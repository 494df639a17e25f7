"""The composed symmetry penalties against the JAX package on the CPU:
symmreg_i, symmreg_f and symmreg_r through make_sym_reg_fn (values and
gradients in the candidate's coefficients), precompute_symmreg_r, the
closure form of make_symmreg_i_fast (--no_fused_rollout), and the composed
symmreg_i against the port's fused fast path on the same lanes.

Small autoencoder (2 components, hidden 32, 3 layers, BatchNorm and the
orthogonal final layer), the '(2,1,2)' generator, a poly2 library, 40 rows.
Tolerances: float64 (jax.enable_x64) 1e-9 relative; float32 1e-5 relative
for values and 1e-4 for gradients (another summation order through the
autoencoder's JVPs), the two port paths within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.models import lie_generator as jlg
from symmetry_ode_discovery_tpu.models.autoencoder import AutoEncoderDef
from symmetry_ode_discovery_tpu.models.sindy import make_config as jmake_config
from symmetry_ode_discovery_tpu.training import symmreg as jsr
from symmetry_ode_discovery_tpu.training.siged import make_sym_reg_fn as jmake_sym_reg_fn

from symmetry_ode_discovery_tpu_torch import convert
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
from symmetry_ode_discovery_tpu_torch.models.autoencoder import AutoEncoder, AutoEncoderConfig
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.training import symmreg as sr
from symmetry_ode_discovery_tpu_torch.training.siged import make_sym_reg_fn

KW = dict(input_dim=2, hidden_dim=32, latent_dim=2, n_layers=3, n_comps=2, batch_norm=True,
          ortho_ae=True)
INT_T, INT_DT = 0.03, 0.01
ROWS = 40


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    ae_def = AutoEncoderDef(ae_arch="mlp", **KW)
    params, bstats = ae_def.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    bstats = jax.tree_util.tree_map(np.asarray, bstats)
    spec_j = jlg.parse_repr("(2,1,2)", "0")
    gs = jlg.init_generator(jax.random.PRNGKey(10), spec_j)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 1.5, (3, ROWS, 2))
    Xi = 0.3 * rng.standard_normal((3, 2, 6))
    return dict(ae_def=ae_def, params=params, bstats=bstats, spec_j=spec_j, gs=gs, x=x, Xi=Xi)


def _port(setup, dtype):
    ae = AutoEncoder(AutoEncoderConfig(**KW))
    ae.load_state_dict(convert.autoencoder_from_jax(setup["params"], setup["bstats"], "cpu",
                                                    dtype))
    ae = ae.to(dtype).eval().requires_grad_(False)
    gs = setup["gs"]
    state = lg.GeneratorState(*(tuple(torch.tensor(np.asarray(a), dtype=dtype) for a in f)
                                for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks)))
    return ae, lg.parse_repr("(2,1,2)", "0"), state


def _jax_tree(setup, dtype):
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
    gs = setup["gs"]
    return (cast(setup["params"]), cast(setup["bstats"]),
            jlg.GeneratorState(*(tuple(jnp.asarray(a, dtype) for a in f)
                                 for f in (gs.Li, gs.sigma, gs.struct_const, gs.masks))))


def _jax_value_and_grad(setup, kind, dtype):
    params, bstats, gs = _jax_tree(setup, dtype)
    lib = jmake_config(2, poly_order=2)[0].library
    fn = jmake_sym_reg_fn(setup["ae_def"], params, bstats, setup["spec_j"], gs, kind,
                          INT_T, INT_DT)

    def loss(Xi, x):
        return fn(lambda q: lib(q) @ Xi.T, x)

    vg = jax.value_and_grad(loss)
    out = [vg(jnp.asarray(Xi, dtype), jnp.asarray(x, dtype))
           for Xi, x in zip(setup["Xi"], setup["x"])]
    return (np.array([float(v) for v, _ in out]),
            np.stack([np.asarray(g, np.float64) for _, g in out]))


def _port_value_and_grad(setup, kind, dtype):
    ae, spec, state = _port(setup, dtype)
    lib = make_config(2, poly_order=2)[0].library
    fn = make_sym_reg_fn(ae, spec, state, kind, INT_T, INT_DT)
    vals, grads = [], []
    for Xi, x in zip(setup["Xi"], setup["x"]):
        Xi = torch.tensor(Xi, dtype=dtype, requires_grad=True)
        v = fn(lambda q: lib(q) @ Xi.T, torch.tensor(x, dtype=dtype))
        (g,) = torch.autograd.grad(v, Xi)
        vals.append(float(v.detach()))
        grads.append(g.double().numpy())
    return np.array(vals), np.stack(grads)


def _nrel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["i", "f", "r"])
def test_composed_penalty_matches_jax(setup, kind, dtype):
    if dtype == "float64":
        with jax.enable_x64(True):
            want_v, want_g = _jax_value_and_grad(setup, kind, jnp.float64)
        got_v, got_g = _port_value_and_grad(setup, kind, torch.float64)
        tol_v = tol_g = 1e-9
    else:
        want_v, want_g = _jax_value_and_grad(setup, kind, jnp.float32)
        got_v, got_g = _port_value_and_grad(setup, kind, torch.float32)
        tol_v, tol_g = 1e-5, 1e-4
    assert np.all(want_v > 0)
    np.testing.assert_allclose(got_v, want_v, rtol=tol_v)
    for g, w in zip(got_g, want_g):
        assert _nrel(g, w) < tol_g, _nrel(g, w)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_precompute_symmreg_r_matches_jax(setup, dtype):
    x = setup["x"][0]
    if dtype == "float64":
        with jax.enable_x64(True):
            params, bstats, gs = _jax_tree(setup, jnp.float64)
            want = jsr.precompute_symmreg_r(setup["ae_def"], params, bstats, setup["spec_j"],
                                            gs, jnp.asarray(x, jnp.float64))
            want = [[np.asarray(a, np.float64) for a in part] for part in want]
        tdt, tol = torch.float64, 1e-9
    else:
        params, bstats, gs = _jax_tree(setup, jnp.float32)
        want = jsr.precompute_symmreg_r(setup["ae_def"], params, bstats, setup["spec_j"], gs,
                                        jnp.asarray(x, jnp.float32))
        want = [[np.asarray(a, np.float64) for a in part] for part in want]
        tdt, tol = torch.float32, 1e-5
    ae, spec, state = _port(setup, tdt)
    got = sr.precompute_symmreg_r(ae, spec, state, torch.tensor(x, dtype=tdt))
    for gl, wl in zip(got, want):
        assert len(gl) == len(wl) > 0
        for g, w in zip(gl, wl):
            assert g.shape == w.shape
            assert _nrel(g.double().numpy(), w) < tol


def test_closure_fast_path_matches_jax(setup):
    """make_symmreg_i_fast without the fused rollout (the closure form):
    per-lane value against the JAX package's, and equal to the composed
    symmreg_i within 1e-5."""
    params, bstats, gs = _jax_tree(setup, jnp.float32)
    lib_j = jmake_config(2, poly_order=2)[0].library
    prep_j, pen_j = jsr.make_symmreg_i_fast(setup["ae_def"], params, bstats, setup["spec_j"],
                                            gs, INT_T, INT_DT)
    want = np.array([float(pen_j(lambda q, A=jnp.asarray(Xi, jnp.float32): lib_j(q) @ A.T,
                                 jnp.asarray(x, jnp.float32), prep_j(jnp.asarray(x, jnp.float32))))
                     for Xi, x in zip(setup["Xi"], setup["x"])])
    ae, spec, state = _port(setup, torch.float32)
    lib = make_config(2, poly_order=2)[0].library
    prep, pen = sr.make_symmreg_i_fast(ae, spec, state, INT_T, INT_DT)
    assert not getattr(pen, "wants_coefs", False)
    x = torch.tensor(setup["x"], dtype=torch.float32)
    XiM = torch.tensor(setup["Xi"], dtype=torch.float32)
    got = pen(lambda q: lib(q) @ XiM.mT, x, prep(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    composed = _port_value_and_grad(setup, "i", torch.float32)[0]
    np.testing.assert_allclose(got, composed, rtol=1e-5)


def test_composed_symmreg_i_equals_fused_fast_path(setup):
    """The composed symmreg_i (--symmreg_slow) and the fused fast path (the
    CLI's default) give one loss: value and gradient within 1e-5."""
    ae, spec, state = _port(setup, torch.float32)
    lib = make_config(2, poly_order=2)[0].library
    prep, pen = sr.make_symmreg_i_fast(ae, spec, state, INT_T, INT_DT, fused_rollout_lib=lib)
    x = torch.tensor(setup["x"], dtype=torch.float32)
    XiM = torch.tensor(setup["Xi"], dtype=torch.float32, requires_grad=True)
    fused = pen(XiM, x, prep(x))
    (g_fused,) = torch.autograd.grad(fused.sum(), XiM)
    v, g = _port_value_and_grad(setup, "i", torch.float32)
    np.testing.assert_allclose(fused.detach().numpy(), v, rtol=1e-5)
    for a, b in zip(g_fused.numpy(), g):
        assert _nrel(a, b) < 1e-5, _nrel(a, b)
