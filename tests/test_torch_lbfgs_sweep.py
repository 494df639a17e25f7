"""The port's fused L-BFGS sweep (K1) against the JAX package's Pallas kernel.

The JAX side runs ``pallas_lbfgs_sweep(..., interpret=True)`` on the CPU, as
tests/test_pallas_lbfgs.py does, on the fixtures of that file; the port runs
``lbfgs_sweep_plain`` on the same numpy inputs. Per lane the masks and the
stop epochs must be equal and theta within atol 1e-3, the repository's bar
for two L-BFGS implementations (tests/test_pallas_lbfgs.py). Interpret mode
compiles one program per configuration, so each fixture is one call with
several lanes and at most 30 epochs.

The kernel-against-plain cases on the same fixtures are in
tests/test_torch_cuda.py, which imports no JAX so that it runs on a machine
with a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu.models.sindy import make_config as jax_make_config
from symmetry_ode_discovery_tpu.ops.integrators import solve_ode_batch
from symmetry_ode_discovery_tpu.ops.pallas_lbfgs import PLBFGSConfig as JaxConfig
from symmetry_ode_discovery_tpu.ops.pallas_lbfgs import pallas_lbfgs_sweep
from symmetry_ode_discovery_tpu.training.siged import LBFGSHParams as JaxHParams
from symmetry_ode_discovery_tpu.training.sweep import _pallas_setup, _prep_normal_eq
from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep as k1
from symmetry_ode_discovery_tpu_torch.ops.lbfgs_sweep import PLBFGSConfig, lbfgs_sweep_plain

SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]])


def _flat(name, n_ics, steps, dt):
    sys_ = SYSTEMS[name]
    x0 = sys_.sample_ics(jax.random.PRNGKey(0), n_ics)
    x, dx = solve_ode_batch(sys_.f, x0, dt=dt, num_steps=steps)
    return (np.asarray(jnp.transpose(x, (1, 0, 2)).reshape(-1, 2)),
            np.asarray(jnp.transpose(dx, (1, 0, 2)).reshape(-1, 2)))


def _fixture(name):
    """(kernel config fields, S, B, q, n_elems, theta0, Mmap) as numpy."""
    if name in ("dosc_unconstrained", "dosc_l1", "dosc_nan_lane"):
        x, dx = _flat("dosc", 20, 200, 0.01)
        jcfg, Q = jax_make_config(2, poly_order=2)
        if name == "dosc_l1":
            # lr 0.1, the LV protocol's: at lr 1.0 the L1 subgradient makes
            # the fixed-step iteration diverge in the JAX kernel itself (a
            # lane reaches |theta| ~ 1e11), which no two f32 implementations
            # can follow step for step
            hp = JaxHParams(num_epochs=30, lr_sindy=0.1, st_freq=30,
                            threshold=5e-2, sindy_reg_type="l1", w_sindy_reg=1e-3)
        else:
            hp = JaxHParams(num_epochs=30, lr_sindy=1.0, st_freq=30,
                            threshold=5e-2, sindy_reg_type="none")
    elif name == "dosc_so2":
        x, dx = _flat("dosc", 30, 200, 0.01)
        jcfg, Q = jax_make_config(2, poly_order=2, L_list=[SO2], threshold=1e-2)
        hp = JaxHParams(num_epochs=30, lr_sindy=1.0, sindy_reg_type="none",
                        st_freq=30, threshold=1e-2)
    elif name == "growth_scaling2_const":
        x, dx = _flat("growth", 30, 80, 0.02)
        jcfg, Q = jax_make_config(2, poly_order=2, L_list=[SCALING2],
                                  constrain_constant=True, threshold=5e-2)
        hp = JaxHParams(num_epochs=30, lr_sindy=1.0, sindy_reg_type="none",
                        st_freq=30, threshold=5e-2)
    else:
        raise KeyError(name)
    pcfg, Mmap, n_params = _pallas_setup(jcfg, Q, hp)
    S, B, q, ne, th0 = _prep_normal_eq(jcfg, x.shape[0] // 2, n_params,
                                       jnp.asarray(x), jnp.asarray(dx),
                                       jnp.arange(4))
    S, B, q, ne, th0 = (np.array(a, dtype=np.float32) for a in (S, B, q, ne, th0))
    if name == "dosc_nan_lane":
        S[1, 2, 3] = np.nan
    return pcfg, S, B, q, ne, th0, Mmap


FIXTURES = ["dosc_unconstrained", "dosc_so2", "growth_scaling2_const", "dosc_l1",
            "dosc_nan_lane"]


def _port_config(jcfg: JaxConfig) -> PLBFGSConfig:
    return PLBFGSConfig(**{f: getattr(jcfg, f) for f in PLBFGSConfig.__dataclass_fields__})


def _check_lanes(theta, mask, stop, ref_theta, ref_mask, ref_stop):
    np.testing.assert_array_equal(stop, ref_stop)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_allclose(theta, ref_theta, atol=1e-3, equal_nan=True)


@pytest.mark.parametrize("name", FIXTURES)
def test_plain_matches_pallas_interpret(name):
    pcfg, S, B, q, ne, th0, Mmap = _fixture(name)
    ref = pallas_lbfgs_sweep(pcfg, *(jnp.asarray(a) for a in (S, B, q, ne, th0)),
                             Mmap=Mmap, interpret=True)
    ref = [np.asarray(a) for a in ref]
    got = lbfgs_sweep_plain(_port_config(pcfg),
                            *(torch.as_tensor(a) for a in (S, B, q, ne, th0)),
                            None if Mmap is None else torch.as_tensor(Mmap))
    got = [a.numpy() for a in got]
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    assert got[2].dtype == np.int32
    _check_lanes(*got, *ref)
    if name == "dosc_nan_lane":
        assert np.isnan(got[0][1]).all() and got[2][1] == 0
        assert np.isfinite(got[0][[0, 2, 3]]).all()
    else:
        assert np.isfinite(got[0]).all()


@pytest.mark.parametrize("name", ["dosc_unconstrained", "dosc_so2", "growth_scaling2_const"])
def test_plain_matches_pallas_interpret_short_history(name):
    """A history of 4 pairs: every lane fills it and then drops its oldest
    pair on each further update (the JAX kernel's compacting shift, the CUDA
    kernel's ring), many times over the 30 epochs."""
    pcfg, S, B, q, ne, th0, Mmap = _fixture(name)
    pcfg = dataclasses.replace(pcfg, history=4)
    ref = pallas_lbfgs_sweep(pcfg, *(jnp.asarray(a) for a in (S, B, q, ne, th0)),
                             Mmap=Mmap, interpret=True)
    got = lbfgs_sweep_plain(_port_config(pcfg),
                            *(torch.as_tensor(a) for a in (S, B, q, ne, th0)),
                            None if Mmap is None else torch.as_tensor(Mmap))
    _check_lanes(*(a.numpy() for a in got), *(np.asarray(a) for a in ref))
    assert np.isfinite(got[0].numpy()).all()


def test_wrapper_uses_plain_on_cpu():
    pcfg, S, B, q, ne, th0, Mmap = _fixture("dosc_unconstrained")
    args = [torch.as_tensor(a) for a in (S, B, q, ne, th0)]
    before = k1.launches
    got = k1.lbfgs_sweep(_port_config(pcfg), *args, None)
    want = lbfgs_sweep_plain(_port_config(pcfg), *args, None)
    assert k1.launches == before  # the CPU path launches no kernel
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_checks_inputs():
    """The wrapper takes only what the kernel takes, on the CPU path too."""
    pcfg, S, B, q, ne, th0, Mmap = _fixture("dosc_so2")
    cfg = _port_config(pcfg)
    args = [torch.as_tensor(a) for a in (S, B, q, ne, th0)]
    mm = torch.as_tensor(np.ascontiguousarray(Mmap))
    bad = [
        (dict(), mm.T.contiguous().T),                      # column-major Mmap
        (dict(S=args[0].double()), mm),                     # wrong dtype
        (dict(theta0=args[4][:, :-1]), mm),                 # wrong shape
        (dict(S=torch.zeros(4, 6, 6, device="meta")), mm),  # neither cpu nor cuda
    ]
    names = ["S", "B", "q", "n_elems", "theta0"]
    for override, mmap in bad:
        kw = dict(zip(names, args), **override)
        with pytest.raises(ValueError):
            k1.lbfgs_sweep(cfg, **kw, Mmap=mmap)
    k1.lbfgs_sweep(cfg, *args, mm)  # the same inputs, well-formed, pass
    with pytest.raises(ValueError):
        k1.lbfgs_sweep(PLBFGSConfig(d=2, p=6, n_params=200), *args)
