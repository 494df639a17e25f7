"""The port's data generation against the JAX package's, on the same numpy
inputs (the random draws themselves differ by design: torch vs JAX RNG)."""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.data import systems as jax_systems
from symmetry_ode_discovery_tpu.ops.gp_smoothing import num_diff_gp as jax_num_diff_gp
from symmetry_ode_discovery_tpu.ops.integrators import solve_ode_batch as jax_solve
from symmetry_ode_discovery_tpu_torch.data import datasets, systems
from symmetry_ode_discovery_tpu_torch.data.generate import gen_data, gen_data_levels
from symmetry_ode_discovery_tpu_torch.ops.gp_smoothing import num_diff_gp
from symmetry_ode_discovery_tpu_torch.ops.integrators import solve_ode_batch

REPO = Path(__file__).resolve().parents[1]
NAMES = ["lv", "dosc", "growth", "selkov"]


def _x(n=40, seed=0, scale=1.0):
    return (np.random.default_rng(seed).uniform(-1, 1, size=(n, 2)) * scale).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_vector_fields_match_jax(name):
    # elementwise f32 arithmetic, exp from different libraries: 1e-6 relative
    x = _x()
    ref = np.asarray(getattr(jax_systems, name)(jnp.asarray(x)))
    got = getattr(systems, name)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_hamiltonian_matches_jax():
    x = _x()
    np.testing.assert_allclose(systems.H_lv(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_systems.H_lv(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["lv", "dosc", "growth"])
def test_solve_ode_batch_matches_jax(name):
    # the same RK4 update in f32; 300 steps accumulate a few ulps: 1e-5 relative
    x0 = _x(8, seed=1, scale=0.5) + (0.6 if name == "growth" else 0.0)
    f_jax = getattr(jax_systems, name)
    f_port = getattr(systems, name)
    xs, dxs = jax_solve(f_jax, jnp.asarray(x0), dt=0.01, num_steps=300)
    ps, pdxs = solve_ode_batch(f_port, torch.as_tensor(x0), dt=0.01, num_steps=300)
    assert tuple(ps.shape) == (300, 8, 2)
    np.testing.assert_allclose(ps.numpy(), np.asarray(xs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdxs.numpy(), np.asarray(dxs), rtol=1e-5, atol=1e-6)


def _noisy(seq_len=400, n_trajs=6, noise=0.1):
    rng = np.random.default_rng(2)
    t = np.arange(seq_len) * 0.01
    phase = rng.uniform(0, 2 * np.pi, size=(1, n_trajs, 1))
    x = np.concatenate([np.sin(t[:, None, None] + phase),
                        np.cos(2 * t[:, None, None] + phase)], axis=-1)
    return (x + noise * rng.normal(size=x.shape)).astype(np.float32)


def test_num_diff_gp_f64_matches_jax():
    # both engines are float64 (scipy on the host vs torch); outputs are
    # rounded to f32, so 1e-6 relative
    x = _noisy(noise=0.1)
    dx_j, xs_j = jax_num_diff_gp(jnp.asarray(x), 0.01, 0.1, None, sigma_in=0.1,
                                 engine="f64")
    dx_p, xs_p = num_diff_gp(torch.as_tensor(x), 0.01, 0.1, sigma_in=0.1, engine="f64")
    np.testing.assert_allclose(xs_p.numpy(), np.asarray(xs_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx_p.numpy(), np.asarray(dx_j), rtol=1e-6, atol=1e-5)


def test_num_diff_gp_f32_matches_jax():
    # The smoothed signal: f32 Cholesky and solves sum in another order than
    # XLA's, 1e-4 of the signal's scale. The derivative goes through
    # D = (K2 - K)/1e-3, where one ulp of exp (ATen's and XLA's differ on
    # ~10% of the kernel entries) is 1e-4 of D; the f32 engine of EITHER
    # package is ~2.5e-4 of scale away from the f64 result here. So the two
    # f32 derivatives agree to 5e-4 of scale, and the port's is no further
    # from the f64 result than the JAX package's (to 10%).
    x = _noisy(noise=0.3)
    dx_j, xs_j = jax_num_diff_gp(jnp.asarray(x), 0.01, 0.3, None, sigma_in=0.1,
                                 engine="f32")
    dx_p, xs_p = num_diff_gp(torch.as_tensor(x), 0.01, 0.3, sigma_in=0.1, engine="f32")
    dx_64, _ = num_diff_gp(torch.as_tensor(x), 0.01, 0.3, sigma_in=0.1, engine="f64")
    dx_j, xs_j, dx_64 = np.asarray(dx_j), np.asarray(xs_j), dx_64.numpy()
    scale_x = np.abs(xs_j).max()
    scale_dx = np.abs(dx_j).max()
    np.testing.assert_allclose(xs_p.numpy(), xs_j, rtol=1e-4, atol=1e-4 * scale_x)
    np.testing.assert_allclose(dx_p.numpy(), dx_j, rtol=0, atol=5e-4 * scale_dx)
    err_port = np.abs(dx_p.numpy() - dx_64).max()
    err_jax = np.abs(dx_j - dx_64).max()
    assert err_port <= 1.1 * err_jax, (err_port, err_jax)


def test_num_diff_gp_auto_engine_rule():
    x = torch.as_tensor(_noisy(seq_len=50, n_trajs=2))
    for noise, engine in [(0.1, "f64"), (0.15, "f32"), (0.5, "f32")]:
        auto = num_diff_gp(x, 0.01, noise, sigma_in=0.1)
        fixed = num_diff_gp(x, 0.01, noise, sigma_in=0.1, engine=engine)
        for a, b in zip(auto, fixed):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lv_ics_in_hamiltonian_window():
    gen = torch.Generator().manual_seed(0)
    x0 = systems.sample_ics_lv(gen, 500)
    h = systems.H_lv(x0)
    assert x0.shape == (500, 2)
    assert bool(((h >= 3.0) & (h <= 4.5)).all())


@pytest.mark.parametrize("name", NAMES)
def test_ic_samplers_in_range(name):
    x0 = systems.SYSTEMS[name].sample_ics(torch.Generator().manual_seed(1), 200)
    assert x0.shape == (200, 2) and bool(torch.isfinite(x0).all())
    if name == "growth":
        assert bool(((x0 >= 0.2) & (x0 <= 1.0)).all())
    if name == "dosc":
        r = x0.norm(dim=1)
        assert bool(((r >= 0.5 - 1e-6) & (r <= 2.0 + 1e-6)).all())


def test_gen_data_shapes_and_determinism():
    sys_ = systems.SYSTEMS["growth"]
    kw = dict(n_ics=5, num_steps=100, noise=0.05, multiplicative_noise=True,
              smoothing="gp", device="cpu")
    x1, dx1 = gen_data(sys_, torch.Generator().manual_seed(3), **kw)
    x2, dx2 = gen_data(sys_, torch.Generator().manual_seed(3), **kw)
    assert x1.shape == dx1.shape == (5, 10, 2)
    assert x1.dtype == dx1.dtype == torch.float32
    assert bool(torch.isfinite(x1).all() and torch.isfinite(dx1).all())
    np.testing.assert_array_equal(x1.numpy(), x2.numpy())
    np.testing.assert_array_equal(dx1.numpy(), dx2.numpy())


@pytest.mark.parametrize("name,multiplicative", [("lv", False), ("growth", True)])
def test_gen_data_levels_equals_each_level_alone(name, multiplicative):
    """One RK4 solve over every level's ICs: each level bit for bit as
    gen_data gives it alone, the clean level and the noisy ones."""
    sys_ = systems.SYSTEMS[name]
    levels = [0.0, 0.1, 0.5]
    kw = dict(n_ics=4, num_steps=300, subsample_rate=10,
              multiplicative_noise=multiplicative, smoothing="gp", device="cpu")
    gens = lambda: [torch.Generator().manual_seed(7 + i) for i in range(len(levels))]
    together = gen_data_levels(sys_, gens(), levels, **kw)
    for (x, dx), gen, noise in zip(together, gens(), levels):
        x1, dx1 = gen_data(sys_, gen, noise=noise, **kw)
        assert x.shape == x1.shape == (4, 30, 2)
        np.testing.assert_array_equal(x.numpy(), x1.numpy())
        np.testing.assert_array_equal(dx.numpy(), dx1.numpy())


def test_gen_data_clean_is_exact_rk4():
    sys_ = systems.SYSTEMS["dosc"]
    x, dx = gen_data(sys_, torch.Generator().manual_seed(0), n_ics=3,
                     num_steps=200, device="cpu")
    assert x.shape == (3, 2, 2)  # subsample 100
    np.testing.assert_allclose(dx.numpy(), systems.dosc(x).numpy(), rtol=1e-6)


def test_default_cache_dir_outside_repo(monkeypatch):
    from symmetry_ode_discovery_tpu.data.datasets import DATA_PATH as JAX_DATA_PATH

    monkeypatch.delenv("SODT_TORCH_DATA_PATH", raising=False)
    path = Path(datasets.data_path())
    assert path == Path.home() / ".cache" / "symmetry_ode_discovery_tpu_torch" / "data"
    # never the JAX package's cache (./data, relative to the checkout)
    assert path.resolve() != Path(JAX_DATA_PATH).resolve()
    assert path.resolve() != (REPO / "data").resolve()
    monkeypatch.setenv("SODT_TORCH_DATA_PATH", "/elsewhere/cache")
    assert datasets.data_path() == "/elsewhere/cache"


def test_cache_roundtrip_and_jax_cache_read(tmp_path):
    # a cache in the JAX package's format and naming, read through `path`
    x = np.random.default_rng(0).normal(size=(4, 7, 2)).astype(np.float32)
    np.save(tmp_path / "dosc-train-noise20-gp-x.npy", x)
    np.save(tmp_path / "dosc-train-noise20-gp-dx.npy", 2 * x)
    ds = datasets.ODEDataset.make("dosc", "train", noise=0.2, smoothing="gp",
                                  path=str(tmp_path), device="cpu")
    assert len(ds) == 28 and ds.input_dim == 2
    np.testing.assert_array_equal(ds.x.numpy(), x.reshape(-1, 2))
    np.testing.assert_array_equal(ds.dx.numpy(), 2 * x.reshape(-1, 2))
    # a miss generates with the system's protocol and writes the cache
    ds2 = datasets.ODEDataset.make("dosc", "val", noise=0.0, path=str(tmp_path),
                                   n_ics=2, device="cpu")
    assert ds2.trajs_x.shape == (2, 100, 2)
    assert os.path.exists(tmp_path / "dosc-val-noise00-x.npy")
