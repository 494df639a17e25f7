"""Card-only tests of the port: the CUDA kernel K1 against its plain PyTorch
version on the same CUDA tensors.

This file imports nothing of JAX, so it runs on a machine with a card and no
JAX; the conftest imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips. Per lane the masks and stop epochs
must be equal and theta within atol 1e-3 (the repository's bar between two
L-BFGS implementations); the kernel and the plain version do the same f32
operations, mostly in the same order.
"""

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep as k1
from symmetry_ode_discovery_tpu_torch.ops.integrators import solve_ode_batch
from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams
from symmetry_ode_discovery_tpu_torch.training.sweep import stacked_lanes, sweep_sindy_lbfgs
from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth

SO2 = np.array([[0.0, 1.0], [-1.0, 0.0]])
SCALING2 = np.array([[2.0, 0.0], [0.0, 1.0]])
SEEDS = list(range(8))
CASES = {
    # name: (system, n_ics, steps, dt, config kwargs, hyper-parameters)
    "dosc_unconstrained": ("dosc", 20, 200, 0.01, dict(),
                           dict(lr_sindy=1.0, st_freq=30, threshold=5e-2,
                                sindy_reg_type="none")),
    "dosc_so2": ("dosc", 30, 200, 0.01, dict(L_list=[SO2]),
                 dict(lr_sindy=1.0, st_freq=30, threshold=1e-2, sindy_reg_type="none")),
    "growth_scaling2_const": ("growth", 30, 80, 0.02,
                              dict(L_list=[SCALING2], constrain_constant=True),
                              dict(lr_sindy=1.0, st_freq=40, threshold=5e-2,
                                   sindy_reg_type="none")),
    "dosc_l1": ("dosc", 20, 200, 0.01, dict(),
                dict(lr_sindy=0.1, st_freq=30, threshold=5e-2, sindy_reg_type="l1",
                     w_sindy_reg=1e-3)),
    "lv_protocol": ("lv", 40, 2000, 0.002, dict(include_exp=True),
                    dict(lr_sindy=0.1, st_freq=20, threshold=0.15)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _lanes(name, device):
    system, n_ics, steps, dt, ckw, hkw = CASES[name]
    sys_ = SYSTEMS[system]
    x0 = sys_.sample_ics(torch.Generator().manual_seed(0), n_ics)
    x, dx = solve_ode_batch(sys_.f, x0, dt=dt, num_steps=steps)
    x, dx = x.reshape(-1, 2), dx.reshape(-1, 2)
    cfg, Q = make_config(2, poly_order=2, **ckw)
    hp = LBFGSHParams(num_epochs=100, **hkw)
    return stacked_lanes(cfg, Q, [x], [dx], hp, SEEDS, 0.5, device)


def _check_lanes(got, want):
    theta, mask, stop = (a.cpu().numpy() for a in got)
    ref_theta, ref_mask, ref_stop = (a.cpu().numpy() for a in want)
    np.testing.assert_array_equal(stop, ref_stop)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_allclose(theta, ref_theta, atol=1e-3, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_device, name):
    pcfg, lanes, Mmap = _lanes(name, cuda_device)
    before = k1.launches
    got = k1.lbfgs_sweep(pcfg, *lanes, Mmap)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    _check_lanes(got, k1.lbfgs_sweep_plain(pcfg, *lanes, Mmap))


def test_kernel_nan_lane_stops_like_plain(cuda_device):
    pcfg, (S, B, q, ne, th0), Mmap = _lanes("dosc_unconstrained", cuda_device)
    S = S.clone()
    S[1, 2, 3] = float("nan")
    got = k1.lbfgs_sweep(pcfg, S, B, q, ne, th0, Mmap)
    _check_lanes(got, k1.lbfgs_sweep_plain(pcfg, S, B, q, ne, th0, Mmap))
    assert int(got[2][1]) == 0 and bool(torch.isnan(got[0][1]).all())


def test_kernel_work_counts(cuda_device):
    pcfg, lanes, Mmap = _lanes("dosc_so2", cuda_device)
    work = torch.zeros((len(SEEDS), 2), dtype=torch.int32, device=cuda_device)
    k1.lbfgs_sweep(pcfg, *lanes, Mmap, work=work)
    evals = work[:, 0].cpu()
    assert bool((evals >= 1).all()) and bool((work[:, 1] >= 0).all())


def test_sweep_on_card_recovers_dosc(cuda_device):
    sys_ = SYSTEMS["dosc"]
    x0 = sys_.sample_ics(torch.Generator().manual_seed(1), 20)
    x, dx = solve_ode_batch(sys_.f, x0, dt=0.01, num_steps=200)
    cfg, Q = make_config(2, poly_order=2, L_list=[SO2], threshold=1e-2)
    hp = LBFGSHParams(num_epochs=30, lr_sindy=1.0, sindy_reg_type="none",
                      st_freq=30, threshold=1e-2)
    before = k1.launches
    res = sweep_sindy_lbfgs(cfg, Q, x.reshape(-1, 2), dx.reshape(-1, 2),
                            sindy_truth["dosc"], hp, SEEDS, lbfgs_subsample=0.5)
    assert k1.launches == before + 1
    assert res.correct_form.all() and (res.mse < 1e-5).all()
