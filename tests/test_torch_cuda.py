"""Card-only tests of the port: the CUDA kernels against their plain PyTorch
versions on the same CUDA tensors (K1, the fused L-BFGS sweep; K2 and K3,
the frozen-autoencoder chains; K4, the two-loop direction).

This file imports nothing of JAX, so it runs on a machine with a card and no
JAX; the conftest imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips. Per lane the masks and stop epochs
must be equal and theta within atol 1e-3 (the repository's bar between two
L-BFGS implementations); the kernel and the plain version do the same f32
operations, mostly in the same order. K2 and K3 sum their 512-term products
in another order than cuBLAS: outputs agree to 1e-4 of the output's scale
on all but a small share of rows, where a pre-activation within rounding of
0 flips a ReLU mask. K4 agrees to 1e-5 of the direction's scale.
"""

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir as k4
from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep as k1
from symmetry_ode_discovery_tpu_torch.ops import symmpen
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


def _random_chain(rng, device, widths):
    Ws = [rng.standard_normal((a, b)) * np.sqrt(2.0 / a) for a, b in zip(widths[:-1], widths[1:])]
    bs = [0.1 * rng.standard_normal(b) for b in widths[1:]]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return symmpen.FoldedMLP.make([t(w) for w in Ws], [t(b) for b in bs])


def _assert_rows_close(got, want, share=0.005):
    """max |diff| within 1e-4 of the output's scale on all but `share` of
    the rows (a mask flip moves a whole row)."""
    scale = float(want.abs().max())
    bad = ((got - want).abs() > 1e-4 * scale).any(dim=1)
    assert bool(torch.isfinite(got).all())
    assert int(bad.sum()) <= share * got.shape[0], (int(bad.sum()), got.shape[0])


@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_symmpen_kernels_match_plain(cuda_device, kind):
    rng = np.random.default_rng(11)
    f = _random_chain(rng, cuda_device, [2] + [512] * 5 + [2])
    rows = 3001  # not a multiple of the 32-row tile
    a = torch.as_tensor(rng.standard_normal((rows, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((rows, 2)), dtype=torch.float32, device=cuda_device)
    plain = {"enc_fwd": lambda: symmpen.enc_fwd_plain(f, a),
             "enc_bwd": lambda: symmpen.enc_bwd_plain(f, a, b),
             "dec_jvp": lambda: symmpen.dec_jvp_fwd_plain(f, a, b),
             "dec_jvp_bwd": lambda: symmpen.dec_jvp_bwd_plain(f, a, b)}[kind]
    kernel = {"enc_fwd": lambda: symmpen.enc_fwd_kernel(f, a),
              "enc_bwd": lambda: symmpen.enc_bwd_kernel(f, a, b),
              "dec_jvp": lambda: symmpen.dec_jvp_fwd_kernel(f, a, b),
              "dec_jvp_bwd": lambda: symmpen.dec_jvp_bwd_kernel(f, a, b)}[kind]
    before = symmpen.launches[kind]
    got = kernel()
    torch.cuda.synchronize()
    assert symmpen.launches[kind] == before + 1
    _assert_rows_close(got, plain())


def test_symmpen_autograd_functions_on_card(cuda_device):
    rng = np.random.default_rng(12)
    f = _random_chain(rng, cuda_device, [2] + [512] * 3 + [2])
    x = torch.as_tensor(rng.standard_normal((500, 2)), dtype=torch.float32,
                        device=cuda_device).requires_grad_(True)
    u = torch.as_tensor(rng.standard_normal((500, 2)), dtype=torch.float32,
                        device=cuda_device).requires_grad_(True)
    outs = []
    for enc, jvp in ((symmpen.enc_apply, symmpen.dec_jvp),
                     (symmpen.enc_apply_plain, symmpen.dec_jvp_plain)):
        z = enc(f, x)
        v = jvp(f, z, u)
        loss = (v ** 2).mean() + (z.sin() ** 2).mean()
        outs.append((z, v) + torch.autograd.grad(loss, (x, u)))
    for got, want in zip(outs[0], outs[1]):
        _assert_rows_close(got.detach(), want.detach())


def test_two_loop_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(13)
    for lanes, m, n in ((4, 100, 16), (3, 100, 70), (2, 7, 128)):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda_device).contiguous()
        s = rng.standard_normal((lanes, m, n))
        y = 0.8 * s + 0.1 * rng.standard_normal((lanes, m, n))
        rho = 1.0 / np.einsum("lkn,lkn->lk", s, y)
        rho[:, : m // 3] = 0.0  # empty slots in front
        g, gam = t(rng.standard_normal((lanes, n))), t(rng.uniform(0.5, 1.5, lanes))
        before = k4.launches
        got = k4.two_loop_direction(g, t(s), t(y), t(rho), gam)
        torch.cuda.synchronize()
        assert k4.launches == before + 1
        want = k4.two_loop_direction_plain(g, t(s), t(y), t(rho), gam)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
