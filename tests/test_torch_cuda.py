"""Card-only tests of the port: the CUDA kernels against their plain PyTorch
versions on the same CUDA tensors (K1, the fused L-BFGS sweep; K2 and K3,
the frozen-autoencoder chains, at hidden widths 128, 200, 201 and 512; K4, the
two-loop direction; K5 and K6, the GP tape evaluator and its constant
gradient, also on the tape decoder's edge cases).

This file imports nothing of JAX, so it runs on a machine with a card and no
JAX; the conftest imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips. Per lane the masks and stop epochs
must be equal and theta within atol 1e-3 (the repository's bar between two
L-BFGS implementations); the kernel and the plain version do the same f32
operations, mostly in the same order (also past 32 parameters, and with a
history of 4 pairs that the kernel's ring overwrites many times). K2 and
K3 sum their 512-term products in another order than cuBLAS: outputs agree
to 1e-4 of the output's scale on all but a small share of rows, where a
pre-activation within rounding of 0 flips a ReLU mask; fed the same masks,
every row agrees. K4 agrees to 1e-5 of the direction's scale with the same
NaN and inf positions, on six shapes (a misaligned slab, widths past 16
and 32) and the memory's edge cases. K5 gives the plain interpreter's
predictions bit for bit (NaN where it has NaN); K6 agrees within 1e-5 of
the sum over rows of |gbar * d pred / d const| (it sums rows in a fixed
order, the plain version through autograd) and gives the same bits on
every run. The bf16 modes: K2/K3 against their bf16 plain versions, rows
within 1e-2 of the output's scale (a mask flipped by a bf16 rounding step
may move a small share of rows) and at most 0.1% of the mask bits
differing, also on row counts that leave an odd number of CTAs (the
tensor-core backward's last cluster then has a CTA past the rows), on NaN
and exactly-zero rows and with the JVP at width 256; K5 in bf16 bit for
bit. STLSQ and WSINDy, which have no kernel of their own (cuSOLVER's
batched QR and SVD), against the same functions on the CPU: masks equal,
solves within 1e-5 of the coefficients' scale (residuals 1e-4), sweeps
within 1e-3; the constrained STLSQ branches, the growth constraint's Q
among them, which the STLSQ CLI never reaches.
"""

import dataclasses

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir as k4
from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep as k1
from symmetry_ode_discovery_tpu_torch.ops import symmpen, tape_eval
from symmetry_ode_discovery_tpu_torch.symgp import tape as tt
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_short_history(cuda_device, name):
    """A history of 4 pairs over 30 epochs: the kernel's ring wraps many
    times on every lane; the plain version shifts its chronological memory."""
    pcfg, lanes, Mmap = _lanes(name, cuda_device)
    pcfg = dataclasses.replace(pcfg, history=4, num_epochs=30)
    _check_lanes(k1.lbfgs_sweep(pcfg, *lanes, Mmap), k1.lbfgs_sweep_plain(pcfg, *lanes, Mmap))


def _wide_lanes(d, p, device, lanes=8):
    """Synthetic normal equations at a library's shape past one warp's 32
    slots: S with eigenvalues in [1, 1.5], a sparse Xi (a third of the
    terms, |coefficient| in [0.5, 1.5]), B = Xi S, q = sum_i Xi_i S Xi_i^T,
    N d = 2. Well-conditioned, so a 1-ulp change of S or B moves no stop
    epoch or mask in the plain version: two f32 implementations must agree.
    (d, p) = (3, 20) is 3-D poly3, (3, 26) 3-D poly3 with sine and exp,
    (5, 21) 5-D poly2."""
    rng = np.random.default_rng(d * 100 + p)
    S = np.empty((lanes, p, p))
    B = np.empty((lanes, d, p))
    q = np.empty(lanes)
    for lane in range(lanes):
        basis, _ = np.linalg.qr(rng.standard_normal((p, p)))
        S[lane] = (basis * rng.uniform(1.0, 1.5, p)) @ basis.T
        xi = (rng.uniform(0.5, 1.5, (d, p)) * rng.choice([-1.0, 1.0], (d, p))
              * (rng.random((d, p)) < 0.3))
        B[lane] = xi @ S[lane]
        q[lane] = np.einsum("ip,pq,iq->", xi, S[lane], xi)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    return (t(S), t(B), t(q), t(np.full(lanes, 2.0)),
            t(0.1 * rng.standard_normal((lanes, d * p))))


@pytest.mark.parametrize("history", [32, 4])
@pytest.mark.parametrize("d,p", [(3, 20), (3, 26), (5, 21)])
def test_kernel_matches_plain_wide(cuda_device, d, p, history):
    """The wider templates (two, three and four 32-wide slices a warp)
    against the plain version, with the default history and with one of 4
    pairs."""
    cfg = k1.PLBFGSConfig(d=d, p=p, n_params=d * p, num_epochs=30, history=history, lr=1.0,
                          st_freq=10, threshold=0.2, reg_l1=False)
    inputs = _wide_lanes(d, p, cuda_device)
    _check_lanes(k1.lbfgs_sweep(cfg, *inputs), k1.lbfgs_sweep_plain(cfg, *inputs))


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


def _symmpen_pair(kind, f, a, b):
    """(kernel, plain) of one K2/K3 function on inputs a, b: the backward
    kinds read the masks of their own side's forward at a (b the cotangent)."""
    if kind == "enc_fwd":
        return (lambda: symmpen.enc_fwd_kernel(f, a)[0], lambda: symmpen.enc_fwd_plain(f, a)[0])
    if kind == "dec_jvp":
        return (lambda: symmpen.dec_jvp_fwd_kernel(f, a, b)[0],
                lambda: symmpen.dec_jvp_fwd_plain(f, a, b)[0])
    if kind == "enc_bwd":
        mk, mp = symmpen.enc_fwd_kernel(f, a)[1], symmpen.enc_fwd_plain(f, a)[1]
        return (lambda: symmpen.enc_bwd_kernel(f, mk, b), lambda: symmpen.enc_bwd_plain(f, mp, b))
    u = torch.ones_like(a)
    mk, mp = symmpen.dec_jvp_fwd_kernel(f, a, u)[1], symmpen.dec_jvp_fwd_plain(f, a, u)[1]
    return (lambda: symmpen.dec_jvp_bwd_kernel(f, mk, b),
            lambda: symmpen.dec_jvp_bwd_plain(f, mp, b))


@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_symmpen_kernels_match_plain(cuda_device, kind):
    rng = np.random.default_rng(11)
    f = _random_chain(rng, cuda_device, [2] + [512] * 5 + [2])
    rows = 3001  # not a multiple of the row tile
    a = torch.as_tensor(rng.standard_normal((rows, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((rows, 2)), dtype=torch.float32, device=cuda_device)
    kernel, plain = _symmpen_pair(kind, f, a, b)
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


TWO_LOOP_SHAPES = [(4, 100, 16), (3, 100, 70), (2, 7, 128), (4, 11, 17), (1, 1, 1), (2, 100, 33)]
TWO_LOOP_EDGES = ["leading_empty", "all_empty", "rho0_nonzero_sy", "neg_zero_g", "inf_g"]


def _two_loop_inputs(edge, lanes, m, n, device):
    """A curvature-consistent memory (y = 0.8 s + noise, rho = 1/(y.s)) with
    the first third of the slots empty (s = y = rho = 0), and the edge: all
    slots empty; weight 0 on a third of the pairs, s and y not 0; -0 and +0
    in g with gamma < 0; an inf in g."""
    rng = np.random.default_rng(13)
    s = rng.standard_normal((lanes, m, n))
    y = 0.8 * s + 0.1 * rng.standard_normal((lanes, m, n))
    rho = 1.0 / np.einsum("lkn,lkn->lk", s, y)
    g, gam = rng.standard_normal((lanes, n)), rng.uniform(0.5, 1.5, lanes)
    empty = m // 3
    s[:, :empty] = y[:, :empty] = rho[:, :empty] = 0.0
    if edge == "all_empty":
        s[:] = y[:] = rho[:] = 0.0
    elif edge == "rho0_nonzero_sy":
        rho[:, ::3] = 0.0
        s[:, :empty] = rng.standard_normal((lanes, empty, n))
        y[:, :empty] = rng.standard_normal((lanes, empty, n))
    elif edge == "neg_zero_g":
        g[:, ::2] = -0.0
        g[:, 1::4] = 0.0
        gam = -gam
    elif edge == "inf_g":
        g[:, n // 2] = np.inf
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    return t(g), t(s), t(y), t(rho), t(gam)


def _not_bit_equal(got, want):
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int((~((got.view(torch.int32) == want.view(torch.int32)) | both_nan)).sum())


@pytest.mark.parametrize("edge", TWO_LOOP_EDGES)
@pytest.mark.parametrize("lanes,m,n", TWO_LOOP_SHAPES)
def test_two_loop_kernel_matches_plain(cuda_device, lanes, m, n, edge, record_property):
    """K4 against its plain version: no element beyond 1e-5 of the
    direction's scale (over its finite elements), the same NaN and inf
    positions; the count of elements not bit-equal is recorded. The shapes
    hold a misaligned slab ((4, 11, 17): a lane's slab starts at 748 bytes),
    widths just past 16 and 32, and every template."""
    g, s, y, rho, gam = _two_loop_inputs(edge, lanes, m, n, cuda_device)
    before = k4.launches
    got = k4.two_loop_direction(g, s, y, rho, gam)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    want = k4.two_loop_direction_plain(g, s, y, rho, gam)
    record_property("not_bit_equal", _not_bit_equal(got, want))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 1.0
    assert int(((got - want).abs() > 1e-5 * scale)[fin].sum()) == 0


WIDTH_LAYERS = {128: 4, 200: 3, 201: 3, 512: 5}


@pytest.mark.parametrize("rows", ["1", "tile-1", "tile+1", "80000"])
@pytest.mark.parametrize("width", sorted(WIDTH_LAYERS))
@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_symmpen_kernels_any_width(cuda_device, kind, width, rows):
    """K2/K3 at the selkov checkpoint's width (128, 4 layers: the 128-wide
    tile, unguarded), a width that is no multiple of the 16-row K-block (200,
    3 layers: the 256-wide tile, guarded, its rows 16-byte aligned), an odd
    width (201, 3 layers: guarded, rows 4-byte aligned) and the LV width (512,
    5 layers: the 512-wide tile, unguarded); on 1 row, one row below and one
    above the kind's row tile at that width (as the kernel's launcher reports
    it), and 80,000 rows (the LV checkpoint's closure)."""
    tile = symmpen.row_tile(kind, width)
    n = {"1": 1, "tile-1": tile - 1, "tile+1": tile + 1, "80000": 80000}[rows]
    rng = np.random.default_rng(width)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    a = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    kernel, plain = _symmpen_pair(kind, f, a, b)
    got = kernel()
    torch.cuda.synchronize()
    _assert_rows_close(got, plain())


@pytest.mark.parametrize("width", sorted(WIDTH_LAYERS))
@pytest.mark.parametrize("chain", ["enc_fwd", "dec_jvp"])
def test_symmpen_kernel_masks_match_plain(cuda_device, chain, width, record_property):
    """The mask bits a forward kernel writes, unpacked, equal the plain
    chain's [p > 0] except where |p| lies within f32 rounding of 0 (1e-4 of
    the sum of |terms| behind it); the count of such bits is reported."""
    rng = np.random.default_rng(100 + width)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    x = torch.as_tensor(rng.standard_normal((20000, 2)), dtype=torch.float32, device=cuda_device)
    if chain == "enc_fwd":
        packed = symmpen.enc_fwd_kernel(f, x)[1]
    else:
        packed = symmpen.dec_jvp_fwd_kernel(f, x, torch.ones_like(x))[1]
    torch.cuda.synchronize()
    assert tuple(packed.shape) == (len(f.Ws) - 1, 20000, symmpen.tile_width(width) // 8)
    flips, unexplained = symmpen.mask_agreement(f, x, packed)
    record_property("mask_bits_within_rounding_of_0", flips)
    n_bits = (len(f.Ws) - 1) * x.shape[0] * width
    print(f"{chain} width {width}: {flips} of {n_bits} mask bits differ, "
          f"all with |p| within rounding of 0: {unexplained == 0}")
    assert unexplained == 0, (flips, unexplained)


@pytest.mark.parametrize("width", sorted(WIDTH_LAYERS))
@pytest.mark.parametrize("kind", ["enc_bwd", "dec_jvp_bwd"])
def test_symmpen_backward_kernel_reads_forward_kernel_masks(cuda_device, kind, width):
    """The backward kernel fed the forward kernel's masks against the plain
    backward fed the same masks, unpacked: every row within 1e-4 of the
    output's scale (the masks agree by construction, so no row may flip)."""
    rng = np.random.default_rng(200 + width)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    rows = 5000
    a = torch.as_tensor(rng.standard_normal((rows, 2)), dtype=torch.float32, device=cuda_device)
    c = torch.as_tensor(rng.standard_normal((rows, 2)), dtype=torch.float32, device=cuda_device)
    if kind == "enc_bwd":
        packed = symmpen.enc_fwd_kernel(f, a)[1]
        got = symmpen.enc_bwd_kernel(f, packed, c)
    else:
        packed = symmpen.dec_jvp_fwd_kernel(f, a, torch.ones_like(a))[1]
        got = symmpen.dec_jvp_bwd_kernel(f, packed, c)
    torch.cuda.synchronize()
    want = symmpen._mask_bwd_plain(f, symmpen.unpack_masks(packed, width), c)
    _assert_rows_close(got, want, share=0.0)


def test_symmpen_backward_kernel_refuses_other_masks(cuda_device):
    """The backward kernels take only a forward kernel's packed buffer of
    the same rows: the plain route's bool masks, or another row count's
    buffer, raise before any launch."""
    rng = np.random.default_rng(1)
    f = _random_chain(rng, cuda_device, [2, 128, 128, 2])
    x = torch.as_tensor(rng.standard_normal((100, 2)), dtype=torch.float32, device=cuda_device)
    before = symmpen.launches["enc_bwd"]
    with pytest.raises(ValueError, match="forward kernel's contiguous uint8"):
        symmpen.enc_bwd_kernel(f, symmpen.enc_fwd_plain(f, x)[1], x)
    with pytest.raises(ValueError, match=r"\(2, 100, 16\)"):
        symmpen.enc_bwd_kernel(f, symmpen.enc_fwd_kernel(f, x[:50].contiguous())[1], x)
    assert symmpen.launches["enc_bwd"] == before


def test_symmpen_kernel_refuses_wider_than_512(cuda_device):
    f = _random_chain(np.random.default_rng(0), cuda_device, [2, 513, 513, 2])
    with pytest.raises(ValueError, match="up to 512"):
        symmpen.enc_fwd_kernel(f, torch.zeros((4, 2), device=cuda_device))


def _tapes(device, U=3, P=200, n_vars=3, seed=0):
    """U populations over every opcode, with hand-built edge tapes in front:
    an overflow, a division by 0, exp clipped both ways, an all-PAD tape."""
    spec = tt.TapeSpec(n_vars=n_vars, max_len=40, binary_ops=(tt.ADD, tt.SUB, tt.MUL, tt.DIV),
                       unary_ops=(tt.EXP, tt.SIN, tt.COS, tt.NEG))
    pops = [tt.random_population(np.random.default_rng(seed + u), spec, P) for u in range(U)]
    ops, args, consts = (np.stack([p[i] for p in pops]) for i in range(3))
    edge = [[(tt.VAR, 0, 0.0)] * 17 + [(tt.ADD, 0, 0.0)] * 16,
            [(tt.VAR, 1, 0.0), (tt.CONST, 0, 0.0), (tt.DIV, 0, 0.0)],
            [(tt.CONST, 0, 100.0), (tt.EXP, 0, 0.0), (tt.CONST, 0, -100.0), (tt.EXP, 0, 0.0),
             (tt.ADD, 0, 0.0)],
            []]
    for i, slots in enumerate(edge):
        ops[:, i], args[:, i], consts[:, i] = 0, 0, 0.0
        for l, (op, arg, c) in enumerate(slots):
            ops[:, i, l], args[:, i, l], consts[:, i, l] = op, arg, c
    t = lambda a: torch.as_tensor(a, device=device).contiguous()
    return t(ops), t(args), t(consts)


def _assert_bit_equal(got, want):
    both_nan = torch.isnan(got) & torch.isnan(want)
    same = (got.view(torch.int32) == want.view(torch.int32)) | both_nan
    assert bool(same.all()), int((~same).sum())


@pytest.mark.parametrize("N", [1, 300, 2500])
def test_tape_eval_kernel_matches_plain(cuda_device, N):
    ops, args, consts = _tapes(cuda_device)
    X = torch.as_tensor(np.random.default_rng(N).uniform(-2, 2, (3, N, 3)), dtype=torch.float32,
                        device=cuda_device)
    before = tape_eval.launches["tape_eval"]
    got = tape_eval.eval_tapes_kernel(ops, args, consts, X, 16)
    torch.cuda.synchronize()
    assert tape_eval.launches["tape_eval"] == before + 1
    want = tt.eval_tapes_plain(ops, args, consts, X, 16)
    _assert_bit_equal(got, want)
    assert bool(torch.isnan(got[:, 0]).all()) and not bool(got[:, 3].any())
    # a restricted op table: opcodes outside it yield 0, as in the plain version
    table = (tt.ADD, tt.MUL, tt.EXP)
    _assert_bit_equal(tape_eval.eval_tapes_kernel(ops, args, consts, X, 16, table),
                      tt.eval_tapes_plain(ops, args, consts, X, 16, table))


def test_tape_grad_kernel_matches_plain(cuda_device):
    ops, args, consts = _tapes(cuda_device, P=96)
    N = 300
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.uniform(-2, 2, (3, N, 3)), dtype=torch.float32, device=cuda_device)
    gbar = torch.as_tensor(rng.standard_normal((3, 96, N)), dtype=torch.float32,
                           device=cuda_device)
    before = tape_eval.launches["tape_grad"]
    got = tape_eval.eval_tapes_grad_kernel(ops, args, consts, X, gbar, 16)
    again = tape_eval.eval_tapes_grad_kernel(ops, args, consts, X, gbar, 16)
    torch.cuda.synchronize()
    assert tape_eval.launches["tape_grad"] == before + 2
    _assert_bit_equal(got, again)  # no atomics: the same bits on every run
    want = tape_eval.eval_tapes_grad_plain(ops, args, consts, X, gbar, 16)
    # per-row contributions, each row a unit of its own, for the row-sum scale
    scale = torch.zeros_like(want)
    for u in range(3):
        rows = tape_eval.eval_tapes_grad_plain(
            ops[u:u + 1].expand(N, -1, -1), args[u:u + 1].expand(N, -1, -1),
            consts[u:u + 1].expand(N, -1, -1), X[u][:, None].contiguous(),
            gbar[u].T[..., None].contiguous(), 16)
        scale[u] = rows.abs().sum(0)
    both_nan = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both_nan, 0.0, (got - want).abs())
    assert bool((diff <= 1e-5 * scale).all()), float((diff / scale.clamp_min(1e-30)).max())
    assert not bool(got[ops != tt.CONST].any())


def test_tape_autograd_function_on_card(cuda_device):
    ops, args, consts = _tapes(cuda_device, P=64)
    X = torch.as_tensor(np.random.default_rng(2).uniform(-2, 2, (3, 257, 3)),
                        dtype=torch.float32, device=cuda_device)
    y = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 1, 257)),
                        dtype=torch.float32, device=cuda_device)
    c = consts.clone().requires_grad_(True)
    before = dict(tape_eval.launches)
    pred = tape_eval.eval_tapes(ops, args, c, X, 16)
    loss = torch.where(torch.isfinite(pred), (pred - y) ** 2, 0.0).mean(-1).sum()
    (g,) = torch.autograd.grad(loss, c)
    torch.cuda.synchronize()
    assert tape_eval.launches["tape_eval"] == before["tape_eval"] + 1
    assert tape_eval.launches["tape_grad"] == before["tape_grad"] + 1
    _assert_bit_equal(pred.detach(), tt.eval_tapes_plain(ops, args, consts, X, 16))
    c2 = consts.clone().requires_grad_(True)
    pred2 = tt.eval_tapes_plain(ops, args, c2, X, 16)
    loss2 = torch.where(torch.isfinite(pred2), (pred2 - y) ** 2, 0.0).mean(-1).sum()
    (g2,) = torch.autograd.grad(loss2, c2)
    ok = torch.isfinite(g2)
    assert bool((torch.isfinite(g) == ok).all())
    scale = g2[ok].abs().max()
    assert float((g - g2)[ok].abs().max()) <= 1e-4 * float(scale)


def _c(v):
    return (tt.CONST, 0, v)


def _op(code):
    return (code, 0, 0.0)


V0, V1 = (tt.VAR, 0, 0.0), (tt.VAR, 1, 0.0)
EVERY_OP = ((tt.ADD, tt.SUB, tt.MUL, tt.DIV), (tt.EXP, tt.SIN, tt.COS, tt.NEG))
# name: (stack depth, n_vars, L, op table, hand-built tapes in front of a
# random population over every opcode)
TAPE_EDGES = {
    # binary and unary ops at sp 0 and 1: operands read slot 0, written or not
    "underflow": (16, 2, 25, None, [
        [_op(tt.ADD), V0, _c(1.5), _op(tt.MUL)],
        [V0, _c(1.5), _op(tt.MUL), _op(tt.MUL), _op(tt.NEG)],
        [_op(tt.MUL), _op(tt.NEG), V0, _c(1.5), _op(tt.SUB), _op(tt.MUL), _op(tt.EXP)],
        [V1, _op(tt.DIV), _c(0.5), _op(tt.SUB), _op(tt.SIN)]]),
    # opcodes outside [0, 10] and in-range ones outside the table (the random
    # population's -, /, sin, cos and neg)
    "odd_opcodes": (16, 2, 25, (tt.ADD, tt.MUL, tt.EXP), [
        [V0, _c(3.0), (code, 0, 0.0), _op(tt.ADD), _c(0.5), _op(tt.MUL)]
        for code in (-12, -11, -1, 11, 12, tt.SUB, tt.SIN)] + [
        [(-1, 0, 0.0), V1, _c(2.0), (-7, 0, 0.0), _op(tt.MUL)]]),
    "depth_1": (1, 2, 25, None, [[V0, _op(tt.NEG), _op(tt.EXP)], [_c(0.5), _op(tt.COS)],
                                 [V0, V1, _op(tt.ADD)]]),
    "depth_64": (64, 2, 40, None, [[V0, _c(0.5)] * 10 + [_op(tt.MUL), _op(tt.ADD)] * 9 +
                                   [_op(tt.SUB)], [V1] * 40]),
    "L_40": (16, 2, 40, None, [[V0, _c(-1.25)] * 8 + [_op(tt.ADD), _op(tt.DIV)] * 7 +
                               [_op(tt.MUL)]]),
    "n_vars_1": (16, 1, 25, None, [[V0, V0, _op(tt.MUL), _c(2.0), _op(tt.SUB)]]),
    "n_vars_4": (16, 4, 25, None, [[(tt.VAR, v, 0.0) for v in range(4)] +
                                   [_op(tt.ADD), _op(tt.MUL), _op(tt.SUB)]]),
    # every leaf a constant; with every slot a CONST the 17th push overflows
    "const_every_slot": (16, 2, 25, None, [[_c(0.25 * (l + 1)) for l in range(25)],
                                           [_c(0.5), _c(1.5)] + [_c(0.75), _op(tt.MUL)] * 11 +
                                           [_op(tt.ADD)]]),
    "all_pad": (16, 2, 25, None, None),
}


def _edge_tapes(device, case, N, U=2):
    """U populations for one TAPE_EDGES case: its hand-built tapes in front
    of a random population over every opcode, P one more than a multiple of
    both kernels' tapes per CTA on N rows (all PAD for "all_pad")."""
    D, n_vars, L, table, hand = TAPE_EDGES[case]
    t5 = tape_eval.geometry(5, L, D, n_vars, N)[0]
    t6 = tape_eval.geometry(6, L, D, n_vars, N)[0]
    P = 3 * t5 * t6 + 1
    spec = tt.TapeSpec(n_vars=n_vars, max_len=L, binary_ops=EVERY_OP[0], unary_ops=EVERY_OP[1])
    pops = [tt.random_population(np.random.default_rng(10 + u), spec, P) for u in range(U)]
    ops, args, consts = (np.stack([p[i] for p in pops]) for i in range(3))
    if hand is None:
        ops[:] = tt.PAD
    for i, slots in enumerate(hand or []):
        ops[:, i], args[:, i], consts[:, i] = 0, 0, 0.0
        for l, (op, arg, c) in enumerate(slots):
            ops[:, i, l], args[:, i, l], consts[:, i, l] = op, arg, c
    t = lambda a: torch.as_tensor(a, device=device).contiguous()
    return t(ops), t(args), t(consts), D, n_vars, table


@pytest.mark.parametrize("rows", ["1", "31", "33", "pass-1", "pass+1", "5000"])
@pytest.mark.parametrize("case", sorted(TAPE_EDGES))
def test_tape_kernels_edge_cases(cuda_device, case, rows):
    """The decoder's edge cases: K5 bit for bit against the plain
    interpreter, K6 per element within 1e-5 of its row-sum scale and the
    same bits on a repeat run, at row counts around a warp (K6's pass) and
    around K5's pass of rows."""
    D, n_vars, L = TAPE_EDGES[case][:3]
    per_pass = tape_eval.geometry(5, L, D, n_vars, 1)[1]
    N = {"pass-1": per_pass - 1, "pass+1": per_pass + 1}.get(rows) or int(rows)
    ops, args, consts, D, n_vars, table = _edge_tapes(cuda_device, case, N)
    U, P, L = ops.shape
    rng = np.random.default_rng(N)
    X = torch.as_tensor(rng.uniform(-2, 2, (U, N, n_vars)), dtype=torch.float32,
                        device=cuda_device)
    X[:, 0] = 0.0
    got = tape_eval.eval_tapes_kernel(ops, args, consts, X, D, table)
    _assert_bit_equal(got, tt.eval_tapes_plain(ops, args, consts, X, D, table))
    if case == "all_pad":
        assert not bool(got.any())
    gbar = torch.as_tensor(rng.standard_normal((U, P, N)), dtype=torch.float32,
                           device=cuda_device)
    g = tape_eval.eval_tapes_grad_kernel(ops, args, consts, X, gbar, D, table)
    _assert_bit_equal(g, tape_eval.eval_tapes_grad_kernel(ops, args, consts, X, gbar, D, table))
    want = tape_eval.eval_tapes_grad_plain(ops, args, consts, X, gbar, D, table)
    scale = torch.stack([tape_eval.eval_tapes_grad_plain(
        ops[u:u + 1].expand(N, -1, -1), args[u:u + 1].expand(N, -1, -1),
        consts[u:u + 1].expand(N, -1, -1), X[u][:, None].contiguous(),
        gbar[u].T[..., None].contiguous(), D, table).abs().sum(0) for u in range(U)])
    both_nan = torch.isnan(g) & torch.isnan(want)
    diff = torch.where(both_nan, 0.0, (g - want).abs())
    assert bool((diff <= 1e-5 * scale).all()), float((diff / scale.clamp_min(1e-30)).max())
    assert not bool(g[ops != tt.CONST].any())


def test_tape_grad_kernel_padded_rows_no_nan_poisoning(cuda_device):
    """The JAX package's padded-rows case: exp(x0 + 35)^4 is finite on the
    rows (x0 near -30) and inf at x0 = 0; with 100 rows, less than one
    128-row tile, K6 reads no row past N and its gradient stays finite."""
    ops = np.zeros((1, 1, 20), np.int32)
    slots = [tt.VAR, tt.CONST, tt.ADD, tt.EXP] + [tt.VAR, tt.CONST, tt.ADD, tt.EXP, tt.MUL] * 3
    ops[0, 0, :len(slots)] = slots
    consts = np.zeros((1, 1, 20), np.float32)
    consts[0, 0, [1, 5, 10, 15]] = 35.0
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-31.0, -29.0, 100), rng.standard_normal(100)], axis=1)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=cuda_device).contiguous()
    args = t(np.zeros_like(ops), torch.int32)
    gbar = t(rng.standard_normal((1, 1, 100)))
    table = (tt.ADD, tt.MUL, tt.EXP)
    got = tape_eval.eval_tapes_grad_kernel(t(ops, torch.int32), args, t(consts), t(X[None]),
                                           gbar, 8, table)
    want = tape_eval.eval_tapes_grad_plain(t(ops, torch.int32), args, t(consts), t(X[None]),
                                           gbar, 8, table)
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("kernel,L,depth,n_vars", [
    (5, 4096, 16, 2), (6, 4096, 16, 2), (6, 2000, 16, 2), (5, 25, 65, 2), (6, 25, 0, 2),
    (5, 25, 16, 129)])
def test_tape_kernels_refuse_sizes_they_do_not_take(cuda_device, kernel, L, depth, n_vars):
    """The wrappers raise ValueError, and launch nothing, where the launcher
    refuses the sizes: tapes over 4,095 slots, K6's per-warp columns beyond
    a CTA's shared memory (L 2,000, which K5 takes), stack depths outside
    [1, 64], more than 128 variables."""
    U, P, N = 1, 3, 40
    ops = torch.full((U, P, L), tt.PAD, dtype=torch.int32, device=cuda_device)
    ops[..., 0] = tt.VAR
    args = torch.zeros_like(ops)
    consts = torch.zeros((U, P, L), dtype=torch.float32, device=cuda_device)
    X = torch.ones((U, N, n_vars), dtype=torch.float32, device=cuda_device)
    before = dict(tape_eval.launches)
    with pytest.raises(ValueError):
        if kernel == 5:
            tape_eval.eval_tapes_kernel(ops, args, consts, X, depth)
        else:
            gbar = torch.ones((U, P, N), dtype=torch.float32, device=cuda_device)
            tape_eval.eval_tapes_grad_kernel(ops, args, consts, X, gbar, depth)
    assert tape_eval.launches == before
    if L == 2000:
        got = tape_eval.eval_tapes_kernel(ops, args, consts, X, depth)
        _assert_bit_equal(got, tt.eval_tapes_plain(ops, args, consts, X, depth))


# ---- bf16 modes: K2/K3 (symmpen.cu, template BF) and K5 (tape_eval.cu) ----

BF16 = torch.bfloat16
BF16_SCALE_REL = 1e-2   # K2/K3 bf16: max |diff| over the output's scale
BF16_MASK_SHARE = 1e-3  # K2/K3 bf16: mask bits that may differ from the plain chain's


def _symmpen_pair_bf16(kind, f, a, b):
    """_symmpen_pair in bf16: each backward reads its own side's masks."""
    if kind == "enc_fwd":
        return (lambda: symmpen.enc_fwd_kernel(f, a, BF16)[0],
                lambda: symmpen.enc_fwd_plain(f, a, BF16)[0])
    if kind == "dec_jvp":
        return (lambda: symmpen.dec_jvp_fwd_kernel(f, a, b, BF16)[0],
                lambda: symmpen.dec_jvp_fwd_plain(f, a, b, BF16)[0])
    if kind == "enc_bwd":
        mk, mp = symmpen.enc_fwd_kernel(f, a, BF16)[1], symmpen.enc_fwd_plain(f, a, BF16)[1]
        return (lambda: symmpen.enc_bwd_kernel(f, mk, b, BF16),
                lambda: symmpen.enc_bwd_plain(f, mp, b, BF16))
    u = torch.ones_like(a)
    mk = symmpen.dec_jvp_fwd_kernel(f, a, u, BF16)[1]
    mp = symmpen.dec_jvp_fwd_plain(f, a, u, BF16)[1]
    return (lambda: symmpen.dec_jvp_bwd_kernel(f, mk, b, BF16),
            lambda: symmpen.dec_jvp_bwd_plain(f, mp, b, BF16))


def _assert_rows_close_bf16(got, want, share=0.005):
    """Every row within 1e-2 of the output's scale but for `share` of the
    rows. Each side takes its own forward's masks: another f32 summation
    order can round an activation to the neighbouring bf16 value, and that
    step (2^-8 of it) can flip a later mask where a pre-activation lies
    near 0, which moves the whole row of a tangent or a VJP (on the CPU,
    permuting the summation order of the 500-row case below flips 1-2 of
    its 768,000 mask bits)."""
    scale = float(want.abs().max())
    assert bool(torch.isfinite(got).all()) and got.dtype == torch.float32
    bad = ((got - want).abs() > BF16_SCALE_REL * scale).any(dim=1)
    assert int(bad.sum()) <= share * got.shape[0], (int(bad.sum()), got.shape[0])


@pytest.mark.parametrize("rows", ["1", "tile+1", "80000"])
@pytest.mark.parametrize("width", sorted(WIDTH_LAYERS))
@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_symmpen_bf16_kernels_any_width(cuda_device, kind, width, rows):
    """The bf16 mode at the widths of test_symmpen_kernels_any_width (201:
    the padded bf16 copy of an odd width, whose f32 rows are not 16-byte
    aligned), against the bf16 plain versions: rows within 1e-2 of the
    output's scale (_assert_rows_close_bf16); the launch counted under the
    bf16 key."""
    tile = symmpen.row_tile(kind, width)
    n = {"1": 1, "tile+1": tile + 1, "80000": 80000}[rows]
    rng = np.random.default_rng(width + 7)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    a = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    kernel, plain = _symmpen_pair_bf16(kind, f, a, b)
    key = symmpen.launch_key(kind, BF16)
    before = dict(symmpen.launches)
    got = kernel()
    torch.cuda.synchronize()
    assert symmpen.launches[key] == before[key] + 1
    assert symmpen.launches[kind] == before[kind]
    _assert_rows_close_bf16(got, plain())


@pytest.mark.parametrize("width", sorted(WIDTH_LAYERS))
@pytest.mark.parametrize("chain", ["enc_fwd", "dec_jvp"])
def test_symmpen_bf16_kernel_masks_match_plain(cuda_device, chain, width, record_property):
    """The bf16 forward kernels' mask bits against the bf16 plain chain's:
    at most 0.1% differ (the count is reported); the masks are those of the
    bf16 chain, which differ from the f32 chain's in more places."""
    rng = np.random.default_rng(300 + width)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    x = torch.as_tensor(rng.standard_normal((20000, 2)), dtype=torch.float32, device=cuda_device)
    if chain == "enc_fwd":
        packed = symmpen.enc_fwd_kernel(f, x, BF16)[1]
    else:
        packed = symmpen.dec_jvp_fwd_kernel(f, x, torch.ones_like(x), BF16)[1]
    torch.cuda.synchronize()
    flips, unexplained = symmpen.mask_agreement(f, x, packed, rel=1e-2, dtype=BF16)
    f32_flips, _ = symmpen.mask_agreement(f, x, packed)
    n_bits = (len(f.Ws) - 1) * x.shape[0] * width
    record_property("bf16_mask_bits_differ", flips)
    print(f"bf16 {chain} width {width}: {flips} of {n_bits} mask bits differ from the bf16 "
          f"plain chain's ({unexplained} with |p| beyond 1e-2 of its terms), {f32_flips} "
          "from the f32 chain's")
    assert flips <= BF16_MASK_SHARE * n_bits, (flips, n_bits)
    assert f32_flips >= flips


@pytest.mark.parametrize("width", [201, 512])
@pytest.mark.parametrize("kind", ["enc_bwd", "dec_jvp_bwd"])
def test_symmpen_bf16_backward_kernel_reads_forward_kernel_masks(cuda_device, kind, width):
    """The bf16 backward kernel and the bf16 plain backward fed the same
    (kernel) masks: every row within 1e-2 of the output's scale."""
    rng = np.random.default_rng(400 + width)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    a = torch.as_tensor(rng.standard_normal((5000, 2)), dtype=torch.float32, device=cuda_device)
    c = torch.as_tensor(rng.standard_normal((5000, 2)), dtype=torch.float32, device=cuda_device)
    if kind == "enc_bwd":
        packed = symmpen.enc_fwd_kernel(f, a, BF16)[1]
        got = symmpen.enc_bwd_kernel(f, packed, c, BF16)
    else:
        packed = symmpen.dec_jvp_fwd_kernel(f, a, torch.ones_like(a), BF16)[1]
        got = symmpen.dec_jvp_bwd_kernel(f, packed, c, BF16)
    torch.cuda.synchronize()
    _assert_rows_close_bf16(got, symmpen._mask_bwd_plain(f, symmpen.unpack_masks(packed, width),
                                                         c, BF16), share=0.0)


TILE_LAYERS = {128: 4, 256: 3, 512: 5}  # a hidden width equal to each tile width


@pytest.mark.parametrize("ctas", ["3 tiles", "2 tiles + 1"])
@pytest.mark.parametrize("width", sorted(TILE_LAYERS))
@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_symmpen_bf16_kernels_odd_ctas(cuda_device, kind, width, ctas):
    """Row counts that leave an odd number of CTAs (3), so the last cluster
    of the bf16 backward's grid (CTA pairs on the tensor cores) has a CTA
    past the rows, at each tile width, the forwards on the same counts:
    every row within 1e-2 of the output's scale (_assert_rows_close_bf16)."""
    tile = symmpen.row_tile(kind, width)
    n = {"3 tiles": 3 * tile, "2 tiles + 1": 2 * tile + 1}[ctas]
    rng = np.random.default_rng(500 + width)
    f = _random_chain(rng, cuda_device, [2] + [width] * TILE_LAYERS[width] + [2])
    a = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    kernel, plain = _symmpen_pair_bf16(kind, f, a, b)
    got = kernel()
    torch.cuda.synchronize()
    _assert_rows_close_bf16(got, plain())


@pytest.mark.parametrize("width", [201, 512])
@pytest.mark.parametrize("kind", ["enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"])
def test_symmpen_bf16_nan_and_zero_rows(cuda_device, kind, width):
    """A chain with zero biases on rows where row 0 is NaN and row 1 is 0 (its
    pre-activations exactly 0 in every layer), the rest random: the bf16
    kernel's NaN positions are the bf16 plain version's (ReLU keeps NaN, a
    mask of NaN is 0, so the JVP's and the backwards' row 0 is finite), the
    finite rows agree within 1e-2 of the output's scale, and the forward's
    mask bits of both rows are 0 in every column, the padding past 201
    included."""
    rng = np.random.default_rng(600 + width)
    f = _random_chain(rng, cuda_device, [2] + [width] * WIDTH_LAYERS[width] + [2])
    f = symmpen.FoldedMLP.make(f.Ws, [torch.zeros_like(b) for b in f.bs])
    a = torch.as_tensor(rng.standard_normal((3000, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((3000, 2)), dtype=torch.float32, device=cuda_device)
    for t in (a, b):
        t[0] = float("nan")
        t[1] = 0.0
    kernel, plain = _symmpen_pair_bf16(kind, f, a, b)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isfinite(got[1:]).all())
    fin = torch.isfinite(want).all(dim=1)
    _assert_rows_close_bf16(got[fin], want[fin])
    if kind.startswith("enc"):
        packed = symmpen.enc_fwd_kernel(f, a, BF16)[1]
    else:
        packed = symmpen.dec_jvp_fwd_kernel(f, a, b, BF16)[1]
    torch.cuda.synchronize()
    bits = symmpen.unpack_masks(packed, symmpen.tile_width(width))
    assert not bool(bits[:, :2].any())
    assert not bool(bits[:, :, width:].any())


@pytest.mark.parametrize("rows", ["1", "tile+1", "80000"])
@pytest.mark.parametrize("kind", ["dec_jvp", "dec_jvp_bwd"])
def test_symmpen_bf16_jvp_width_256(cuda_device, kind, rows):
    """Mode 1 (the JVP) and its backward at hidden width 256, the 256-wide
    tile unpadded (the tensor-core backward's warps 2 x 4): rows within 1e-2
    of the output's scale, and at most 0.1% of the forward's mask bits
    differing from the bf16 plain chain's."""
    tile = symmpen.row_tile(kind, 256)
    n = {"1": 1, "tile+1": tile + 1, "80000": 80000}[rows]
    rng = np.random.default_rng(700)
    f = _random_chain(rng, cuda_device, [2] + [256] * 3 + [2])
    a = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device=cuda_device)
    kernel, plain = _symmpen_pair_bf16(kind, f, a, b)
    got = kernel()
    torch.cuda.synchronize()
    _assert_rows_close_bf16(got, plain())
    if kind == "dec_jvp":
        packed = symmpen.dec_jvp_fwd_kernel(f, a, b, BF16)[1]
        torch.cuda.synchronize()
        flips, _ = symmpen.mask_agreement(f, a, packed, rel=1e-2, dtype=BF16)
        assert flips <= BF16_MASK_SHARE * (len(f.Ws) - 1) * n * 256, flips


def test_symmpen_bf16_autograd_functions_on_card(cuda_device):
    """enc_apply and dec_jvp in bf16 on CUDA tensors launch the bf16 kernels
    forward and backward (one launch of each kind), and their values and
    input gradients for fixed random cotangents agree with the plain
    Functions' on the same inputs, row by row as _assert_rows_close_bf16
    holds them (this input's encoder chain flips a mask under another
    summation order); each Function is held on its own inputs and
    cotangent, so no rounding difference of one feeds the other."""
    rng = np.random.default_rng(13)
    f = _random_chain(rng, cuda_device, [2] + [512] * 3 + [2])
    t = lambda: torch.as_tensor(rng.standard_normal((500, 2)), dtype=torch.float32,
                                device=cuda_device)
    x, z, u = (a.requires_grad_(True) for a in (t(), t(), t()))
    cz, cv = t(), t()
    before = dict(symmpen.launches)
    outs = []
    for enc, jvp in ((symmpen.enc_apply, symmpen.dec_jvp),
                     (symmpen.enc_apply_plain, symmpen.dec_jvp_plain)):
        ze = enc(f, x, BF16)
        v = jvp(f, z, u, BF16)
        outs.append((ze, v) + torch.autograd.grad(ze, (x,), cz)
                    + torch.autograd.grad(v, (u,), cv))
    torch.cuda.synchronize()
    for kind in symmpen.MODES:
        assert symmpen.launches[kind + "_bf16"] == before[kind + "_bf16"] + 1
    for got, want in zip(outs[0], outs[1]):
        _assert_rows_close_bf16(got.detach(), want.detach())


def _assert_bf16_bit_equal(got, want):
    assert got.dtype == want.dtype == BF16
    both_nan = torch.isnan(got) & torch.isnan(want)
    same = (got.view(torch.int16) == want.view(torch.int16)) | both_nan
    assert bool(same.all()), int((~same).sum())


@pytest.mark.parametrize("N", [1, 300, 2500])
def test_tape_eval_bf16_kernel_matches_plain(cuda_device, N):
    """K5 in bf16 against the plain interpreter in bf16: bit for bit (NaN
    where it has NaN), with every opcode and a restricted op table."""
    ops, args, consts = _tapes(cuda_device)
    X = torch.as_tensor(np.random.default_rng(N).uniform(-2, 2, (3, N, 3)), dtype=BF16,
                        device=cuda_device)
    cb = consts.to(BF16)
    before = dict(tape_eval.launches)
    got = tape_eval.eval_tapes_kernel(ops, args, cb, X, 16)
    torch.cuda.synchronize()
    assert tape_eval.launches["tape_eval_bf16"] == before["tape_eval_bf16"] + 1
    assert tape_eval.launches["tape_eval"] == before["tape_eval"]
    _assert_bf16_bit_equal(got, tt.eval_tapes_plain(ops, args, cb, X, 16))
    assert bool(torch.isnan(got[:, 0]).all()) and not bool(got[:, 3].any())
    table = (tt.ADD, tt.MUL, tt.EXP)
    _assert_bf16_bit_equal(tape_eval.eval_tapes_kernel(ops, args, cb, X, 16, table),
                           tt.eval_tapes_plain(ops, args, cb, X, 16, table))


@pytest.mark.parametrize("rows", ["1", "33", "pass+1", "5000"])
@pytest.mark.parametrize("case", sorted(TAPE_EDGES))
def test_tape_eval_bf16_edge_cases(cuda_device, case, rows):
    """The decoder's edge cases in bf16: K5 bit for bit against the plain
    interpreter in bf16."""
    D, n_vars, L = TAPE_EDGES[case][:3]
    per_pass = tape_eval.geometry(5, L, D, n_vars, 1, BF16)[1]
    N = {"pass+1": per_pass + 1}.get(rows) or int(rows)
    ops, args, consts, D, n_vars, table = _edge_tapes(cuda_device, case, N)
    rng = np.random.default_rng(N + 1)
    X = torch.as_tensor(rng.uniform(-2, 2, (ops.shape[0], N, n_vars)), dtype=BF16,
                        device=cuda_device)
    X[:, 0] = 0.0
    cb = consts.to(BF16)
    got = tape_eval.eval_tapes_kernel(ops, args, cb, X, D, table)
    _assert_bf16_bit_equal(got, tt.eval_tapes_plain(ops, args, cb, X, D, table))
    if case == "all_pad":
        assert not bool(got.any())


def test_tape_kernels_dtypes(cuda_device):
    """K5 takes f32 or bf16 rows and constants, one dtype for both; K6
    takes f32 only (the constant gradient is f32, as in the reference)."""
    ops, args, consts = _tapes(cuda_device, U=1, P=8)
    X = torch.ones((1, 40, 3), dtype=torch.float32, device=cuda_device)
    gbar = torch.ones((1, 8, 40), dtype=torch.float32, device=cuda_device)
    before = dict(tape_eval.launches)
    with pytest.raises(ValueError, match="consts must be contiguous torch.float32"):
        tape_eval.eval_tapes_kernel(ops, args, consts.to(BF16), X)
    with pytest.raises(ValueError, match="consts must be contiguous torch.bfloat16"):
        tape_eval.eval_tapes_kernel(ops, args, consts, X.to(BF16))
    with pytest.raises(ValueError, match="float32"):
        tape_eval.eval_tapes_grad_kernel(ops, args, consts.to(BF16), X.to(BF16), gbar)
    assert tape_eval.launches == before
    assert tape_eval.geometry(5, 25, 16, 2, 2500, BF16)[0] >= tape_eval.geometry(
        5, 25, 16, 2, 2500)[0]


# ---- STLSQ and WSINDy on the card (no kernel of their own: cuSOLVER's QR
# and SVD) against the same functions on the CPU, on the same rows ----

def _solver_rows(task, n=5000, seed=0, noise=0.02):
    rng = np.random.default_rng(seed)
    lo, hi = (0.2, 1.5) if task == "growth" else (-1.0, 1.0)
    x = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    cfg, _ = make_config(2, poly_order=2)
    theta = cfg.library(torch.from_numpy(x)).numpy()
    dx = theta @ sindy_truth[task].T + noise * rng.standard_normal((n, 2))
    return x, dx.astype(np.float32)


def _solver_close(got, want, atol=1e-5):
    want = want.detach().cpu().numpy()
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=0,
                               atol=atol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", ["dosc_plain", "dosc_so2_free_const",
                                  "growth_scaling2_no_const"])
def test_solve_sindy_on_card_matches_cpu(cuda_device, case):
    """STLSQ on the card: the unconstrained solve and both constrained
    branches, the growth constraint's Q (ops/constraint.py) among them,
    which the STLSQ CLI never reaches. Masks equal, coefficients within
    1e-5 of their scale."""
    from symmetry_ode_discovery_tpu_torch.models import sindy

    task, kw = {"dosc_plain": ("dosc", {}),
                "dosc_so2_free_const": ("dosc", dict(L_list=[SO2])),
                "growth_scaling2_no_const": ("growth", dict(L_list=[SCALING2],
                                                            constrain_constant=True))}[case]
    cfg, Q = make_config(2, poly_order=2, threshold=5e-2, **kw)
    x, y = _solver_rows(task)
    out = {}
    for dev in ("cpu", cuda_device):
        st = sindy.init_sindy(torch.Generator().manual_seed(0), cfg, Q, dev)
        st, resid = sindy.solve_sindy(cfg, st, torch.from_numpy(x).to(dev),
                                      torch.from_numpy(y).to(dev), 0.0, 5e-2, max_iter=6)
        out[str(dev)] = (sindy.get_Xi(cfg, st), st.mask, resid)
    (xi_c, m_c, r_c), (xi_g, m_g, r_g) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(m_g.cpu(), m_c)
    _solver_close(xi_g, xi_c)
    _solver_close(r_g, r_c, 1e-4)
    assert (m_c.numpy()[sindy_truth[task] != 0] > 0).all()


def test_min_norm_lstsq_on_card_matches_cpu(cuda_device):
    """A batch of tall systems with zeroed columns (the masked solve's
    shape) through cuSOLVER's QR and SVD and through LAPACK's."""
    from symmetry_ode_discovery_tpu_torch.ops import linalg

    rng = np.random.default_rng(1)
    A = rng.standard_normal((6, 2, 20000, 8)).astype(np.float32)
    A[:, 1, :, 3:5] = 0.0
    b = rng.standard_normal((6, 2, 20000)).astype(np.float32)
    want = linalg.min_norm_lstsq(torch.from_numpy(A), torch.from_numpy(b))
    got = linalg.min_norm_lstsq(torch.from_numpy(A).to(cuda_device),
                                torch.from_numpy(b).to(cuda_device))
    _solver_close(got, want)


@pytest.mark.parametrize("task", ["lv", "dosc"])
def test_sweep_wsindy_on_card_matches_cpu(cuda_device, task):
    """The WSINDy sweep's batched weak-form solves on the card against the
    CPU on the same trajectories and ref windows: masks equal, coefficients
    within 1e-3 (the repository's sweep bar)."""
    from symmetry_ode_discovery_tpu_torch.data.datasets import ode_dt_dict
    from symmetry_ode_discovery_tpu_torch.training.sweep import sweep_wsindy

    sys_ = SYSTEMS[task]
    gen = torch.Generator().manual_seed(3)
    steps = {"lv": 5000, "dosc": 200}[task]
    x, _ = solve_ode_batch(sys_.f, sys_.sample_ics(gen, 8), dt=ode_dt_dict[task],
                           num_steps=steps)
    x = x.transpose(0, 1)
    x = (x + 0.01 * torch.randn(x.shape, generator=gen)).float()
    cfg, _ = make_config(2, poly_order=2, include_exp=task == "lv",
                         threshold=0.15 if task == "lv" else 5e-2)
    runs = [sweep_wsindy(cfg, x, ode_dt_dict[task], sindy_truth[task], range(20),
                         threshold=cfg.threshold, subsample_rng="ref", device=dev)
            for dev in ("cpu", cuda_device)]
    np.testing.assert_array_equal(runs[1].mask, runs[0].mask)
    np.testing.assert_allclose(runs[1].Xi, runs[0].Xi, rtol=0, atol=1e-3)
