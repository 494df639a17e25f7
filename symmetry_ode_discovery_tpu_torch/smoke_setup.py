"""The set-up and measurements that the smoke run (chip_smoke.py at the
repository's root) and cli/kernel_ab.py share: the main paths' data and
configurations at full size, the kernels' inputs at the shapes those paths
give them, the timing helpers and bounds, and the phases that drive a path
or hold a kernel against its plain version and return (or pass to
``emit_fn``) one record each. The gates on those records are the smoke
run's. Everything here runs on a CUDA device, and reads the LaLiGAN
checkpoints under the repository's saved_models/.
"""

import contextlib
import os
import tempfile
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores, data sheet (SXM)
H100_BF16_FLOPS = 989e12       # bf16 on the tensor cores, dense, data sheet (SXM)
LV_LEVELS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.99]
SEEDS = list(range(50))
CKPT_ROOT = Path(__file__).resolve().parents[1] / "saved_models"  # the checkpoints the paths read
SYMREG_SEEDS = 4         # one chunk of the EquivSINDy-r sweep
SYMREG_ROWS = 20000      # per seed: subsample 0.01 of the 2,000,000 LV rows
K23_ROW_REL = 1e-5       # K2/K3: rows beyond this share of the output scale are counted
GP_SEEDS = {"plain": 10, "equivgp_r": 4}   # one chunk of each GP leg
TAPE_SEEDS = 10          # the tape phase's generation: seeds of each leg
GP_TOPK = 256
K1_REDUCTIONS_PER_EVAL = 2  # csrc/lbfgs_sweep.cu: the 8-value reduction and g.d


def event_ms(fn, repeats):
    """Median milliseconds of fn() over `repeats` runs, timed with CUDA events."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, launches=20):
    """Device milliseconds per launch of fn(), from CUDA events around
    ``launches`` back-to-back launches that the host queued behind a sleep
    on the stream, so the host's launch overhead is not in the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e6))  # ~3 ms: the host enqueues the launches meanwhile
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def not_bit_equal(got, want):
    """Elements of ``got`` whose bits differ from ``want``'s (any NaN matches
    any NaN); float32 or bfloat16."""
    import torch

    itype = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int((~((got.view(itype) == want.view(itype)) | both_nan)).sum())


def gap_s(launches, ms, bound_ms):
    """Seconds that ``launches`` launches of ``ms`` each spend beyond their bound."""
    return launches * (ms - bound_ms) / 1e3


def k1_slowest_lane_reductions(work):
    """The dependent reductions of K1's slowest lane, from the kernel's work
    counts: two per loss/gradient evaluation (the batched loss and
    break-test sums, then g.d) and two per two-loop pair."""
    return int((work[:, 0] * K1_REDUCTIONS_PER_EVAL + 2 * work[:, 1]).max())


def make_data(dev):
    """Path 1's data on the card: the LV train split at the 11 noise levels
    (200 ICs x 10000 RK4 steps each) and the growth train split at noise
    0.05, flattened to rows; a wrong shape or a non-finite value raises."""
    import torch

    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed

    lv = SYSTEMS["lv"]
    xs, dxs = [], []
    for nl in LV_LEVELS:
        gen = torch.Generator(device=dev).manual_seed(cache_seed("train", nl))
        x, dx = gen_data(lv, gen, noise=nl, multiplicative_noise=lv.multiplicative_noise,
                         smoothing="gp", device=dev)
        if tuple(x.shape) != (200, 10000, 2) or not bool(torch.isfinite(x).all()
                                                        and torch.isfinite(dx).all()):
            raise RuntimeError(f"LV level {nl}: bad data {tuple(x.shape)}")
        xs.append(x.reshape(-1, 2))
        dxs.append(dx.reshape(-1, 2))
    growth = SYSTEMS["growth"]
    gen = torch.Generator(device=dev).manual_seed(cache_seed("train", 0.05))
    xg, dxg = gen_data(growth, gen, noise=0.05, multiplicative_noise=True,
                       smoothing="gp", device=dev)
    if tuple(xg.shape) != (100, 100, 2) or not bool(torch.isfinite(xg).all()
                                                   and torch.isfinite(dxg).all()):
        raise RuntimeError(f"growth: bad data {tuple(xg.shape)}")
    torch.cuda.synchronize()
    return xs, dxs, xg.reshape(-1, 2), dxg.reshape(-1, 2)


def path1_configs():
    """(cfg_lv, hp_lv, cfg_g, Q_g, hp_g): the protocols of bench.py legs 1-2."""
    import numpy as np

    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams

    cfg_lv, _ = make_config(2, poly_order=2, include_exp=True, threshold=0.15)
    hp_lv = LBFGSHParams(num_epochs=100, lr_sindy=0.1, w_sindy_x=1.0, w_sindy_reg=0.0,
                         sindy_reg_type="l1", st_freq=20, threshold=0.15)
    L_scaling2 = np.array([[2.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    cfg_g, Q_g = make_config(2, poly_order=2, L_list=[L_scaling2],
                             constrain_constant=True, threshold=5e-2)
    hp_g = LBFGSHParams(num_epochs=100, lr_sindy=1.0, w_sindy_x=1.0, w_sindy_reg=0.0,
                        sindy_reg_type="l1", st_freq=100, threshold=5e-2)
    return cfg_lv, hp_lv, cfg_g, Q_g, hp_g


def path1(dev, xs, dxs, xg, dxg):
    """Path 1: the stacked plain-SINDy sweep of the 11 LV levels x 50 seeds
    and the growth EquivSINDy-c sweep x 50 seeds, a warm pass then a timed
    pass each. Returns (walls, LV results by level, growth result)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.training.sweep import (
        sweep_sindy_lbfgs, sweep_sindy_lbfgs_stacked)

    cfg_lv, hp_lv, cfg_g, Q_g, hp_g = path1_configs()
    walls = {}

    def timed(label, fn):
        fn()  # warm pass
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
        return res

    res_lv = timed("lv_allnoise_sindy_s", lambda: sweep_sindy_lbfgs_stacked(
        cfg_lv, None, xs, dxs, sindy_truth["lv"], hp_lv, SEEDS,
        lbfgs_subsample=0.01, device=dev))
    res_g = timed("growth_esindy_s", lambda: sweep_sindy_lbfgs(
        cfg_g, Q_g, xg, dxg, sindy_truth["growth"], hp_g, SEEDS,
        lbfgs_subsample=0.5, device=dev))
    return walls, res_lv, res_g


def path1_outcomes(res_lv, res_g):
    """(LV joint successes by noise level, growth joint success per seed,
    growth RMSE over the joint successes)."""
    import numpy as np

    def joint(res):
        return np.all(res.correct_form > 0, axis=1)

    by_noise = {f"{nl:.2f}": int(joint(r).sum()) for nl, r in zip(LV_LEVELS, res_lv)}
    ok_g = joint(res_g)
    rmse_g = float(np.mean(np.sqrt(res_g.mse[ok_g]))) if ok_g.any() else float("nan")
    return by_noise, ok_g, rmse_g


def k1_cases(dev, xs, dxs, xg, dxg):
    """K1's inputs at path 1's two launches, built by the sweep's own
    stacked_lanes (a warm pass first): {name: (kernel config, (S, B, q,
    n_elems, theta0), Mmap, lanes, warm prep ms)}, growth (50 lanes) then LV
    (550 lanes, 11 levels x 50 seeds)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.training.sweep import stacked_lanes

    cfg_lv, hp_lv, cfg_g, Q_g, hp_g = path1_configs()
    out = {}
    for name, cfg, Q, hp, x_list, dx_list, sub in [
            ("growth_esindy", cfg_g, Q_g, hp_g, [xg], [dxg], 0.5),
            ("lv_sindy_allnoise", cfg_lv, None, hp_lv, xs, dxs, 0.01)]:
        stacked_lanes(cfg, Q, x_list, dx_list, hp, SEEDS, sub, dev)  # warm pass
        torch.cuda.synchronize()
        t_prep = time.perf_counter()
        pcfg, lanes, Mmap = stacked_lanes(cfg, Q, x_list, dx_list, hp, SEEDS, sub, dev)
        torch.cuda.synchronize()
        t_prep = (time.perf_counter() - t_prep) * 1e3  # subsample + normal equations
        out[name] = (pcfg, lanes, Mmap, len(x_list) * len(SEEDS), t_prep)
    return out


def symreg_args(extra):
    """The flags of bench.py's EquivSINDy-r leg, K4 on, as the CLI parses them."""
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    return vars(get_args(["--config", "lv/noise99_eq_isymreg.cfg", "--symmpen_pallas",
                          "--ae_dtype", "f32", "--lbfgs_dir_backend", "pallas",
                          "--seed", "0"] + list(extra)))


def reset_launches():
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir, lbfgs_sweep, symmpen, tape_eval

    lbfgs_sweep.launches = 0
    lbfgs_dir.launches = 0
    for counts in (symmpen.launches, tape_eval.launches):
        for k in counts:
            counts[k] = 0


def chain_flops(f, hidden_only=False):
    """Multiply-adds x 2 of one pass of the folded chain per row (without
    its last layer when hidden_only)."""
    Ws = f.Ws[:-1] if hidden_only else f.Ws
    return 2 * sum(int(w.shape[0]) * int(w.shape[1]) for w in Ws)


def bound(bytes_moved, flops, peak_flops=H100_F32_FLOPS):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(bytes_moved), "flops": int(flops)}


def flagship_models(dev):
    """(flags, frozen AutoEncoder, GeneratorSpec, GeneratorState) of the
    flagship configuration, from the checkpoint under saved_models/ (a
    missing file raises)."""
    from symmetry_ode_discovery_tpu_torch.cli.main import build_models
    from symmetry_ode_discovery_tpu_torch.convert import laligan_from_npz

    args = symreg_args([])
    args["input_dim"] = 2
    sd, g_state = laligan_from_npz(str(CKPT_ROOT / args["load_laligan"]), dev)
    ae, spec = build_models(args)
    ae.load_state_dict(sd)
    return args, ae.to(dev).eval().requires_grad_(False), spec, g_state


def l2_weight_bytes(f, kind, rows, dtype):
    """Bytes of hidden x hidden weights one launch of ``kind`` (a key of
    symmpen.MODES) over ``rows`` rows reads out of L2: every CTA streams each
    hidden product's weights once, f32 at the hidden width; bf16 at the tile
    width, and in the backward kinds (mode 2, on the tensor cores) with the
    grid rounded up to whole clusters, whose CTAs share each weight byte by
    multicast (csrc/symmpen.cu)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp

    ctas = -(-rows // sp.row_tile(kind, f.hidden))
    hidden = f.n_relu - 1
    if dtype == torch.float32:
        return ctas * hidden * f.hidden * f.hidden * 4
    W = sp.tile_width(f.hidden)
    if sp.MODES[kind] == 2:
        ctas = -(-ctas // sp.KERNEL.lib().symmpen_cluster())
    return ctas * hidden * W * W * 2


def cublas_chain(f, kind, a, b, masks, dtype=None):
    """One K2/K3 function of the chain ``f`` (``kind`` a key of
    symmpen.MODES) through cuBLAS, as a closure: a torch.matmul a layer in
    ``dtype`` (bfloat16 with f32 output, or float32 without TF32, the
    package's pin), the bias, ReLU, mask compare (forwards) or mask select
    (backwards, ``masks`` the plain chain's bools) in f32, on inputs a (and
    b: the JVP's tangent, a backward's cotangent). A yardstick of device
    time for library_ms; the port never calls it."""
    import torch

    dtype = dtype or torch.float32
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the f32 cuBLAS chain must run without TF32")
    Ws = [w.to(dtype) for w in f.Ws]
    WTs = [w.T.contiguous() for w in Ws]
    mm = lambda h, w: torch.matmul(h.to(dtype), w).float()
    if kind in ("enc_bwd", "dec_jvp_bwd"):
        def fn():
            g = mm(b, WTs[-1])
            for k in range(f.n_relu - 1, -1, -1):
                g = mm(torch.where(masks[k], g, 0.0), WTs[k])
            return g
    elif kind == "enc_fwd":
        def fn():
            h, ms = a, []
            for k in range(len(Ws)):
                p = mm(h, Ws[k]) + f.bs[k]
                if k < f.n_relu:
                    ms.append(p > 0.0)
                    h = torch.relu(p)
            return p, ms
    else:
        def fn():
            h, t = a, b
            for k in range(len(Ws)):
                p, tq = mm(h, Ws[k]) + f.bs[k], mm(t, Ws[k])
                if k < f.n_relu:
                    m = p > 0.0
                    h, t = torch.relu(p), torch.where(m, tq, 0.0)
            return tq
    return fn


def k23_phase(fe, fd, x, z, u, cz, emit_fn, tags, dtype=None, l2_rate=None, outputs=None):
    """The four K2/K3 functions against their plain versions on one closure's
    inputs (x for the encoder, z and u for the decoder JVP, cz a cotangent),
    in ``dtype`` (float32 when None; bfloat16: the bf16 modes, records named
    <function>_bf16 in phase symmpen_bf16): each backward reads the masks of
    its own side's forward. Gates (in main): f32, max |diff| and rows beyond
    1e-5 of the output scale, and a forward's mask bit may differ from the
    plain chain's only within f32 rounding of 0; bf16, max |diff| within
    1e-2 of the output scale and at most 0.1% of the mask bits differing.
    Bounds count this design's work (the backward runs no primal chain; the
    masks are written and read once; bf16 weights are 2 bytes, their
    operations at the bf16 tensor-core peak) and, as bound_old_ms, the
    recomputing design's. Each record also has the hidden weight bytes the
    launch reads out of L2 (l2_weight_bytes) and, given ``l2_rate``
    (bytes/s), their time at that rate; library_ms is the device time of
    cublas_chain in the same dtype. Times by CUDA events; then the per-closure
    sum. ``outputs``, when a dict, receives each function's output and each
    forward's packed masks by record name."""
    import torch

    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    suffix, phase = ("_bf16", "symmpen_bf16") if bf16 else ("", "symmpen")
    peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
    rows = x.shape[0]
    mk_e = sp.enc_fwd_kernel(fe, x, dtype)[1]
    mk_d = sp.dec_jvp_fwd_kernel(fd, z, u, dtype)[1]
    torch.cuda.synchronize()
    mp_e, mp_d = sp.enc_fwd_plain(fe, x, dtype)[1], sp.dec_jvp_fwd_plain(fd, z, u, dtype)[1]
    rel = 1e-2 if bf16 else 1e-4
    agree = {"enc": sp.mask_agreement(fe, x, mk_e, rel, dtype),
             "dec": sp.mask_agreement(fd, z, mk_d, rel, dtype)}
    wbytes = 2 if bf16 else 4
    weights = lambda f: wbytes * sum(w.numel() for w in f.Ws) + 4 * sum(b.numel() for b in f.bs)
    masks = lambda f: f.n_relu * rows * f.hidden // 8
    io = lambda *widths: 4 * rows * sum(widths)
    fwd_e, fwd_d = rows * chain_flops(fe), rows * chain_flops(fd)
    hid_e, hid_d = rows * chain_flops(fe, True), rows * chain_flops(fd, True)
    cases = [  # name, kernel, plain, (bytes, flops), old (bytes, flops), mask chain
        ("symmpen_enc_fwd", "K2", lambda: sp.enc_fwd_kernel(fe, x, dtype)[0],
         lambda: sp.enc_fwd_plain(fe, x, dtype)[0],
         (weights(fe) + io(fe.d_in, fe.d_out) + masks(fe), fwd_e),
         (weights(fe) + io(fe.d_in, fe.d_out), fwd_e), "enc"),
        ("symmpen_enc_bwd", "K2", lambda: sp.enc_bwd_kernel(fe, mk_e, cz, dtype),
         lambda: sp.enc_bwd_plain(fe, mp_e, cz, dtype),
         (weights(fe) + io(fe.d_out, fe.d_in) + masks(fe), fwd_e),
         (weights(fe) + io(fe.d_in, fe.d_out, fe.d_in), hid_e + fwd_e), None),
        ("symmpen_dec_jvp", "K3", lambda: sp.dec_jvp_fwd_kernel(fd, z, u, dtype)[0],
         lambda: sp.dec_jvp_fwd_plain(fd, z, u, dtype)[0],
         (weights(fd) + io(fd.d_in, fd.d_in, fd.d_out) + masks(fd), hid_d + fwd_d),
         (weights(fd) + io(fd.d_in, fd.d_in, fd.d_out), hid_d + fwd_d), "dec"),
        ("symmpen_dec_jvp_bwd", "K3", lambda: sp.dec_jvp_bwd_kernel(fd, mk_d, cz, dtype),
         lambda: sp.dec_jvp_bwd_plain(fd, mp_d, cz, dtype),
         (weights(fd) + io(fd.d_out, fd.d_in) + masks(fd), fwd_d),
         (weights(fd) + io(fd.d_in, fd.d_out, fd.d_in), hid_d + fwd_d), None),
    ]
    out = {}
    library = {"enc_fwd": (fe, x, None, None), "enc_bwd": (fe, None, cz, mp_e),
               "dec_jvp": (fd, z, u, None), "dec_jvp_bwd": (fd, None, cz, mp_d)}
    for name, tag, kernel, plain, work, old, chain in cases:
        kind = name.removeprefix("symmpen_")
        name = name + suffix
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        scale = float(want.abs().max())
        diff = (got - want).abs()
        f = library[kind][0]
        rec = {"phase": phase, "name": name, "kernel": tag, **tags, "rows": rows,
               "max_abs_err": float(diff.max()), "scale": scale,
               "rows_beyond_1e-5": int((diff > K23_ROW_REL * scale).any(dim=1).sum()),
               "finite": bool(torch.isfinite(got).all()),
               "ms": event_ms(kernel, 5), "device_ms": device_ms(kernel),
               "plain_ms": event_ms(plain, 3),
               "library_ms": device_ms(cublas_chain(f, kind, *library[kind][1:], dtype)),
               "l2_weight_bytes": l2_weight_bytes(f, kind, rows, dtype)}
        if l2_rate:
            rec["l2_weight_ms"] = rec["l2_weight_bytes"] / l2_rate * 1e3
        rec.update(bound(*work, peak))
        rec["bound_old_ms"] = bound(*old, peak)["bound_ms"]
        if outputs is not None:
            outputs[name] = got
            if chain:
                outputs[name + " masks"] = mk_e if chain == "enc" else mk_d
        if chain:
            flips, unexplained = agree[chain]
            rec.update(mask_bits=masks(fe if chain == "enc" else fd) * 8, mask_bits_differ=flips,
                       mask_bits_differ_not_near_0=unexplained, mask_rel=rel)
        emit_fn(rec)
        out[name] = rec
    total = {k: sum(r[k] for r in out.values())
             for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_old_ms")}
    emit_fn({"phase": phase, "name": "closure_k2_k3" + suffix, **tags, "rows": rows, **total})
    return out


def symmpen_phase(dev, x, emit_fn, l2_rate=None, outputs=None):
    """K2, K3 and K4 against their plain versions on the inputs of one
    EquivSINDy-r closure: 4 seeds x 20,000 rows of the LV noise-0.99 data,
    the rollout endpoint fx of the true LV equation, the frozen checkpoint;
    then K2 and K3 in bf16 on the same inputs (k23_phase's l2_rate and
    outputs). Returns (the f32 records with K4's, the bf16 records)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir as k4
    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp
    from symmetry_ode_discovery_tpu_torch.ops.integrators import odeint
    from symmetry_ode_discovery_tpu_torch.training.sweep import _subsample_idx

    args, ae, spec, g_state = flagship_models(dev)
    fe = sp.fold_encoder(ae, ae.encoder_final_bias())
    fd = sp.fold_decoder(ae)
    idx = _subsample_idx(range(SYMREG_SEEDS), x.shape[0], SYMREG_ROWS, dev).reshape(-1)
    xr = x[idx].contiguous()
    rows = xr.shape[0]
    cfg, _ = make_config(2, poly_order=2, include_exp=True)
    A = torch.as_tensor(sindy_truth["lv"].T, dtype=torch.float32, device=dev)
    with torch.no_grad():
        fx = odeint(lambda q: cfg.library(q) @ A, xr, args["int_t"], args["int_dt"]).contiguous()
        v = lg.get_full_basis_list(spec, g_state)[0]
        z = sp.enc_fwd_plain(fe, fx)[0]
        u = (z @ v[2:, 2:].T).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    cz = torch.randn((rows, 2), generator=gen, device=dev)
    out = k23_phase(fe, fd, fx, z, u, cz, emit_fn, {}, None, l2_rate, outputs)
    out["lbfgs_dir"] = k4_phase(dev, gen, emit_fn)
    return out, k23_phase(fe, fd, fx, z, u, cz, emit_fn, {}, torch.bfloat16, l2_rate, outputs)


def k4_inputs(dev, gen):
    """K4's inputs at the flagship's shape: 4 lanes, 100 pairs, 16
    parameters, a curvature-consistent memory drawn from ``gen``."""
    import torch

    lanes, m, n = SYMREG_SEEDS, 100, 16
    s = torch.randn((lanes, m, n), generator=gen, device=dev)
    y = 0.8 * s + 0.1 * torch.randn((lanes, m, n), generator=gen, device=dev)
    rho = 1.0 / (s * y).sum(-1)
    g = torch.randn((lanes, n), generator=gen, device=dev)
    gam = torch.rand((lanes,), generator=gen, device=dev) + 0.5
    return g, s, y, rho, gam


def k4_phase(dev, gen, emit_fn):
    """K4 against its plain version at the flagship's shape: max |diff|,
    elements not bit-equal, times, bound and the chain figure (device ns per
    dependent dot product, 2 m of them)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir as k4

    g, s, y, rho, gam = k4_inputs(dev, gen)
    lanes, m, n = s.shape
    kernel = lambda: k4.two_loop_direction(g, s, y, rho, gam)
    plain = lambda: k4.two_loop_direction_plain(g, s, y, rho, gam)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    rec = {"phase": "symmpen", "name": "lbfgs_dir", "kernel": "K4", "lanes": lanes,
           "memory": m, "n": n, "max_abs_err": float((got - want).abs().max()),
           "scale": float(want.abs().max()), "not_bit_equal": not_bit_equal(got, want),
           "ms": event_ms(kernel, 21), "device_ms": device_ms(kernel),
           "plain_ms": event_ms(plain, 3), "library_ms": None}
    rec["host_ms"] = rec["ms"] - rec["device_ms"]
    # the wrapper's own host time: 200 launches enqueued without a wait (the
    # launch queue holds them all), over the count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernel()
    rec["enqueue_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    rec["chain_ns_per_reduction"] = rec["device_ms"] * 1e6 / (2 * m)
    rec.update(bound(4 * (lanes * (2 * n + 2 * m * n + m + 1)), lanes * (8 * m * n + n)))
    emit_fn(rec)
    return rec


def symmpen_width_phase(dev, emit_fn, l2_rate=None, outputs=None):
    """K2 and K3 at hidden width 128 (4 layers): the selkov checkpoint of
    selkov/noise20_eq_symreg.cfg, on 80,000 rows drawn in selkov's initial
    condition box, against their plain versions; the same gate as the LV
    case; then in bf16 (k23_phase's l2_rate and outputs). Returns (f32
    records, bf16 records)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import build_models
    from symmetry_ode_discovery_tpu_torch.convert import laligan_from_npz
    from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS
    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    args = vars(get_args(["--config", "selkov/noise20_eq_symreg.cfg", "--symmpen_pallas"]))
    args["input_dim"] = 2
    sd, g_state = laligan_from_npz(str(CKPT_ROOT / args["load_laligan"]), dev)
    ae, spec = build_models(args)
    ae.load_state_dict(sd)
    ae = ae.to(dev).eval().requires_grad_(False)
    fe = sp.fold_encoder(ae, ae.encoder_final_bias())
    fd = sp.fold_decoder(ae)
    rows = 80000
    gen = torch.Generator(device=dev).manual_seed(1)
    x = SYSTEMS["selkov"].sample_ics(gen, rows).contiguous()
    with torch.no_grad():
        v = lg.get_full_basis_list(spec, g_state)[0]
        z = sp.enc_fwd_plain(fe, x)[0]
        u = (z @ v[2:, 2:].T).contiguous()
    cz = torch.randn((rows, 2), generator=gen, device=dev)
    tags = {"checkpoint": args["load_laligan"], "hidden": fe.hidden,
            "hidden_layers": len(fe.Ws) - 1}
    return (k23_phase(fe, fd, x, z, u, cz, emit_fn, tags, None, l2_rate, outputs),
            k23_phase(fe, fd, x, z, u, cz, emit_fn, tags, torch.bfloat16, l2_rate, outputs))


def gp_args(leg, extra=()):
    """The flags of one GP leg as the CLI parses them (both backends on K5/K6)."""
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    config = {"plain": "lv/noise99_eq_gp.cfg", "equivgp_r": "lv/noise99_eq_gp_symm.cfg"}[leg]
    return vars(get_args(["--config", config, "--gp_eval_backend", "pallas",
                          "--gp_grad_backend", "pallas", "--seed", "0"] + list(extra)))


def gp_generation_inputs(dev, x, dx, leg, n_seeds=TAPE_SEEDS):
    """The SweepInputs of one GP leg's first chunk of ``n_seeds`` seeds, made
    by the functions cli/main_gp.py's sweep runs through: its rows
    (main_gp.chunk_rows, g(x) and J_g(x) from the LV checkpoint for
    EquivGP-r), populations, rngs and unit loss (symgp/sweep.py)."""
    from symmetry_ode_discovery_tpu_torch.cli import main_gp
    from symmetry_ode_discovery_tpu_torch.symgp import sweep as sw

    args = gp_args(leg)
    args["input_dim"] = 2
    seeds = list(range(n_seeds))
    spec = main_gp._task_spec("lv", 2)
    cfg = main_gp.gp_config(args, 0)
    gx_fn = main_gp.make_gx_fn(args, dev, str(CKPT_ROOT)) if args["pysr_symmreg"] else None
    X, dX, gx, Jg = main_gp.chunk_rows(args, x, dx, seeds, gx_fn, dev)
    if leg == "plain":
        return sw.plain_inputs(X, dX, spec, cfg, seeds, device=dev)
    return sw.system_inputs(X, dX, spec, cfg, seeds, gx, Jg, args["w_sym_reg"], device=dev)


def tape_bound(ops, n_rows, n_vars, out_per_tape, ops_per_step, extra_in_bytes=0, elem=4):
    """Least time for one launch: tapes (two 4-byte words and a constant of
    ``elem`` bytes a slot), rows (``elem`` bytes a value) and any extra
    input read once, the output (``elem`` bytes a value) written once, over
    the memory rate; or ops_per_step f32 operations per live (non-PAD) step
    and row, over the f32 rate; the larger of the two."""
    U, P, L = ops.shape
    live = int((ops != 0).sum())
    nbytes = ((8 + elem) * U * P * L + elem * U * n_rows * n_vars + extra_in_bytes
              + elem * U * P * out_per_tape)
    rec = bound(nbytes, ops_per_step * live * n_rows)
    rec["live_steps_per_tape"] = live / (U * P)
    return rec


def tape_inputs(dev, x, dx, leg):
    """The K5 and K6 inputs of one generation of a GP leg at full size
    (TAPE_SEEDS seeds): the population on its rows, the top-256 groups' tapes
    (by K5's fitness) on the first 512 rows, and the cotangent of the leg's
    loss in their predictions (K6's gbar); also K5's predictions on the
    population and on the top-256 groups' first rows, and the top-256
    groups."""
    import types

    import torch

    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te

    inp = gp_generation_inputs(dev, x, dx, leg)
    unit, group = inp.unit_loss, inp.group
    ops, args, consts = (torch.as_tensor(a, device=dev) for a in inp.populations)
    pts = unit.points(*inp.data).contiguous()
    spts = unit.points(*inp.data_small).contiguous()
    depth, table = unit.stack_depth, unit.op_table
    L = ops.shape[2]
    pred = te.eval_tapes_kernel(ops, args, consts, pts, depth, table)
    idx = torch.sort(unit.of_preds(pred, *inp.data), dim=1, stable=True).indices[:, :GP_TOPK]
    rows = (idx[..., None] * group + torch.arange(group, device=dev)).reshape(idx.shape[0], -1)
    take = lambda a: torch.gather(a, 1, rows[..., None].expand(-1, -1, L)).contiguous()
    sops, sargs, sconsts = take(ops), take(args), take(consts)
    spred = te.eval_tapes_kernel(sops, sargs, sconsts, spts, depth, table).requires_grad_(True)
    with torch.enable_grad():
        (gbar,) = torch.autograd.grad(unit.of_preds(spred, *inp.data_small).sum(), spred)
    gbar = torch.where(torch.isfinite(gbar), gbar, 0.0).contiguous()
    return types.SimpleNamespace(inp=inp, unit=unit, ops=ops, args=args, consts=consts, pts=pts,
                                 depth=depth, table=table, pred=pred, idx=idx, sops=sops,
                                 sargs=sargs, sconsts=sconsts, spts=spts, gbar=gbar,
                                 spred=spred.detach())


def tape_shapes(ti, leg):
    """Every launch shape symgp/sweep.py::make_sweep_gen_step makes in a
    generation of ``leg`` (K5 on the population, on the top-256 groups' first
    rows in each Adam step, on the top-256 groups' rows; K6 in each Adam
    step), on the first units of ``ti`` (tape_inputs) that gp_phase runs: a
    list of (record of the shape, its bound and its launches per chunk, the
    launch)."""
    from functools import partial

    from symmetry_ode_discovery_tpu_torch.cli import main_gp
    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te

    cfg = main_gp.gp_config(gp_args(leg), 0)
    gens, steps = cfg.n_generations, cfg.const_opt_steps
    U, _, L = ti.ops.shape
    R = ti.spts.shape[1]
    u_gp = U * GP_SEEDS[leg] // TAPE_SEEDS
    out = []
    for name, shape, tensors, per_gen in (
            ("K5", "population, all rows", (ti.ops, ti.args, ti.consts, ti.pts), 1),
            ("K5", f"top-{GP_TOPK} groups, first {R} rows",
             (ti.sops, ti.sargs, ti.sconsts, ti.spts), steps),
            ("K5", f"top-{GP_TOPK} groups, all rows", (ti.sops, ti.sargs, ti.sconsts, ti.pts), 1),
            ("K6", f"top-{GP_TOPK} groups, first {R} rows",
             (ti.sops, ti.sargs, ti.sconsts, ti.spts, ti.gbar), steps)):
        o, a, c, xs, *g = (v[:u_gp].contiguous() for v in tensors)
        if g:
            fn = partial(te.eval_tapes_grad_kernel, o, a, c, xs, g[0], ti.depth, ti.table)
            rec = tape_bound(o, xs.shape[1], xs.shape[2], L, 2, extra_in_bytes=4 * g[0].numel())
        else:
            fn = partial(te.eval_tapes_kernel, o, a, c, xs, ti.depth, ti.table)
            rec = tape_bound(o, xs.shape[1], xs.shape[2], xs.shape[1], 1)
        rec.update(kernel=name, shape=shape, units=u_gp, tapes_per_unit=o.shape[1],
                   rows=xs.shape[1], launches_per_chunk=gens * per_gen)
        out.append((rec, fn))
    return out


def gp_phase(dev, x, dx, emit_fn, eval_dtype="f32"):
    """Path 3: one chunk of each GP leg through cli/main_gp.py::run with
    --gp_eval_dtype ``eval_dtype`` (phase gp, or gp_bf16), every launch
    count set to 0 just before each leg and read just after."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli import main_gp
    from symmetry_ode_discovery_tpu_torch.ops import tape_eval

    out = {}
    for leg, n_seeds in GP_SEEDS.items():
        with tempfile.TemporaryDirectory() as tmp:
            args = gp_args(leg, ["--n_seeds", str(n_seeds), "--seed_chunk", str(n_seeds),
                                 "--eval_root", tmp, "--gp_eval_dtype", eval_dtype])
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = main_gp.run(args, train_data=(x, dx), device=dev, ckpt_root=str(CKPT_ROOT))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(tape_eval.launches)
        (chunk,) = res["chunks"]
        cf = np.array([res["correct_form"][s] for s in range(n_seeds)])
        rec = {"phase": "gp" if eval_dtype == "f32" else "gp_" + eval_dtype,
               "gp_eval_dtype": eval_dtype, "leg": leg, "seeds": n_seeds, "wall_s": wall,
               "chunk_wall_s": chunk["wall_s"], "generations": len(chunk["device_s"]),
               "device_s_per_gen": float(np.mean(chunk["device_s"])),
               "host_s_per_gen": float(np.mean(chunk["host_s"])),
               "device_s_per_gen_after_first": float(np.mean(chunk["device_s"][1:])),
               "launches": launches, "best_fit_finite": bool(np.isfinite(chunk["best_fit"]).all()),
               "joint": int(np.all(cf > 0, axis=1).sum()), "eq0": int((cf[:, 0] > 0).sum()),
               "eq1": int((cf[:, 1] > 0).sum()), "correct_form": cf.astype(int).tolist(),
               "equations": res["equations"]}
        emit_fn(rec)
        out[leg] = rec
    return out


def symreg_phase(dev, x, dx, emit_fn, ae_dtype="f32"):
    """Path 2: the CLI's EquivSINDy-r sweep on one chunk of SYMREG_SEEDS
    seeds with --ae_dtype ``ae_dtype`` (phase symreg, or symreg_bf16), with
    every launch count set to 0 just before and read just after."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import run
    from symmetry_ode_discovery_tpu_torch.models.sindy import SINDyState, equation_strings
    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir, lbfgs_sweep, symmpen

    with tempfile.TemporaryDirectory() as tmp:
        n_seeds = SYMREG_SEEDS
        args = symreg_args(["--n_seeds", str(n_seeds), "--seed_chunk", str(n_seeds),
                            "--eval_root", tmp, "--ae_dtype", ae_dtype])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(args, train_data=(x, dx), device=dev, ckpt_root=str(CKPT_ROOT))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(symmpen.launches, lbfgs_dir=lbfgs_dir.launches,
                        lbfgs_sweep=lbfgs_sweep.launches)
        files = [os.path.join(tmp, args["save_dir"], f"seed{s}.npz") for s in range(n_seeds)]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            raise RuntimeError(f"symreg: {len(missing)} of {n_seeds} eval npz files missing")
        cf = np.stack([np.load(f)["correct_form"] for f in files])
        mse = np.stack([np.load(f)["mse"] for f in files])
    joint = np.all(cf > 0, axis=1)
    cfg, _ = make_config(2, poly_order=2, include_exp=True)
    xi = np.asarray(out["Xi"])
    eqs = [equation_strings(cfg, SINDyState(
        Xi=torch.as_tensor(xi[i]), mask=torch.as_tensor(xi[i] != 0), beta=torch.zeros(0),
        const=torch.zeros((2, 1)), Q=torch.zeros((1, 0)))) for i in range(xi.shape[0])]
    rec = {"phase": "symreg" if ae_dtype == "f32" else "symreg_" + ae_dtype,
           "ae_dtype": ae_dtype, "seeds": n_seeds, "wall_s": wall, "equations": eqs,
           "epochs_run_per_chunk": out["epochs_run"], "stop_epoch": out["stop_epoch"],
           "joint_success": int(joint.sum()), "eq0_success": int((cf[:, 0] > 0).sum()),
           "rmse_joint": float(np.mean(np.sqrt(mse[joint]))) if joint.any() else float("nan"),
           "correct_form": cf.astype(int).tolist(), "launches": launches,
           "Xi_finite": bool(np.isfinite(out["Xi"]).all()),
           "Xi_shape": list(np.shape(out["Xi"])), "xi": np.asarray(out["Xi"]).tolist()}
    emit_fn(rec)
    return rec


WSINDY_SEEDS = 50        # the WSINDy sweep: 50 seeds, the reference's windows
STLSQ_SEEDS = 4          # STLSQ on all 2,000,000 LV rows: a few seeds


def all_launches():
    """Every kernel's launch count, by function."""
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir, lbfgs_sweep, symmpen, tape_eval

    return dict(symmpen.launches, **tape_eval.launches, lbfgs_dir=lbfgs_dir.launches,
                lbfgs_sweep=lbfgs_sweep.launches)


def _solver_agreement(card, cpu):
    """Seeds whose masks are equal, and the largest |coefficient
    difference| over the seeds whose masks are."""
    import numpy as np

    same = np.all(card["mask"] == cpu["mask"], axis=(1, 2))
    diff = np.abs(card["Xi"] * card["mask"] - cpu["Xi"] * cpu["mask"])[same]
    return int(same.sum()), float(diff.max()) if same.any() else float("nan")


@contextlib.contextmanager
def cpu_threads(n=4):
    """At most ``n`` torch threads inside the block: MKL's batched QR with a
    thread for every core runs orders of magnitude slower when another
    process holds a core."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, n))
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _solver_record(phase, config, out, cpu, wall, cpu_wall, launches):
    import numpy as np

    cf = np.stack([r["correct_form"] for r in out["results"]])
    same, max_diff = _solver_agreement(out, cpu)
    return {"phase": phase, "config": config, "seeds": int(cf.shape[0]), "wall_s": wall,
            "cpu_wall_s": cpu_wall, "joint": int(np.all(cf > 0, axis=1).sum()),
            "eq0": int((cf[:, 0] > 0).sum()), "eq1": int((cf[:, 1] > 0).sum()),
            "masks_equal_cpu": same, "max_coef_diff_cpu": max_diff,
            "finite": bool(np.isfinite(out["Xi"]).all()),
            "Xi_shape": list(np.shape(out["Xi"])), "launches": launches}


def wsindy_phase(dev, x, emit_fn):
    """WSINDy through cli/main_wsindy.py::run on the LV noise-0.99
    trajectories x (200, 10000, 2) of the data phase: WSINDY_SEEDS seeds,
    --subsample_rng ref, every launch count set to 0 just before and read
    just after (the path has no kernel of its own); then the same run on
    the CPU on the same trajectories, for the gate (masks per seed and the
    coefficients where they agree)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.cli import main_wsindy
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    config = "lv/noise99_eq_wsindy.cfg"
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--config", config, "--n_seeds", str(WSINDY_SEEDS), "--seed", "0",
                "--subsample_rng", "ref", "--eval_root", tmp, "--save_root", tmp]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = main_wsindy.run(vars(get_args(argv)), train_data=(x, x), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        xc = x.cpu()
        t0 = time.perf_counter()
        with cpu_threads():
            cpu = main_wsindy.run(vars(get_args(argv)), train_data=(xc, xc), device="cpu")
        cpu_wall = time.perf_counter() - t0
    rec = _solver_record("wsindy", config, out, cpu, wall, cpu_wall, launches)
    emit_fn(rec)
    return rec


def stlsq_phase(dev, x, dx, emit_fn):
    """STLSQ through cli/main_sindy.py::run on all 2,000,000 rows of the LV
    noise-0.99 data of the data phase (lv/noise99_eq_sindy_2.cfg's library
    and threshold, 5 iterations), STLSQ_SEEDS seeds, every launch count set
    to 0 just before and read just after; then the same solve on the CPU on
    the same rows in the same per-seed order."""
    import torch

    from symmetry_ode_discovery_tpu_torch.cli import main_sindy
    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.training.sweep import (
        _subsample_idx, sweep_sindy_stlsq)
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    config = "lv/noise99_eq_sindy_2.cfg"
    seeds = list(range(STLSQ_SEEDS))
    with tempfile.TemporaryDirectory() as tmp:
        args = vars(get_args(["--config", config, "--n_seeds", str(STLSQ_SEEDS), "--seed", "0",
                              "--eval_root", tmp, "--save_root", tmp]))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = main_sindy.run(args, train_data=(x, dx), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
    # the CLI's rows: each seed's own permutation of all rows, drawn again
    idx = _subsample_idx(seeds, x.shape[0], x.shape[0], dev).cpu().numpy()
    cfg, _ = make_config(2, poly_order=2, include_exp=True, threshold=args["threshold"])
    t0 = time.perf_counter()
    with cpu_threads():
        res = sweep_sindy_stlsq(cfg, None, x.cpu(), dx.cpu(), sindy_truth["lv"], seeds,
                                threshold=args["threshold"],
                                max_iter=max(5, args["num_epochs"] // 20),
                                subsample_idx=idx, device="cpu")
    cpu_wall = time.perf_counter() - t0
    rec = _solver_record("stlsq", config, out, {"Xi": res.Xi, "mask": res.mask}, wall,
                         cpu_wall, launches)
    emit_fn(rec)
    return rec
