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
import io
import math
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
    (200 ICs x 10000 RK4 steps each, the levels' solves in one) and the
    growth train split at noise 0.05, flattened to rows; a wrong shape or a
    non-finite value raises."""
    import torch

    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed
    from symmetry_ode_discovery_tpu_torch.data.generate import gen_data_levels

    lv = SYSTEMS["lv"]
    xs, dxs = [], []
    gens = [torch.Generator(device=dev).manual_seed(cache_seed("train", nl)) for nl in LV_LEVELS]
    for nl, (x, dx) in zip(LV_LEVELS, gen_data_levels(
            lv, gens, LV_LEVELS, multiplicative_noise=lv.multiplicative_noise, smoothing="gp",
            device=dev)):
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
    cfg_lv, hp_lv, cfg_g, Q_g, hp_g = path1_configs()
    return {"growth_esindy": k1_case(dev, cfg_g, Q_g, hp_g, [xg], [dxg], 0.5),
            "lv_sindy_allnoise": k1_case(dev, cfg_lv, None, hp_lv, xs, dxs, 0.01)}


def k1_case(dev, cfg, Q, hp, xs, dxs, sub):
    """K1's inputs at the stacked launch of the datasets xs x SEEDS, built by
    the sweep's own stacked_lanes (a warm pass first): (kernel config, (S,
    B, q, n_elems, theta0), Mmap, lanes, warm prep ms)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.training.sweep import stacked_lanes

    stacked_lanes(cfg, Q, xs, dxs, hp, SEEDS, sub, dev)  # warm pass
    torch.cuda.synchronize()
    t_prep = time.perf_counter()
    pcfg, lanes, Mmap = stacked_lanes(cfg, Q, xs, dxs, hp, SEEDS, sub, dev)
    torch.cuda.synchronize()
    t_prep = (time.perf_counter() - t_prep) * 1e3  # subsample + normal equations
    return pcfg, lanes, Mmap, len(xs) * len(SEEDS), t_prep


NC_LEVELS = [0.0, 0.05, 0.1, 0.15, 0.2]   # the tracked dosc and growth noise curves' levels
NC_CURVES = {"dosc": ("sindy", "esindy"), "growth": ("sindy", "esindy", "wsindy")}
# growth EquivSINDy-c (tracked: 50 of 50 at every level): the repository's
# invariant (the full growth protocol stays 50 of 50) at noise 0.00 and
# 0.05, at least 48 of 50 at the other levels
NC_GROWTH_ESINDY_MIN = {0.0: 50, 0.05: 50, 0.1: 48, 0.15: 48, 0.2: 48}


def noise_curve_data(dev):
    """The dosc (50 ICs) and growth (100 ICs) train splits at NC_LEVELS,
    generated on the card by cli/noise_curve.py::gen_levels (one RK4 solve
    a system), kept in memory: {system: [(x, dx)]}, each (n_ics, 100, 2);
    a wrong shape or a non-finite value raises."""
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.noise_curve import gen_levels
    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS

    out = {}
    for name in NC_CURVES:
        out[name] = gen_levels(name, NC_LEVELS, dev)
        for nl, (x, dx) in zip(NC_LEVELS, out[name]):
            if tuple(x.shape) != (SYSTEMS[name].default_n_train, 100, 2) or not bool(
                    torch.isfinite(x).all() and torch.isfinite(dx).all()):
                raise RuntimeError(f"{name} noise {nl}: bad data {tuple(x.shape)}")
    torch.cuda.synchronize()
    return out


def noise_curve_k1_case(dev, data):
    """k1_case at the dosc EquivSINDy-c (so(2)) curve's launch, NC_LEVELS x
    50 seeds."""
    from symmetry_ode_discovery_tpu_torch.cli.noise_curve import make_protocol
    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams

    cfg_kw, hp_kw, sub = make_protocol("dosc", "esindy")
    cfg, Q = make_config(2, **cfg_kw)
    hp = LBFGSHParams(w_sindy_x=1.0, w_sindy_reg=0.0, sindy_reg_type="l1", **hp_kw)
    return k1_case(dev, cfg, Q, hp, [x.reshape(-1, 2) for x, _ in data["dosc"]],
                   [dx.reshape(-1, 2) for _, dx in data["dosc"]], sub)


def noise_curve_phase(dev, data, emit_fn):
    """The noise curves through cli/noise_curve.py::run_method on the card's
    data: dosc SINDy and EquivSINDy-c, growth SINDy, EquivSINDy-c and
    WSINDy, NC_LEVELS x 50 seeds, each L-BFGS curve one K1 launch, with
    every launch count 0 before each curve and read after it. Gated: one K1
    launch a SINDy or EquivSINDy-c curve, none for WSINDy; growth
    EquivSINDy-c at NC_GROWTH_ESINDY_MIN; every coefficient finite. Returns
    the record with its failures."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.noise_curve import run_method
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep

    rec = {"phase": "noise_curve", "levels": NC_LEVELS, "seeds": len(SEEDS)}
    failures = []
    for name, methods in NC_CURVES.items():
        for method in methods:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_method(name, method, NC_LEVELS, data[name], SEEDS, dev)
            wall = time.perf_counter() - t0
            joint = {f"{nl:.2f}": int(np.all(r.correct_form > 0, axis=1).sum())
                     for nl, r in zip(NC_LEVELS, res)}
            rec[f"{name}_{method}"] = {"joint_by_noise": joint, "wall_s": wall,
                                       "lbfgs_sweep_launches": lbfgs_sweep.launches}
            want = 0 if method == "wsindy" else 1
            if lbfgs_sweep.launches != want:
                failures.append(f"noise curve {name} {method}: {lbfgs_sweep.launches} "
                                f"lbfgs_sweep launches, expected {want}")
            if not all(np.isfinite(r.Xi).all() for r in res):
                failures.append(f"noise curve {name} {method}: non-finite coefficients")
            if (name, method) == ("growth", "esindy"):
                for nl, lo in NC_GROWTH_ESINDY_MIN.items():
                    if joint[f"{nl:.2f}"] < lo:
                        failures.append(f"noise curve growth EquivSINDy-c at noise {nl:.2f}: "
                                        f"{joint[f'{nl:.2f}']} of 50 (at least {lo})")
    rec["lbfgs_sweep_launches"] = sum(v["lbfgs_sweep_launches"] for k, v in rec.items()
                                      if isinstance(v, dict))
    rec["failures"] = failures
    emit_fn(rec)
    return rec


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


def flagship_models(dev, ckpt_dir=None):
    """(flags, frozen AutoEncoder, GeneratorSpec, GeneratorState) of the
    flagship configuration, from its checkpoint under saved_models/ or from
    ``ckpt_dir`` (a checkpoint of the same architecture; a missing file
    raises)."""
    from symmetry_ode_discovery_tpu_torch.cli.main import build_models
    from symmetry_ode_discovery_tpu_torch.convert import laligan_from_npz

    args = symreg_args([])
    args["input_dim"] = 2
    sd, g_state = laligan_from_npz(str(ckpt_dir or CKPT_ROOT / args["load_laligan"]), dev)
    ae, spec = build_models(args)
    ae.load_state_dict(sd)
    return args, ae.to(dev).eval().requires_grad_(False), spec, g_state


def l2_weight_bytes(f, kind, rows, dtype):
    """Bytes of hidden x hidden weights one launch of ``kind`` (a key of
    symmpen.MODES) over ``rows`` rows reads out of L2: every CTA streams each
    hidden product's weights once, f32 at the hidden width; bf16 (every mode
    on the tensor cores) at the tile width, with the grid rounded up to
    whole clusters, whose CTAs share each weight byte by multicast
    (csrc/symmpen.cu)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp

    ctas = -(-rows // sp.row_tile(kind, f.hidden))
    hidden = f.n_relu - 1
    if dtype == torch.float32:
        return ctas * hidden * f.hidden * f.hidden * 4
    W = sp.tile_width(f.hidden)
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
    its own side's forward. A forward's flip rows (ops/symmpen.py::
    mask_flips: its masks differ from the plain chain's in some layer) are
    those of its own side (the encoder's for K2, the decoder's for K3); each
    record has their count and the max |diff| on them and on the other rows.
    Gates (in main): f32, max |diff| and rows beyond 1e-5 of the output
    scale, and a forward's mask bit may differ from the plain chain's only
    within f32 rounding of 0; bf16, at most 0.1% of the mask bits differing,
    none beyond 1e-2 of its terms from 0, the encoder's output within 1e-2 of
    the output scale on every row, the tangent's and the backwards' within
    1e-2 on the rows with no flip, their flip rows at most 0.1% of the rows
    and finite.
    Bounds count this design's work (the backward runs no primal chain; the
    masks are written and read once; bf16 weights are 2 bytes, their
    operations at the bf16 tensor-core peak) and, as bound_old_ms, the
    recomputing design's. Each record also has the hidden weight bytes the
    launch reads out of L2 (l2_weight_bytes) and, given ``l2_rate``
    (bytes/s), their time at that rate; library_ms is the device time of
    cublas_chain in the same dtype. Times by CUDA events; then the per-closure
    sum. ``outputs``, when a dict, receives each function's output and each
    forward's packed masks by record name, and the inputs the backwards take
    besides masks under "inputs": {function: (folded chain, cotangent)}."""
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
    agree = {"enc": sp.mask_flips(fe, x, sp.unpack_masks(mk_e, fe.hidden), rel, dtype),
             "dec": sp.mask_flips(fd, z, sp.unpack_masks(mk_d, fd.hidden), rel, dtype)}
    wbytes = 2 if bf16 else 4
    weights = lambda f: wbytes * sum(w.numel() for w in f.Ws) + 4 * sum(b.numel() for b in f.bs)
    masks = lambda f: f.n_relu * rows * f.hidden // 8
    io = lambda *widths: 4 * rows * sum(widths)
    fwd_e, fwd_d = rows * chain_flops(fe), rows * chain_flops(fd)
    hid_e, hid_d = rows * chain_flops(fe, True), rows * chain_flops(fd, True)
    cases = [  # name, kernel, plain, (bytes, flops), old (bytes, flops), forward's side
        ("symmpen_enc_fwd", "K2", lambda: sp.enc_fwd_kernel(fe, x, dtype)[0],
         lambda: sp.enc_fwd_plain(fe, x, dtype)[0],
         (weights(fe) + io(fe.d_in, fe.d_out) + masks(fe), fwd_e),
         (weights(fe) + io(fe.d_in, fe.d_out), fwd_e), "enc"),
        ("symmpen_enc_bwd", "K2", lambda: sp.enc_bwd_kernel(fe, mk_e, cz, dtype),
         lambda: sp.enc_bwd_plain(fe, mp_e, cz, dtype),
         (weights(fe) + io(fe.d_out, fe.d_in) + masks(fe), fwd_e),
         (weights(fe) + io(fe.d_in, fe.d_out, fe.d_in), hid_e + fwd_e), "enc"),
        ("symmpen_dec_jvp", "K3", lambda: sp.dec_jvp_fwd_kernel(fd, z, u, dtype)[0],
         lambda: sp.dec_jvp_fwd_plain(fd, z, u, dtype)[0],
         (weights(fd) + io(fd.d_in, fd.d_in, fd.d_out) + masks(fd), hid_d + fwd_d),
         (weights(fd) + io(fd.d_in, fd.d_in, fd.d_out), hid_d + fwd_d), "dec"),
        ("symmpen_dec_jvp_bwd", "K3", lambda: sp.dec_jvp_bwd_kernel(fd, mk_d, cz, dtype),
         lambda: sp.dec_jvp_bwd_plain(fd, mp_d, cz, dtype),
         (weights(fd) + io(fd.d_out, fd.d_in) + masks(fd), fwd_d),
         (weights(fd) + io(fd.d_in, fd.d_out, fd.d_in), hid_d + fwd_d), "dec"),
    ]
    out = {}
    if outputs is not None:
        outputs["inputs"] = {"enc_bwd": (fe, cz), "dec_jvp_bwd": (fd, cz)}
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
        flip = agree[chain][0]
        row_err = diff.amax(dim=1)
        rec = {"phase": phase, "name": name, "kernel": tag, **tags, "rows": rows,
               "max_abs_err": float(diff.max()), "scale": scale,
               "flip_rows": int(flip.sum()),
               "max_abs_err_agreeing_rows": float(row_err[~flip].max()) if rows > int(flip.sum())
               else 0.0,
               "max_abs_err_flip_rows": float(row_err[flip].max()) if bool(flip.any()) else 0.0,
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
        forward = not kind.endswith("bwd")
        if outputs is not None:
            outputs[name] = got
            if forward:
                outputs[name + " masks"] = mk_e if chain == "enc" else mk_d
        if forward:
            _, flips, unexplained = agree[chain]
            rec.update(mask_bits=masks(fe if chain == "enc" else fd) * 8, mask_bits_differ=flips,
                       mask_bits_differ_not_near_0=unexplained, mask_rel=rel)
        emit_fn(rec)
        out[name] = rec
    total = {k: sum(r[k] for r in out.values())
             for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_old_ms")}
    emit_fn({"phase": phase, "name": "closure_k2_k3" + suffix, **tags, "rows": rows, **total})
    return out


def closure_inputs(dev, x, ckpt_dir=None):
    """The inputs of one EquivSINDy-r closure at full width: 4 seeds x
    20,000 rows of the LV noise-0.99 data ``x``, their rollout endpoint fx
    under the true LV equation, the folded chains of the flagship checkpoint
    (or ``ckpt_dir``), z and u for the decoder JVP, a cotangent cz, and the
    generator that drew it: (fe, fd, fx, z, u, cz, gen)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp
    from symmetry_ode_discovery_tpu_torch.ops.integrators import odeint
    from symmetry_ode_discovery_tpu_torch.training.sweep import _subsample_idx

    args, ae, spec, g_state = flagship_models(dev, ckpt_dir)
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
    return fe, fd, fx, z, u, cz, gen


def symmpen_phase(dev, x, emit_fn, l2_rate=None, outputs=None):
    """K2, K3 and K4 against their plain versions on the inputs of one
    EquivSINDy-r closure (closure_inputs, the frozen checkpoint); then K2
    and K3 in bf16 on the same inputs (k23_phase's l2_rate and outputs).
    Returns (the f32 records with K4's, the bf16 records)."""
    import torch

    fe, fd, fx, z, u, cz, gen = closure_inputs(dev, x)
    out = k23_phase(fe, fd, fx, z, u, cz, emit_fn, {}, None, l2_rate, outputs)
    out["lbfgs_dir"] = k4_phase(dev, gen, emit_fn)
    return out, k23_phase(fe, fd, fx, z, u, cz, emit_fn, {}, torch.bfloat16, l2_rate, outputs)


def bf16_gate_phase(dev, x, ckpt_dir, emit_fn):
    """The bf16 gate's records (k23_phase in bf16) on one closure of a
    checkpoint of the flagship's architecture: each function's flip rows
    (rows gated by a forward mask that differs from the plain chain's) as a
    share of the rows, beside the smoke gate's 0.1%."""
    import torch

    fe, fd, fx, z, u, cz, _ = closure_inputs(dev, x, ckpt_dir)
    tags = {"checkpoint": str(ckpt_dir)}
    recs = k23_phase(fe, fd, fx, z, u, cz, lambda r: None, tags, torch.bfloat16)
    rec = {"phase": "bf16_gate", **tags, "rows": fx.shape[0],
           "flip_row_share": {n: r["flip_rows"] / r["rows"] for n, r in recs.items()},
           "flip_rows": {n: r["flip_rows"] for n, r in recs.items()},
           "mask_bits_differ": {n: r["mask_bits_differ"] for n, r in recs.items()
                                if "mask_bits" in r},
           "mask_bits_differ_not_near_0": {n: r["mask_bits_differ_not_near_0"]
                                           for n, r in recs.items() if "mask_bits" in r},
           "max_abs_err_agreeing_rows_over_scale": {
               n: r["max_abs_err_agreeing_rows"] / r["scale"] for n, r in recs.items()}}
    rec["over_gate"] = sorted(n for n, v in rec["flip_row_share"].items()
                              if not n.startswith("symmpen_enc_fwd") and v > 1e-3)
    emit_fn(rec)
    return rec


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


def tape_bf16_shapes(ti, leg):
    """The shapes at which a generation of ``leg`` with --gp_eval_dtype bf16
    launches K5's bf16 mode (its full-batch fitness evaluations: the
    population and the top-256 groups on all rows; its Adam steps launch the
    f32 K5 and K6 of tape_shapes): a list of (record of the shape with its
    bytes bound and launches per chunk, the launch at the units gp_phase
    runs, the kernel and its plain version on every unit of ``ti``, the f32
    K5's launch at the same shape and units)."""
    from functools import partial

    import torch

    from symmetry_ode_discovery_tpu_torch.cli import main_gp
    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te
    from symmetry_ode_discovery_tpu_torch.symgp.tape import eval_tapes_plain

    gens = main_gp.gp_config(gp_args(leg), 0).n_generations
    U = ti.ops.shape[0]
    u_gp = U * GP_SEEDS[leg] // TAPE_SEEDS
    out = []
    for shape, (o, a, c, xs) in (("population, all rows", (ti.ops, ti.args, ti.consts, ti.pts)),
                                 (f"top-{GP_TOPK} groups, all rows",
                                  (ti.sops, ti.sargs, ti.sconsts, ti.pts))):
        f32 = [v[:u_gp].contiguous() for v in (o, a, c, xs)]
        c, xs = c.to(torch.bfloat16).contiguous(), xs.to(torch.bfloat16).contiguous()
        sub = [v[:u_gp].contiguous() for v in (o, a, c, xs)]
        rec = tape_bound(sub[0], xs.shape[1], xs.shape[2], xs.shape[1], 1, elem=2)
        rec.update(kernel="K5_bf16", shape=shape, units=u_gp, tapes_per_unit=o.shape[1],
                   rows=xs.shape[1], launches_per_chunk=gens)
        out.append((rec, partial(te.eval_tapes_kernel, *sub, ti.depth, ti.table),
                    partial(te.eval_tapes_kernel, o, a, c, xs, ti.depth, ti.table),
                    partial(eval_tapes_plain, o, a, c, xs, ti.depth, ti.table),
                    partial(te.eval_tapes_kernel, *f32, ti.depth, ti.table)))
    return out


# K5 bf16's traps: row counts around its 8-row lanes and 256-row pass (and
# under one lane's rows), and hand-built tapes on rows that reach every
# corner of bf16
K5_TRAP_ROWS = (1, 7, 8, 9, 255, 256, 257)
K5_TRAP_SPECIALS = (0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40,
                    3.3e38, -3.3e38, 1.0, -1.0)


def k5_trap_population(L=40):
    """Hand-built tapes on two variables for K5 bf16's traps, as (names,
    ops, args, consts), numpy (T, L) arrays (int32, int32, float32) padded
    with PAD: products and quotients that round to -0 or to bf16 subnormals
    (the constant 1e-38 is itself a subnormal), sums and differences that
    overflow to +inf and -inf, NaN made from inf - inf, b - a and b / a on
    unequal operands both ways, negation of 0, the transcendental ops on the
    special rows, and a tape that pushes a 17th leaf onto a 16-deep stack
    (NaN on every row)."""
    import numpy as np

    from symmetry_ode_discovery_tpu_torch.symgp import tape as tt

    v0, v1 = (tt.VAR, 0, 0.0), (tt.VAR, 1, 0.0)
    c = lambda value: (tt.CONST, 0, value)
    op = lambda code: (code, 0, 0.0)
    tapes = {
        "mul_subnormal_const": [v0, c(1e-38), op(tt.MUL)],
        "mul_neg_subnormal_const": [v0, c(-3e-39), op(tt.MUL)],
        "mul_rows": [v0, v1, op(tt.MUL)],
        "mul_to_neg_zero": [v0, c(-1e-30), op(tt.MUL), c(1e-30), op(tt.MUL)],
        "div_by_huge": [v0, c(1e38), op(tt.DIV)],
        "div_subnormal_by_row": [c(-1e-38), v0, op(tt.DIV)],
        "div_rows": [v0, v1, op(tt.DIV)],
        "div_rows_swapped": [v1, v0, op(tt.DIV)],
        "sub_rows": [v0, v1, op(tt.SUB)],
        "sub_rows_swapped": [v1, v0, op(tt.SUB)],
        "add_rows": [v0, v1, op(tt.ADD)],
        "add_overflow": [v0, c(2e38), op(tt.MUL), c(2e38), op(tt.ADD)],
        "sub_overflow": [c(-2e38), v0, c(2e38), op(tt.MUL), op(tt.SUB)],
        "nan_operand": [c(1e30), c(1e30), op(tt.MUL), c(1e30), c(1e30), op(tt.MUL), op(tt.SUB),
                        v0, op(tt.ADD), v1, op(tt.MUL)],
        "neg_zero": [v0, op(tt.NEG), c(0.0), op(tt.NEG), op(tt.ADD)],
        "neg_row": [v0, op(tt.NEG)],
        "row": [v1],
        "sin_cos": [v0, op(tt.SIN), v1, op(tt.COS), op(tt.MUL)],
        "exp_div": [v0, op(tt.EXP), v1, op(tt.DIV)],
        "overflow": [v0] * 17 + [op(tt.ADD)] * 16,
    }
    ops = np.zeros((len(tapes), L), np.int32)
    args = np.zeros_like(ops)
    consts = np.zeros((len(tapes), L), np.float32)
    for i, slots in enumerate(tapes.values()):
        for l, (code, arg, value) in enumerate(slots):
            ops[i, l], args[i, l], consts[i, l] = code, arg, value
    return list(tapes), ops, args, consts


def k5_trap_rows(n_rows, seed=0):
    """(n_rows, 2) float32 rows for the trap tapes: +-10^u with u uniform in
    [-45, 39] (bf16 subnormals, numbers that round to 0, normals, and
    numbers whose products overflow), the first rows the specials of
    K5_TRAP_SPECIALS (in reverse order in the second column)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore", under="ignore"):
        X = (np.sign(rng.standard_normal((n_rows, 2)))
             * 10.0 ** rng.uniform(-45, 39, (n_rows, 2))).astype(np.float32)
    k = min(n_rows, len(K5_TRAP_SPECIALS))
    X[:k, 0] = K5_TRAP_SPECIALS[:k]
    X[:k, 1] = K5_TRAP_SPECIALS[::-1][:k]
    return X


def k5_trap_inputs(dev, n_rows, units=2):
    """K5's bf16 inputs of the trap tapes on ``n_rows`` rows: (ops, args,
    consts, X) on ``dev``, ``units`` units (each with its own rows, so that
    on an odd row count the second unit's rows and outputs are not 4-byte
    aligned), consts and X in bfloat16."""
    import numpy as np
    import torch

    _, ops, args, consts = k5_trap_population()
    X = np.stack([k5_trap_rows(n_rows, seed=u) for u in range(units)])
    t = lambda a, dtype=None: torch.as_tensor(np.ascontiguousarray(a), device=dev,
                                              dtype=dtype)
    rep = lambda a: np.repeat(a[None], units, axis=0)
    return (t(rep(ops)), t(rep(args)), t(rep(consts)).to(torch.bfloat16).contiguous(),
            t(X).to(torch.bfloat16).contiguous())


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


LALIGAN_EPOCHS = 2       # symmetry discovery: epochs of lv/noise99_sym.cfg
LALIGAN_SEED = 43        # the config's seed
LALIGAN_RELOAD_ATOL = 1e-6  # the reloaded checkpoint's encoder against the trainer's
LALIGAN_STEP_REL = 1e-4  # one batch step on the card against the CPU, each component


def laligan_phase(dev, x, dx, emit_fn):
    """Symmetry discovery (path 4): LALIGAN_EPOCHS epochs of
    lv/noise99_sym.cfg through cli/main.py::run at full width (5 x 512,
    batch 8192) on the LV trajectories x, dx (200 x 10000 rows, windowed in
    memory), saved to a temporary --save_root, with every launch count set
    to 0 just before and read just after; the per-epoch components, walls
    and batches a second. Then the checkpoint reloaded through
    convert.laligan_from_npz, its encoder against the trainer's in eval
    mode on the first 65,536 windows; then one batch step of one init, one
    batch and one coefficient draw on the card and on the CPU."""
    import contextlib
    import io

    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import build_models, build_trainer, run
    from symmetry_ode_discovery_tpu_torch.convert import laligan_from_npz
    from symmetry_ode_discovery_tpu_torch.data.datasets import MTODEDataset
    from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    xt, dxt = x.reshape(200, -1, 2), dx.reshape(200, -1, 2)
    with tempfile.TemporaryDirectory() as tmp:
        args = vars(get_args(["--config", "lv/noise99_sym.cfg", "--num_epochs",
                              str(LALIGAN_EPOCHS), "--save_root", tmp]))
        walls, log = [], io.StringIO()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = run(args, train_data=(xt, dxt), device=dev,
                      epoch_hook=lambda e, sec: walls.append(sec))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        tr = out["trainer"]
        sd, g_state = laligan_from_npz(out["save_dir"], dev)
    xw = MTODEDataset(xt, dxt, interval=10).materialize()[0]
    n, bs = xw.shape[0], args["batch_size"]
    ae = build_models(args)[0]
    ae.load_state_dict(sd)
    ae = ae.to(dev).eval()
    with torch.no_grad():
        z_tr = tr.ae.eval().encode(xw[:65536])
        z_ck = ae.encode(xw[:65536])
    hist = out["history"]
    rec = {"phase": "laligan", "config": "lv/noise99_sym.cfg", "epochs": LALIGAN_EPOCHS,
           "windows": n, "batch_size": bs, "batches_per_epoch": n // bs,
           "width": [args["n_layers"], args["hidden_dim"]], "wall_s": wall,
           "epoch_walls_s": walls, "batches_per_s": [(n // bs) / w for w in walls],
           "history": hist, "finite": all(math.isfinite(v) for h in hist for v in h.values()),
           "launches": launches,
           "reload_max_abs_err": float((z_tr - z_ck).abs().max()),
           "reload_masks_equal": all(bool(torch.equal(a, b.to(a.device)))
                                     for a, b in zip(tr.g_state.masks, g_state.masks)),
           "Li": [L.detach().cpu().tolist() for L in lg.getLi(tr.spec, tr.g_state)],
           "log": log.getvalue().splitlines()[-4:]}
    del tr, out, z_tr, z_ck
    # one step of one init, batch and draw on the card and on the CPU
    xb = xw[:bs]
    coef = torch.randn((bs, 1), generator=torch.Generator().manual_seed(0))
    steps = {}
    for where in (dev, torch.device("cpu")):
        t = build_trainer(args, where)
        t.init(LALIGAN_SEED)
        t0 = time.perf_counter()
        m = t.step(xb.to(where), None, [coef.to(where)])
        steps[where.type] = ({k: float(v) for k, v in m.items()}, time.perf_counter() - t0)
    card, cpu = steps[dev.type][0], steps["cpu"][0]
    rec["step_card_vs_cpu"] = {
        "card": card, "cpu": cpu, "cpu_step_s": steps["cpu"][1],
        "max_rel": max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu
                       if cpu[k] != 0.0 or card[k] != 0.0)}
    emit_fn(rec)
    return rec


RD_EPOCHS = 100          # joint symmetry discovery: rd/sym_eq.cfg's whole protocol
RD_SOLVER_REL = 1e-4     # the rd solver on the card against the CPU, of the field's maximum
RD_STEP_REL = 1e-4       # one joint step on the card against the CPU, each component


def rd_phase(dev, emit_fn, epochs=RD_EPOCHS, workdir=None):
    """The reaction-diffusion pipeline (path 5): the solver on the card
    against the same solver on the CPU (largest difference over the
    field's largest magnitude, uf and duf); then ``epochs`` epochs of
    rd/sym_eq.cfg (joint SINDy-in-latent, the constrained least-squares
    branch) through cli/main.py::run at full width (10,000 inputs, 5 x
    512, latent 2, batch 64) on the card's data, written as
    reaction_diffusion.mat under a temporary data path, with every launch
    count set to 0 just before and read just after; the checkpoint and
    regressor.npz reloaded (the encoder against the trainer's, Xi and mask
    equal); the held-out reconstruction floor; the singular values next to
    Q's 5e-3 cutoff over the run's recomputes; then one joint step (the
    epoch's last, Q recomputed) of one init, batch and draw on the card and
    on the CPU. ``workdir`` (kept) holds reaction_diffusion.mat and the
    checkpoint under out/ (``rec["save_dir"]``); without it a temporary
    directory."""
    import contextlib
    import io

    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import build_models, build_trainer, run
    from symmetry_ode_discovery_tpu_torch.convert import laligan_from_npz
    from symmetry_ode_discovery_tpu_torch.data.datasets import (
        MultiTimestepReactionDiffusionDataset, _load_rd)
    from symmetry_ode_discovery_tpu_torch.data.rd_solver import save_rd_mat, simulate_rd
    from symmetry_ode_discovery_tpu_torch.evaluation.rd_floor import ae_floor
    from symmetry_ode_discovery_tpu_torch.utils.checkpoint import load_regressor
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    rec = {"phase": "rd", "config": "rd/sym_eq.cfg", "epochs": epochs}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = simulate_rd(device=dev)
    torch.cuda.synchronize()
    rec["solver_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with cpu_threads():
        sim_cpu = simulate_rd(device="cpu")
    rec["solver_cpu_s"] = time.perf_counter() - t0
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    rec["solver_rel_card_cpu"] = {"uf": rel(sim[3], sim_cpu[3]), "duf": rel(sim[4], sim_cpu[4])}
    saved_env = os.environ.get("SODT_TORCH_DATA_PATH")
    keep = contextlib.nullcontext(workdir) if workdir else tempfile.TemporaryDirectory()
    with keep as tmp:
        try:
            os.environ["SODT_TORCH_DATA_PATH"] = tmp
            save_rd_mat(os.path.join(tmp, "reaction_diffusion.mat"), *sim)
            args = vars(get_args(["--config", "rd/sym_eq.cfg", "--num_epochs", str(epochs),
                                  "--save_root", os.path.join(tmp, "out")]))
            walls, log = [], io.StringIO()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                out = run(args, device=dev, epoch_hook=lambda e, sec: walls.append(sec))
            torch.cuda.synchronize()
            rec["wall_s"] = time.perf_counter() - t0
            rec["launches"] = all_launches()
            tr = out["trainer"]
            data = _load_rd(device=dev)
            sd, g_state = laligan_from_npz(out["save_dir"], dev)
            Xi, mask = load_regressor(out["save_dir"], dev)
        finally:
            if saved_env is None:
                os.environ.pop("SODT_TORCH_DATA_PATH", None)
            else:
                os.environ["SODT_TORCH_DATA_PATH"] = saved_env
    xw, dxw = MultiTimestepReactionDiffusionDataset(data, "train", device=dev).materialize()
    ae = build_models(args)[0]
    ae.load_state_dict(sd)
    ae = ae.to(dev).eval()
    with torch.no_grad():
        z_tr = tr.ae.eval().encode(xw)
        z_ck = ae.encode(xw)
    hist = out["history"]
    rec.update({
        "windows": int(xw.shape[0]), "batch_size": args["batch_size"],
        "batches_per_epoch": int(xw.shape[0] // args["batch_size"]),
        "width": [args["input_dim"], args["n_layers"], args["hidden_dim"], args["latent_dim"]],
        "epoch_walls_s": walls, "history_last": hist[-1] if hist else None,
        "finite": bool(hist) and all(math.isfinite(v) for h in hist for v in h.values()),
        "loss_ae_rel": [h["loss_ae_rel"] for h in hist],
        "loss_sindy_z": [h["loss_sindy_z"] for h in hist],
        "reload_max_abs_err": float((z_tr - z_ck).abs().max()),
        "regressor_equal": bool(torch.equal(Xi, tr.sindy["Xi"].detach().float())
                                and torch.equal(mask, tr.sindy["mask"].float())),
        "mask": mask.cpu().tolist(), "Xi": Xi.cpu().tolist(), "q_sv": tr.q_sv_margin(),
        "save_dir": out["save_dir"],
        "floor": ae_floor(tr.ae, data, dev), "log": log.getvalue().splitlines()[-3:]})
    del tr, out, z_tr, z_ck
    # one joint step of one init, batch and draw on the card and on the CPU
    bs = args["batch_size"]
    xb, dxb = xw[:bs], dxw[:bs]
    coef = torch.randn((bs, 1), generator=torch.Generator().manual_seed(0))
    steps = {}
    for where in (dev, torch.device("cpu")):
        t = build_trainer(args, where, steps_per_epoch=rec["batches_per_epoch"])
        t.init(args["seed"])
        t0 = time.perf_counter()
        with cpu_threads() if where.type == "cpu" else contextlib.nullcontext():
            m = t.step(xb.to(where), None, [coef.to(where)], dxb.to(where), is_last=True)
        steps[where.type] = ({k: float(v) for k, v in m.items()}, time.perf_counter() - t0,
                             t.sindy["mask"].cpu(), t.q_sv_margin())
    card, cpu = steps[dev.type][0], steps["cpu"][0]
    rec["step_card_vs_cpu"] = {
        "card": card, "cpu": cpu, "cpu_step_s": steps["cpu"][1],
        "masks_equal": bool(torch.equal(steps[dev.type][2], steps["cpu"][2])),
        "q_sv_card": steps[dev.type][3], "q_sv_cpu": steps["cpu"][3],
        "max_rel": max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu
                       if cpu[k] != 0.0 or card[k] != 0.0)}
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


LTP_REL = 1e-4           # LTP: per-seed errors, card against CPU, where finite
LTP_FLOOR = 1e-6         # LTP: the truth row's time-mean relative error
RD_LTP_REL = 1e-4        # rd LTP: every series, card against CPU, of its largest magnitude
ADAM_STEPS = 20          # the adam phase: one epoch of 20 batches of 256
ADAM_REL = 1e-4          # Adam: the parameters, card against CPU, of their largest magnitude
LATENT_SUBSAMPLE = 0.02  # the latent phase: 2,000 of the 100,000 selkov rows a fit
LATENT64_REL = 1e-6      # the latent fit in float64: coefficients, card against CPU,
                         # of their largest magnitude
LATENT_DST64_REL = 1e-3  # its distillation in float64, as LATENT64_REL
SELKOV_CONFIG = "selkov/noise20_eq_symreg.cfg"


def _rel_max(a, b):
    """max |a - b| over max |b| (0 when both are all 0)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 else float(np.abs(a).max())


def ltp_phase(dev, res_lv, emit_fn):
    """Long-term prediction (cli/eval_ltp_sweep.py::ltp_sweep_errors, in
    float32 as the CLI runs it): the 20 clean LV validation trajectories
    (noise 0, 10,000 steps) generated on the card, path 1's 50 noise-0.99
    coefficient matrices and the truth rolled out in one batched RK4 on the
    card (every launch count set to 0 just before, read just after) and on
    the CPU. Gates: the same seeds diverge on both; the seeds' time-mean
    errors within LTP_REL relative where finite; the truth floor (the
    rounding of the data, left out of the per-seed comparison) under
    LTP_FLOOR; no hand-written kernel."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.eval_ltp_sweep import _summ, ltp_sweep_errors
    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed, ode_dt_dict
    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth

    cfg = path1_configs()[0]
    gen = torch.Generator(device=dev).manual_seed(cache_seed("val", 0.0))
    x, _ = gen_data(SYSTEMS["lv"], gen, n_ics=20, noise=0.0, device=dev)
    res = res_lv[LV_LEVELS.index(0.99)]
    stack = np.concatenate([res.Xi * res.mask, sindy_truth["lv"][None]]).astype(np.float32)
    dt = ode_dt_dict["lv"]
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = ltp_sweep_errors(cfg, stack, x, dt).cpu().numpy()
    wall = time.perf_counter() - t0
    launches = all_launches()
    t0 = time.perf_counter()
    with cpu_threads():
        cpu = ltp_sweep_errors(cfg, stack, x.cpu(), dt).numpy()
    cpu_wall = time.perf_counter() - t0
    a, b = (r.reshape(len(stack), -1).mean(1) for r in (card, cpu))
    sa, sb = a[:-1], b[:-1]  # the seeds; the last row is the truth's floor
    fin = np.isfinite(sa) & np.isfinite(sb)
    rel = np.abs(sa - sb)[fin] / np.maximum(np.abs(sb[fin]), 1e-30)
    correct = np.all(res.correct_form > 0, axis=1)
    rec = {"phase": "ltp", "config": "lv/noise99_eq_sindy_2.cfg (path 1, noise 0.99)",
           "seeds": int(len(stack) - 1), "trajectories": list(x.shape), "wall_s": wall,
           "cpu_wall_s": cpu_wall, "launches": launches,
           "finite_card": int(np.isfinite(sa).sum()), "finite_cpu": int(np.isfinite(sb).sum()),
           "same_finite_set": bool(np.array_equal(np.isfinite(a), np.isfinite(b))),
           "max_rel_per_seed": float(rel.max()) if rel.size else 0.0,
           "seeds_over_rel": int((rel > LTP_REL).sum()), "truth_floor": float(a[-1]),
           "median_all": _summ(card[:-1], "all seeds (card)")["median"],
           "median_correct_form": _summ(card[:-1][correct], "correct-form seeds")["median"],
           "n_correct_form": int(correct.sum())}
    rec["failures"] = [f"ltp: {m}" for m, bad in (
        ("card and CPU diverge on different seeds", not rec["same_finite_set"]),
        (f"per-seed errors {rec['max_rel_per_seed']} apart (limit {LTP_REL})",
         not rec["max_rel_per_seed"] <= LTP_REL),
        (f"truth floor {rec['truth_floor']} (limit {LTP_FLOOR})",
         not rec["truth_floor"] < LTP_FLOOR),
        (f"a hand-written kernel launched: {launches}", any(launches.values()))) if bad]
    emit_fn(rec)
    return rec


def rd_ltp_phase(dev, rd_rec, workdir, emit_fn):
    """cli/eval_rd_ltp.py::run on the checkpoint the rd phase trained, on its
    data (``workdir``), on the val and traintail splits, on the card (launch
    counts 0 just before, read just after) and on the CPU. Gates: every
    series (the five relative errors, z_pred, z_true) within RD_LTP_REL of
    its largest magnitude, no hand-written kernel."""
    import contextlib
    import io

    import torch

    from symmetry_ode_discovery_tpu_torch.cli.eval_rd_ltp import run
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    saved_env = os.environ.get("SODT_TORCH_DATA_PATH")
    rec = {"phase": "rd_ltp", "checkpoint": "the rd phase's", "splits": {}}
    failures = []
    try:
        os.environ["SODT_TORCH_DATA_PATH"] = workdir
        for split in ("val", "traintail"):
            outs, walls = {}, {}
            for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
                args = vars(get_args([
                    "--config", "rd/sym_eq.cfg", "--load_laligan", rd_rec["save_dir"],
                    "--rd_eval_split", split,
                    "--eval_root", os.path.join(workdir, f"ltp-{side}")]))
                if side == "card":
                    reset_launches()
                with contextlib.redirect_stdout(io.StringIO()), (
                        cpu_threads() if side == "cpu" else contextlib.nullcontext()):
                    outs[side] = run(args, device=where)
                if side == "card":
                    launches = all_launches()
                walls[side] = outs[side]["seconds"]
            card, cpu = outs["card"], outs["cpu"]
            keys = ("rel_rollout", "rel_latent", "rel_recon", "pow_rollout", "pow_recon",
                    "z_pred", "z_true")
            rels = {k: _rel_max(card[k], cpu[k]) for k in keys}
            rec["splits"][split] = {
                "steps": int(card["rel_rollout"].shape[0]), "wall_s": walls["card"],
                "cpu_wall_s": walls["cpu"], "launches": launches, "rel_card_cpu": rels,
                "means": {k: float(card[k].mean()) for k in keys[:5]}}
            failures += [f"rd_ltp {split}: {k} {v} apart (limit {RD_LTP_REL})"
                         for k, v in rels.items() if not v <= RD_LTP_REL]
            if any(launches.values()):
                failures.append(f"rd_ltp {split}: a hand-written kernel launched: {launches}")
    finally:
        if saved_env is None:
            os.environ.pop("SODT_TORCH_DATA_PATH", None)
        else:
            os.environ["SODT_TORCH_DATA_PATH"] = saved_env
    rec["failures"] = failures
    emit_fn(rec)
    return rec


RD_POSTHOC_REL = 1e-4     # the post-hoc rd fit, card against CPU: Xi of its largest |Xi|,
                          # the residual relative
SELECTION_REL = 1e-4      # the selection criteria, card against CPU, relative
SELECTION_REG_ATOL = 1e-6  # the regularisers, absolute: reg_norm is 0.5 - |L|^2 near 0,
                           # f32's step at 0.5 is 6e-8


def rd_posthoc_phase(dev, rd_rec, workdir, emit_fn):
    """cli/rd_fit_latent_sindy.py::run on the checkpoint the rd phase
    trained (joint rd/sym_eq.cfg, its data in ``workdir``), on the card
    (launch counts 0 just before, read just after) and on the CPU: the
    least-squares fixpoint over all 158 train windows, the checkpoint
    written under ``workdir``. Gates: masks equal, at least one term kept,
    Xi within RD_POSTHOC_REL of its largest |Xi| and the residual within
    RD_POSTHOC_REL relative, no hand-written kernel."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.rd_fit_latent_sindy import run

    saved_env = os.environ.get("SODT_TORCH_DATA_PATH")
    rec = {"phase": "rd_posthoc", "checkpoint": "the rd phase's"}
    outs = {}
    try:
        os.environ["SODT_TORCH_DATA_PATH"] = workdir
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            if side == "card":
                reset_launches()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cpu_threads() if side == "cpu" else contextlib.nullcontext():
                outs[side] = run(rd_rec["save_dir"], device=where,
                                 save_root=os.path.join(workdir, f"posthoc-{side}"))
            if side == "card":
                torch.cuda.synchronize()
                rec["launches"] = all_launches()
            rec[f"{side}_wall_s"] = time.perf_counter() - t0
    finally:
        if saved_env is None:
            os.environ.pop("SODT_TORCH_DATA_PATH", None)
        else:
            os.environ["SODT_TORCH_DATA_PATH"] = saved_env
    card, cpu = outs["card"], outs["cpu"]
    rec.update(windows=card["windows"], resid=card["resid"], cpu_resid=cpu["resid"],
               Xi_masked=card["Xi_masked"].tolist(), terms=int(card["mask"].sum()),
               masks_equal=bool(np.array_equal(card["mask"], cpu["mask"])),
               Xi_rel_card_cpu=_rel_max(card["Xi"], cpu["Xi"]),
               resid_rel_card_cpu=abs(card["resid"] - cpu["resid"]) / abs(cpu["resid"]))
    failures = []
    if not rec["masks_equal"] or rec["terms"] < 1:
        failures.append(f"rd_posthoc: masks equal {rec['masks_equal']}, {rec['terms']} terms kept")
    for key in ("Xi_rel_card_cpu", "resid_rel_card_cpu"):
        if not rec[key] <= RD_POSTHOC_REL:
            failures.append(f"rd_posthoc: {key} {rec[key]} (limit {RD_POSTHOC_REL})")
    if any(rec["launches"].values()):
        failures.append(f"rd_posthoc: a hand-written kernel launched: {rec['launches']}")
    rec["failures"] = failures
    emit_fn(rec)
    return rec


def selection_phase(dev, x, emit_fn):
    """cli/symmetry_selection.py's criteria that read no eval_results file
    (the truth-equivariance penalty, displacement, discrim, AE recon and
    the regulariser terms) of saved_models/laligan-noise99-lv on the 4096
    points the CLI draws from the LV rows ``x`` (np.random.default_rng(0)),
    on the card (launch counts 0 just before, read just after) and on the
    CPU. Gates: each criterion within SELECTION_REL relative (the
    regularisers SELECTION_REG_ATOL absolute), all finite, no hand-written
    kernel."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli import symmetry_selection as sel

    t0 = time.perf_counter()
    pts = sel.held_out(x.cpu().numpy())
    rec = {"phase": "selection", "checkpoint": sel.BASE, "points": len(pts),
           "draw_s": time.perf_counter() - t0}
    crit = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        if side == "card":
            reset_launches()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cpu_threads() if side == "cpu" else contextlib.nullcontext():
            ae, spec, g_state = sel.load_model(sel.BASE, str(CKPT_ROOT), where)
            crit[side] = sel.criteria(ae, spec, g_state, torch.as_tensor(pts, device=where))
        if side == "card":
            torch.cuda.synchronize()
            rec["launches"] = all_launches()
        rec[f"{side}_wall_s"] = time.perf_counter() - t0
    del crit["card"]["sep"], crit["cpu"]["sep"]  # needs plain SINDy's sweep files
    rec["card"], rec["cpu"] = crit["card"], crit["cpu"]
    failures = []
    for k, v in crit["card"].items():
        want = crit["cpu"][k]
        if k in ("closure", "ortho", "norm"):
            ok = abs(v - want) <= SELECTION_REG_ATOL
        else:
            ok = abs(v - want) <= SELECTION_REL * abs(want)
        if not (ok and math.isfinite(v)):
            failures.append(f"selection: {k} {v} on the card, {want} on the CPU")
    if any(rec["launches"].values()):
        failures.append(f"selection: a hand-written kernel launched: {rec['launches']}")
    rec["failures"] = failures
    emit_fn(rec)
    return rec


def selkov_data(dev):
    """The selkov train split at noise 0.2 with GP smoothing (10 ICs x
    10,000 steps), generated on the card, as (100,000, 2) rows."""
    import torch

    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed

    sk = SYSTEMS["selkov"]
    gen = torch.Generator(device=dev).manual_seed(cache_seed("train", 0.2))
    x, dx = gen_data(sk, gen, noise=0.2, multiplicative_noise=sk.multiplicative_noise,
                     smoothing="gp", device=dev)
    if tuple(x.shape) != (10, 10000, 2) or not bool(torch.isfinite(x).all()
                                                   and torch.isfinite(dx).all()):
        raise RuntimeError(f"selkov: bad data {tuple(x.shape)}")
    return x.reshape(-1, 2), dx.reshape(-1, 2)


def _card_and_cpu(dev, args, train_data, tmp):
    """cli/main.py::run of ``args`` on the card (launch counts 0 just before,
    read just after) and on the CPU, on the same rows: (outputs by device
    type, walls, launches)."""
    import contextlib
    import io

    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import run

    outs, walls = {}, {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        a = dict(args, eval_root=os.path.join(tmp, f"eval-{side}"),
                 save_root=os.path.join(tmp, f"saved-{side}"))
        data = tuple(t.to(where) for t in train_data)
        if side == "card":
            reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), (
                cpu_threads() if side == "cpu" else contextlib.nullcontext()):
            outs[side] = run(dict(a), train_data=data, device=where, ckpt_root=str(CKPT_ROOT))
        if side == "card":
            launches = all_launches()
        walls[side] = time.perf_counter() - t0
    return outs, walls, launches


def adam_phase(dev, x, dx, emit_fn):
    """ADAM_STEPS Adam steps of selkov/noise20_eq_symreg.cfg with
    --sindy_optimizer adam (a copy of the config with it written in: the
    parser drops a flag equal to its default) through cli/main.py::run at
    full width (4 x 128, the tracked laligan-noise20-selkov, the composed
    symmreg_i), on the first ADAM_STEPS x 256 rows of the phase's selkov
    set, one epoch, the initial parameters and the permutation drawn on the
    CPU and fed to both runs. Gates: the coefficients within ADAM_REL of
    their largest magnitude, card against CPU; finite losses; no
    hand-written kernel."""
    import math

    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    rows = ADAM_STEPS * 256
    with tempfile.TemporaryDirectory() as tmp:
        text = (CKPT_ROOT.parent / "run_configs" / SELKOV_CONFIG).read_text()
        cfg_path = os.path.join(tmp, "adam.cfg")
        with open(cfg_path, "w") as f:
            f.write(text.replace("--sindy_optimizer lbfgs", "--sindy_optimizer adam"))
        gen = torch.Generator().manual_seed(0)
        theta0 = torch.randn(20, generator=gen).numpy()
        perm = torch.randperm(rows, generator=gen).numpy()
        draws = os.path.join(tmp, "draws.npz")
        np.savez(draws, seeds=np.array([0], np.int32), theta0=theta0[None],
                 perm=perm[None, None].astype(np.int32))
        args = vars(get_args(["--config", cfg_path, "--num_epochs", "1", "--seed", "0",
                              "--subsample_perms", draws]))
        if args["sindy_optimizer"] != "adam":
            raise RuntimeError("the adam phase's config did not select the Adam trainer")
        outs, walls, launches = _card_and_cpu(dev, args, (x[:rows], dx[:rows]), tmp)
    card, cpu = outs["card"], outs["cpu"]
    hist = card["history"]
    rec = {"phase": "adam", "config": SELKOV_CONFIG + " --sindy_optimizer adam",
           "steps": ADAM_STEPS, "batch_size": args["batch_size"], "width": [4, 128],
           "wall_s": walls["card"], "seed_s": card["seconds"], "cpu_wall_s": walls["cpu"],
           "launches": launches, "history": hist,
           "rel_card_cpu": _rel_max(card["coefficients"], cpu["coefficients"])}
    rec["failures"] = [f"adam: {m}" for m, bad in (
        (f"coefficients {rec['rel_card_cpu']} apart (limit {ADAM_REL})",
         not rec["rel_card_cpu"] <= ADAM_REL),
        (f"a non-finite loss {hist}", not all(math.isfinite(v) for h in hist
                                              for v in h.values())),
        (f"a hand-written kernel launched: {launches}", any(launches.values()))) if bad]
    emit_fn(rec)
    return rec


def latent_phase(dev, x, dx, emit_fn):
    """One --use_latent --distill_latent L-BFGS fit of
    selkov/noise20_eq_symreg.cfg through cli/main.py::run at full width
    (the tracked laligan-noise20-selkov), on LATENT_SUBSAMPLE of the phase's
    selkov rows, the config's 200 epochs, the subsample and both initial
    parameters drawn on the CPU and fed to the card's run (every launch
    count 0 just before, read just after) and the CPU's; then the CLI's
    chunk (cli/main.py::fit_latent_chunk) in float64 on the card and on the
    CPU. Gates: the float32 runs' latent and distilled masks equal; the
    float64 fits' masks equal, their latent coefficients within LATENT64_REL
    and distilled ones within LATENT_DST64_REL of their largest magnitude,
    card against CPU; no hand-written kernel. Recorded: the float32
    coefficient differences (the fixed-lr L-BFGS amplifies float32
    rounding; ROADMAP fault 12) and each side's float32 fit against its
    float64 one."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import build_fit, fit_latent_chunk
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    n = x.shape[0]
    k = int(n * LATENT_SUBSAMPLE)
    gen = torch.Generator().manual_seed(0)
    idx = torch.randperm(n, generator=gen)[:k]
    theta0 = torch.randn((1, 20), generator=gen)
    theta0_dst = torch.randn((1, 20), generator=gen)
    with tempfile.TemporaryDirectory() as tmp:
        draws = os.path.join(tmp, "draws.npz")
        np.savez(draws, seeds=np.array([0], np.int32), idx=idx[None].numpy().astype(np.int32),
                 theta0=theta0.numpy(), theta0_dst=theta0_dst.numpy())
        args = vars(get_args(["--config", SELKOV_CONFIG, "--use_latent", "--distill_latent",
                              "--lbfgs_subsample", str(LATENT_SUBSAMPLE), "--seed", "0",
                              "--subsample_perms", draws]))
        outs, walls, launches = _card_and_cpu(dev, args, (x, dx), tmp)
    coef = lambda o, tag="": o[f"{tag}Xi"] * o[f"{tag}mask"]
    f64 = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        with cpu_threads() if side == "cpu" else contextlib.nullcontext():
            a = dict(args)
            fit = build_fit(a, train_data=(x, dx), device=where, ckpt_root=str(CKPT_ROOT))
            lat, dst = fit_latent_chunk(a, fit, idx[None].to(where), theta0.to(where),
                                        theta0_dst.to(where), dtype=torch.float64)
        f64[side] = {"latent_": (lat.Xi * lat.mask).cpu().numpy(),
                     "latent_mask": lat.mask.cpu().numpy(),
                     "": (dst.Xi * dst.mask).cpu().numpy(), "mask": dst.mask.cpu().numpy(),
                     "wall_s": time.perf_counter() - t0}

    def agree(a, b, ca, cb):
        return {"latent_masks_equal": bool(np.array_equal(a["latent_mask"], b["latent_mask"])),
                "latent_rel": _rel_max(ca(a, "latent_"), cb(b, "latent_")),
                "distilled_masks_equal": bool(np.array_equal(a["mask"], b["mask"])),
                "distilled_rel": _rel_max(ca(a), cb(b))}

    card, cpu = outs["card"], outs["cpu"]
    c64 = lambda o, tag="": o[tag]
    rec = {"phase": "latent", "config": SELKOV_CONFIG + " --use_latent --distill_latent",
           "rows": k, "epochs": args["num_epochs"], "wall_s": walls["card"],
           "cpu_wall_s": walls["cpu"], "launches": launches,
           "float32": agree(card, cpu, coef, coef),
           "float64": dict(agree(f64["card"], f64["cpu"], c64, c64),
                           wall_s=f64["card"]["wall_s"], cpu_wall_s=f64["cpu"]["wall_s"]),
           "float32_vs_float64": {side: agree(outs[side], f64[side], coef, c64)
                                  for side in ("card", "cpu")},
           "active_terms": int(card["mask"].sum()),
           "correct_form": np.asarray(card["correct_form"]).tolist()}
    r32, r64 = rec["float32"], rec["float64"]
    rec["failures"] = [f"latent: {m}" for m, bad in (
        ("card and CPU float32 latent masks differ", not r32["latent_masks_equal"]),
        ("card and CPU float32 distilled masks differ", not r32["distilled_masks_equal"]),
        ("card and CPU float64 latent masks differ", not r64["latent_masks_equal"]),
        ("card and CPU float64 distilled masks differ", not r64["distilled_masks_equal"]),
        (f"float64 latent coefficients {r64['latent_rel']} apart (limit {LATENT64_REL})",
         not r64["latent_rel"] <= LATENT64_REL),
        (f"float64 distilled coefficients {r64['distilled_rel']} apart "
         f"(limit {LATENT_DST64_REL})", not r64["distilled_rel"] <= LATENT_DST64_REL),
        (f"a hand-written kernel launched: {launches}", any(launches.values()))) if bad]
    emit_fn(rec)
    return rec


# the multi-device phases (parallel/): their shards and ranks, and gates
MESH_SYMREG_EPOCHS = 5    # the sharded EquivSINDy-r chunk: its first epochs
MESH_GP_GENERATIONS = 5   # the sharded GP chunk's generations
GP_MESH_REL = 1e-4        # sharded GP: best_fit and constants against one device
DP_RTOL, DP_ATOL = 5e-3, 1e-5   # data-parallel epoch means against one device
DP_PARAM_REL = 0.02       # the autoencoder's parameters and BatchNorm statistics
DP_SINDY_RTOL = 5e-2      # the joint path's loss_sindy_z
DP_F64_REL = 1e-6         # in float64: data parallel against one device, exactly
# The adversarial dynamics amplify any rounding difference batch by batch:
# in float64 a whole LV epoch (243 batches) carried data parallel and one
# device 6e-4 apart in the epoch means on one H100 (PERF.md), so float64 is
# held to tests/test_dp_lassi.py's bars over the whole run, to DP_F64_REL
# over its last epoch's first DP_F64_EXACT_BATCHES batches (the per-batch
# metrics), and, where the run is short, over the whole run
DP_F64_EXACT_BATCHES = 9
# the data-parallel runs: (name, config, epochs, whether the whole float64
# run is held to DP_F64_REL; LV on its trajectories, rd on the rd data)
DP_RUNS = (("lv", "lv/noise99_sym.cfg", 1, False), ("rd", "rd/sym_eq.cfg", 3, True))
# the LV runs' trajectories: the first 50 of the 200 (60 of the epoch's
# 243 batches), so that the smoke run keeps within its budget
DP_LV_ICS = 50


# the launch counters' keys of the kernels line's names where they differ
SYMMPEN_COUNTERS = {"symmpen_enc_fwd": "enc_fwd", "symmpen_enc_bwd": "enc_bwd",
                    "symmpen_dec_jvp": "dec_jvp", "symmpen_dec_jvp_bwd": "dec_jvp_bwd"}


def launch_key(name: str) -> str:
    """The launch counter's key of the kernels line's kernel ``name``."""
    base = name.removesuffix("_bf16")
    return SYMMPEN_COUNTERS.get(base, base) + name[len(base):]


def shard_devices(dev, n):
    """``n`` devices for the shards or ranks of the multi-device phases:
    the first n CUDA devices where the machine has them, else ``dev``
    repeated (several shards on one card), and which it was."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], f"{n} distinct GPUs"
    return [dev] * n, f"{dev} repeated {n} times (one GPU)"


def _same_sweep(a, b) -> int:
    """Seeds of two SweepResults not bit-equal (Xi, mask, form, MSE)."""
    import numpy as np

    same = np.ones(a.Xi.shape[0], bool)
    for x, y in ((a.Xi, b.Xi), (a.mask, b.mask), (a.correct_form, b.correct_form),
                 (a.mse, b.mse)):
        same &= np.array([np.array_equal(x[i], y[i], equal_nan=True) for i in range(len(x))])
    return int((~same).sum())


def mesh_phase(dev, xs, dxs, xg, dxg, res_lv, res_g, x99, dx99, emit_fn):
    """Seed sharding (parallel/mesh.py), each part with every launch count
    set to 0 just before and read just after: path 1 (the stacked LV sweep,
    550 lanes, and the growth EquivSINDy-c sweep, 50) on a 2-shard mesh
    against path 1's unsharded results, lane for lane bit for bit; the
    EquivSINDy-r chunk (4 seeds, full width, K2-K4) for its first
    MESH_SYMREG_EPOCHS epochs through cli/main.py::run on a 2-shard mesh
    (2 x 2 lanes) and unsharded, masks equal, and bit-equal to one device in
    chunks of 2 seeds (the unsharded run twice, its repeat's bit-equality
    recorded); the plain GP leg's 10-seed
    chunk (20 units) for MESH_GP_GENERATIONS generations on a 4-shard mesh
    and unsharded (symgp/sweep.py on the CLI's rows), tapes identical and
    best_fit within GP_MESH_REL."""
    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli import main_gp
    from symmetry_ode_discovery_tpu_torch.cli.main import run
    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.parallel.mesh import Mesh
    from symmetry_ode_discovery_tpu_torch.symgp.sweep import gp_sweep_plain
    from symmetry_ode_discovery_tpu_torch.training.sweep import (
        sweep_sindy_lbfgs, sweep_sindy_lbfgs_stacked)

    devs2, how2 = shard_devices(dev, 2)
    devs4, how4 = shard_devices(dev, 4)
    mesh2, mesh4 = Mesh(devs2), Mesh(devs4)
    rec = {"phase": "mesh", "shards_2": how2, "shards_4": how4}
    cfg_lv, hp_lv, cfg_g, Q_g, hp_g = path1_configs()

    def timed(fn):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, all_launches()

    lv, wall_lv, n_lv = timed(lambda: sweep_sindy_lbfgs_stacked(
        cfg_lv, None, xs, dxs, sindy_truth["lv"], hp_lv, SEEDS, lbfgs_subsample=0.01,
        device=dev, mesh=mesh2))
    g, wall_g, n_g = timed(lambda: sweep_sindy_lbfgs(
        cfg_g, Q_g, xg, dxg, sindy_truth["growth"], hp_g, SEEDS, lbfgs_subsample=0.5,
        device=dev, mesh=mesh2))
    rec["path1"] = {"lv_lanes": len(SEEDS) * len(xs), "growth_lanes": len(SEEDS),
                    "lv_lanes_not_bit_equal": sum(_same_sweep(a, b) for a, b in zip(lv, res_lv)),
                    "growth_lanes_not_bit_equal": _same_sweep(g, res_g),
                    "lv_wall_s": wall_lv, "growth_wall_s": wall_g,
                    "launches": n_lv["lbfgs_sweep"] + n_g["lbfgs_sweep"]}

    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        # unsharded twice (is the chunk deterministic?), and in chunks of a
        # shard's lanes (the sharded run's batched products, one device)
        for tag, mesh, chunk in (("sharded", mesh2, SYMREG_SEEDS),
                                 ("unsharded", None, SYMREG_SEEDS),
                                 ("unsharded_again", None, SYMREG_SEEDS),
                                 ("unsharded_shard_chunks", None, SYMREG_SEEDS // mesh2.size)):
            args = symreg_args(["--n_seeds", str(SYMREG_SEEDS), "--seed_chunk", str(chunk),
                                "--num_epochs", str(MESH_SYMREG_EPOCHS),
                                "--eval_root", os.path.join(tmp, tag)])
            outs[tag] = timed(lambda: run(args, train_data=(x99, dx99), device=dev,
                                          ckpt_root=str(CKPT_ROOT), mesh=mesh))
    (sh, wall_sh, n_sh), (un, wall_un, _) = outs["sharded"], outs["unsharded"]
    same = lambda a, b: bool(np.array_equal(a["Xi"], b["Xi"]) and np.array_equal(
        a["mask"], b["mask"]) and a["stop_epoch"] == b["stop_epoch"])
    rec["symreg"] = {"seeds": SYMREG_SEEDS, "epochs": MESH_SYMREG_EPOCHS,
                     "masks_equal": bool(np.array_equal(sh["mask"], un["mask"])),
                     "max_coef_diff": float(np.abs(sh["Xi"] - un["Xi"]).max()),
                     "unsharded_repeat_bit_equal": same(outs["unsharded_again"][0], un),
                     "shard_chunks_bit_equal": same(sh, outs["unsharded_shard_chunks"][0]),
                     "finite": bool(np.isfinite(sh["Xi"]).all()),
                     "wall_s": wall_sh, "unsharded_wall_s": wall_un,
                     "unsharded_shard_chunks_wall_s": outs["unsharded_shard_chunks"][1],
                     "launches": n_sh}

    n_seeds = GP_SEEDS["plain"]
    args = gp_args("plain", ["--n_seeds", str(n_seeds), "--gp_generations",
                             str(MESH_GP_GENERATIONS)])
    args["input_dim"] = 2
    seeds = list(range(n_seeds))
    X, dX, _, _ = main_gp.chunk_rows(args, x99, dx99, seeds, None, dev)
    spec, cfg = main_gp._task_spec("lv", 2), main_gp.gp_config(args, 0)
    kw = dict(select=args.get("gp_select", "penalized"), device=dev)
    (ps, r4), wall4, n_gp = timed(lambda: gp_sweep_plain(X, dX, spec, cfg, seeds, mesh=mesh4,
                                                         **kw))
    (p1, r1), wall1, _ = timed(lambda: gp_sweep_plain(X, dX, spec, cfg, seeds, **kw))
    flat = lambda p: [b for s in p for b in s]
    tapes_differ = sum(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
                       for a, b in zip(flat(ps), flat(p1)))
    consts = max(float(np.abs(a[2] - b[2]).max() / max(np.abs(b[2]).max(), 1e-30))
                 for a, b in zip(flat(ps), flat(p1)))
    rec["gp"] = {"seeds": n_seeds, "units": len(r4.best_fit), "shards": mesh4.size,
                 "padding_units": (-len(r4.best_fit)) % mesh4.size,
                 "generations": MESH_GP_GENERATIONS, "tapes_differ": tapes_differ,
                 "consts_max_rel": consts,
                 "best_fit_max_rel": float(np.max(np.abs(r4.best_fit - r1.best_fit)
                                                  / np.maximum(np.abs(r1.best_fit), 1e-30))),
                 "best_fit_finite": bool(np.isfinite(r4.best_fit).all()),
                 "wall_s": wall4, "unsharded_wall_s": wall1, "launches": n_gp,
                 "device_s_per_gen": float(np.mean(r4.device_s)),
                 "host_s_per_gen": float(np.mean(r4.host_s))}
    f = []
    p1r = rec["path1"]
    if p1r["lv_lanes_not_bit_equal"] or p1r["growth_lanes_not_bit_equal"]:
        f.append(f"mesh: sharded path 1 lanes not bit-equal to the unsharded launch: "
                 f"{p1r['lv_lanes_not_bit_equal']} LV, {p1r['growth_lanes_not_bit_equal']} growth")
    if p1r["launches"] != 2 * mesh2.size:
        f.append(f"mesh: path 1 made {p1r['launches']} K1 launches, expected {2 * mesh2.size}")
    s = rec["symreg"]
    if not s["masks_equal"] or not s["finite"] or not s["shard_chunks_bit_equal"]:
        f.append(f"mesh: the sharded EquivSINDy-r chunk's masks equal {s['masks_equal']}, "
                 f"finite {s['finite']}, bit-equal to one device in chunks of a shard's "
                 f"lanes {s['shard_chunks_bit_equal']}")
    for fn in (*SYMMPEN_COUNTERS, "lbfgs_dir"):
        if s["launches"][launch_key(fn)] < 1:
            f.append(f"mesh: the sharded EquivSINDy-r chunk launched no {fn} kernel")
    gp = rec["gp"]
    if gp["tapes_differ"] or not gp["consts_max_rel"] <= GP_MESH_REL \
            or not gp["best_fit_max_rel"] <= GP_MESH_REL or not gp["best_fit_finite"]:
        f.append(f"mesh: the sharded GP chunk: {gp['tapes_differ']} tapes differ, constants "
                 f"{gp['consts_max_rel']} and best_fit {gp['best_fit_max_rel']} from one "
                 f"device's (limit {GP_MESH_REL}), finite {gp['best_fit_finite']}")
    for fn in ("tape_eval", "tape_grad"):
        if gp["launches"][fn] < 1:
            f.append(f"mesh: the sharded GP chunk launched no {fn} kernel")
    rec["failures"] = f
    emit_fn(rec)
    return rec


def _dp_compare(single: dict, other: dict) -> dict:
    """A LaLiGAN run against the single-device one from the same seed: the
    epoch means (the largest relative difference, and over the DP bar), the
    autoencoder's parameters and BatchNorm statistics (relative L2 over all
    tensors), the joint mask and loss_sindy_z."""
    import numpy as np

    sd = {k: v.detach().cpu().double().numpy()
          for k, v in single["trainer"].ae.state_dict().items()}
    got = other["state"]["ae"] if "state" in other else {
        k: v.detach().cpu().double().numpy() for k, v in other["trainer"].ae.state_dict().items()}

    def rel(keep):
        keys = [k for k in sd if keep(k) and not k.endswith("num_batches_tracked")]
        a = np.concatenate([sd[k].ravel() for k in keys])
        b = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in keys])
        return float(np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30))

    pairs = [(h1[k], h2[k]) for h1, h2 in zip(single["history"], other["history"]) for k in h1]
    out = {"epoch_means_max_rel": max(abs(b - a) / max(abs(a), 1e-30) for a, b in pairs),
           "epoch_means_over_bar": max(abs(b - a) / (DP_ATOL + DP_RTOL * abs(a))
                                       for a, b in pairs),
           "ae_rel_l2": rel(lambda k: "running" not in k),
           "bn_stats_rel_l2": rel(lambda k: "running" in k),
           "finite": all(np.isfinite(v) for h in other["history"] for v in h.values())}
    sindy = single["trainer"].sindy
    if sindy is not None:
        mask = (other["state"]["sindy"]["mask"] if "state" in other
                else other["trainer"].sindy["mask"].cpu().numpy())
        out["mask_equal"] = bool(np.array_equal(sindy["mask"].cpu().numpy(), mask))
        out["loss_sindy_z_max_rel"] = max(
            abs(h2["loss_sindy_z"] - h1["loss_sindy_z"]) / max(abs(h1["loss_sindy_z"]), 1e-30)
            for h1, h2 in zip(single["history"], other["history"]))
    out["dp_test_bars_met"] = bool(
        out["epoch_means_over_bar"] <= 1.0 and out["ae_rel_l2"] <= DP_PARAM_REL
        and out["bn_stats_rel_l2"] <= DP_PARAM_REL if sindy is None else
        out["mask_equal"] and out["loss_sindy_z_max_rel"] <= DP_SINDY_RTOL)
    return out


def _batch_gaps(single: list, other: list):
    """Per batch of the last epoch (from each run's per-batch metrics, one
    dict a epoch), the largest relative difference of any metric between
    the two runs."""
    import numpy as np

    a, b = single[-1], other[-1]
    return np.max([np.abs(np.asarray(b[k], np.float64) - np.asarray(a[k], np.float64))
                   / np.maximum(np.abs(np.asarray(a[k], np.float64)), 1e-30) for k in a], axis=0)


def _dp_jobs(dp, device, jobs) -> list:
    """The data-parallel trainings ``jobs`` ((args, train_data, dtype) each)
    one after another in one rank, each as run_lassi_dp runs it in its
    processes (cli/main.py::_lassi_rank), with its all-reduces and its wall
    (rank 0's, spawn excluded)."""
    from symmetry_ode_discovery_tpu_torch.cli.main import _lassi_rank

    out = []
    for args, data, dtype in jobs:
        dp.all_reduces = 0
        t0 = time.perf_counter()
        out.append(dict(_lassi_rank(dp, device, args, data, None, dtype),
                        wall_s=time.perf_counter() - t0))
    return out


def dp_phase(dev, x, dx, rd_dir, emit_fn):
    """Data-parallel LaLiGAN training (parallel/dp.py) on 2 ranks (NCCL when
    they have cards of their own, gloo when they share one) against the
    single-device CLI (cli/main.py::run_lassi) from the same seed (the same
    init and draws): one epoch of lv/noise99_sym.cfg at full width (5 x 512,
    batch 8192) on the first DP_LV_ICS of the LV trajectories x, dx, and three epochs
    of rd/sym_eq.cfg (the joint least-squares path) on the rd phase's data
    in ``rd_dir``; each also in float64 (the same init and draws widened).
    The four data-parallel trainings are run_lassi_dp's ranks
    (cli/main.py::_lassi_rank) in one launch of parallel/dp.py::launch: a
    launch costs a spawn and the new processes' warm-up, 15-20 s on the
    card's machine. Gated in float64: the whole run within
    tests/test_dp_lassi.py's bars (on lv epoch means within DP_RTOL and
    DP_ATOL, the autoencoder's parameters and BatchNorm statistics within
    DP_PARAM_REL; on rd the mask equal and loss_sindy_z within
    DP_SINDY_RTOL), the last epoch's first DP_F64_EXACT_BATCHES batches'
    metrics within DP_F64_REL, and on rd the whole run within DP_F64_REL.
    Recorded: the float64 per-batch gap curve; the float32 runs against the
    same bars beside the single-device float32 run's distance from float64,
    since a float32 run's rounding, amplified by the adversarial and joint
    dynamics (ROADMAP faults 8 and 13), misses them."""
    import contextlib
    import io

    import numpy as np
    import torch

    from symmetry_ode_discovery_tpu_torch.cli.main import run_lassi
    from symmetry_ode_discovery_tpu_torch.parallel.dp import backend_for, launch
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    devs, how = shard_devices(dev, 2)
    rec = {"phase": "dp", "ranks": how, "backend": backend_for(devs)}
    xt, dxt = x.reshape(200, -1, 2)[:DP_LV_ICS], dx.reshape(200, -1, 2)[:DP_LV_ICS]
    dtypes = (("f32", torch.float32), ("f64", torch.float64))
    saved_env = os.environ.get("SODT_TORCH_DATA_PATH")
    os.environ["SODT_TORCH_DATA_PATH"] = rd_dir  # the rd runs' data, in every rank too
    single, jobs = {}, []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, config, epochs, _ in DP_RUNS:
                data = (xt, dxt) if name == "lv" else None
                # one copy for both dtypes' jobs: pickled once a rank
                data_np = None if data is None else tuple(t.cpu().numpy() for t in data)
                args = lambda sub: vars(get_args([
                    "--config", config, "--num_epochs", str(epochs), "--save_interval", "0",
                    "--log_interval", "1000", "--save_root", os.path.join(tmp, name + sub)]))
                for tag, dtype in dtypes:
                    batches = []
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        out = run_lassi(args("single" + tag), data, dev, dtype=dtype,
                                        batch_hook=lambda e, pb: batches.append(
                                            {k: v.cpu().numpy() for k, v in pb.items()}))
                    torch.cuda.synchronize()
                    single[name, tag] = dict(out, batches=batches,
                                             wall_s=time.perf_counter() - t0)
                    jobs.append((args("dp" + tag), data_np, dtype))
            t0 = time.perf_counter()
            outs = launch(_dp_jobs, devs, args=(jobs,))
            rec["launch_wall_s"] = time.perf_counter() - t0
    finally:
        if saved_env is None:
            os.environ.pop("SODT_TORCH_DATA_PATH", None)
        else:
            os.environ["SODT_TORCH_DATA_PATH"] = saved_env
    outs = iter(outs)
    for name, config, epochs, _ in DP_RUNS:
        dp = {tag: next(outs) for tag, _ in dtypes}
        one = {tag: single[name, tag] for tag, _ in dtypes}
        trainer = one["f32"]["trainer"]
        n = trainer.steps_per_epoch
        gaps = _batch_gaps(one["f64"]["batches"], dp["f64"]["batches"])
        rec[name] = {
            "config": config, "epochs": epochs, "batch_size": trainer.hp.batch_size,
            "batches_per_epoch": n,
            **{f"{kind}_{tag}_wall_s": runs[tag]["wall_s"]
               for kind, runs in (("single", one), ("dp", dp)) for tag, _ in dtypes},
            "dp_epoch_walls_s": dp["f32"]["walls"],
            "all_reduces_per_batch": dp["f32"]["all_reduces"] / (n * epochs),
            "f32": _dp_compare(one["f32"], dp["f32"]),
            "f64": _dp_compare(one["f64"], dp["f64"]),
            "f64_exact_batches_max_rel": float(np.max(gaps[:DP_F64_EXACT_BATCHES])),
            # the last epoch's per-batch gap at batches 0, 1, 2, 4, ..., and its last
            "f64_batch_gaps": {str(b): float(gaps[b]) for b in sorted(
                {0, len(gaps) - 1} | {2 ** i for i in range(len(gaps).bit_length())
                                      if 2 ** i < len(gaps)})},
            "single_f32_vs_f64": _dp_compare(one["f64"], one["f32"]),
            "history_single_f32": one["f32"]["history"],
            "history_dp_f32": dp["f32"]["history"]}
    f = []
    for name, _, _, whole_exact in DP_RUNS:
        r, exact = rec[name]["f64"], rec[name]["f64_exact_batches_max_rel"]
        worst = max(r["epoch_means_max_rel"], r["ae_rel_l2"], r["bn_stats_rel_l2"])
        if not r["finite"] or not r["dp_test_bars_met"]:
            f.append(f"dp {name}: in float64 the data-parallel run misses "
                     f"tests/test_dp_lassi.py's bars against one device's: {r}")
        if not exact <= DP_F64_REL or (whole_exact and not worst <= DP_F64_REL):
            f.append(f"dp {name}: in float64 the data-parallel run's first "
                     f"{DP_F64_EXACT_BATCHES} batches lie {exact} from one device's, the whole "
                     f"run {worst} (limit {DP_F64_REL}{'' if whole_exact else ' on the batches'})")
        if not rec[name]["f32"]["finite"]:
            f.append(f"dp {name}: a non-finite float32 epoch mean")
    rec["failures"] = f
    emit_fn(rec)
    return rec


LINESEARCH_EPOCHS = 3       # the zoom EquivSINDy-r chunk's epochs
LINESEARCH_MASK_SHARE = 0.96  # growth: seeds whose masks equal the CPU run's (48 of 50)
LINESEARCH_F64_REL = 1e-6   # growth in float64: card against CPU, of the largest coefficient


def _linesearch_chunk(dev, x, dx, pallas: bool):
    """LINESEARCH_EPOCHS epochs of the EquivSINDy-r chunk (SYMREG_SEEDS
    seeds, SYMREG_ROWS rows each, full width) through make_lbfgs_stepper
    with linesearch=True and dir_backend 'pallas' (which the line search
    ignores): K2/K3 (``pallas``) or the plain f32 chains. Returns (Xi, mask,
    every epoch's parameters finite)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.training.siged import (
        LBFGSHParams, _make_param_fns, make_lbfgs_stepper)
    from symmetry_ode_discovery_tpu_torch.training.sweep import _init_theta, _subsample_idx
    from symmetry_ode_discovery_tpu_torch.training.symmreg import make_symmreg_i_fast

    args, ae, spec, g_state = flagship_models(dev)
    cfg, Q = make_config(2, poly_order=2, include_exp=True, threshold=args["threshold"])
    hp = LBFGSHParams(num_epochs=LINESEARCH_EPOCHS, lr_sindy=args["lr_sindy"],
                      w_sindy_x=args["w_sindy_x"], w_sindy_reg=args["w_sindy_reg"],
                      w_sym_reg=args["w_sym_reg"], st_freq=args["st_freq"],
                      threshold=args["threshold"], dir_backend="pallas", linesearch=True)
    prep, pen = make_symmreg_i_fast(ae, spec, g_state, args["int_t"], args["int_dt"],
                                    pallas=pallas, fused_rollout_lib=cfg.library)
    init, step, extract = make_lbfgs_stepper(cfg, Q, hp, pen, prep, epochs_per_call=1)
    seeds = list(range(SYMREG_SEEDS))
    idx = _subsample_idx(seeds, x.shape[0], SYMREG_ROWS, dev)
    carry = init(x[idx], dx[idx], _init_theta(seeds, _make_param_fns(cfg, Q)[0], dev))
    finite = True
    for e in range(LINESEARCH_EPOCHS):
        carry = step(carry, e)
        finite = finite and bool(torch.isfinite(carry["params"]).all())
    Xi, mask = extract(carry)
    return Xi.detach(), mask, finite


def linesearch_phase(dev, xg, dxg, x99, dx99, emit_fn):
    """The zoom line-search L-BFGS (LBFGSHParams(linesearch=True)):
    (a) path 1's growth leg (50 seeds, EquivSINDy-c) through
    sweep_sindy_lbfgs with every launch count 0 first (K1 runs the fixed-lr
    protocol only, so none may launch), against the same call on the CPU on
    the same draws, and in float64 on both; (b) the EquivSINDy-r chunk for
    LINESEARCH_EPOCHS epochs with K2/K3 in every trial of the search,
    against the same run with the plain f32 chains. Walls by
    utils/profiling.timed. Returns the record with its failures."""
    import dataclasses

    import numpy as np

    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir, lbfgs_sweep, symmpen
    from symmetry_ode_discovery_tpu_torch.training.siged import _make_param_fns
    from symmetry_ode_discovery_tpu_torch.training.sweep import (
        _init_theta, _subsample_idx, sweep_sindy_lbfgs)
    from symmetry_ode_discovery_tpu_torch.utils.profiling import timed

    _, _, cfg_g, Q_g, hp_g = path1_configs()
    hp = dataclasses.replace(hp_g, linesearch=True)
    walls, failures = {}, []
    # the card's per-seed draws, fed to every run: a CPU generator draws
    # other rows and other theta0
    idx = _subsample_idx(SEEDS, xg.shape[0], int(xg.shape[0] * 0.5), dev).cpu().numpy()
    theta0 = _init_theta(SEEDS, _make_param_fns(cfg_g, Q_g)[0], dev).cpu().numpy()

    def growth(x, dx, device):
        return sweep_sindy_lbfgs(cfg_g, Q_g, x, dx, sindy_truth["growth"], hp, SEEDS,
                                 lbfgs_subsample=0.5, subsample_idx=idx, theta0=theta0,
                                 device=device)

    with contextlib.redirect_stdout(io.StringIO()):  # timed's and the sweeps' lines
        reset_launches()
        with timed("growth_card_s", walls):
            card = growth(xg, dxg, dev)
        growth_launches = {"lbfgs_sweep": lbfgs_sweep.launches, "lbfgs_dir": lbfgs_dir.launches}
        with timed("growth_cpu_s", walls):
            cpu = growth(xg.cpu(), dxg.cpu(), "cpu")
        with timed("growth_float64_card_s", walls):
            card64 = growth(xg.double(), dxg.double(), dev)
        with timed("growth_float64_cpu_s", walls):
            cpu64 = growth(xg.double().cpu(), dxg.double().cpu(), "cpu")
        reset_launches()
        with timed("chunk_kernels_s", walls):
            xi_k, mask_k, finite_k = _linesearch_chunk(dev, x99, dx99, pallas=True)
        chunk_launches = dict(symmpen.launches, lbfgs_dir=lbfgs_dir.launches,
                              lbfgs_sweep=lbfgs_sweep.launches)
        with timed("chunk_plain_s", walls):
            xi_p, mask_p, finite_p = _linesearch_chunk(dev, x99, dx99, pallas=False)

    same = lambda a, b: [bool(np.array_equal(a.mask[i], b.mask[i])) for i in range(len(SEEDS))]
    masks_equal = int(sum(same(card, cpu)))
    masks_equal64 = int(sum(same(card64, cpu64)))
    scale64 = float(np.abs(cpu64.Xi * cpu64.mask).max())
    rel64 = float(np.abs(card64.Xi * card64.mask - cpu64.Xi * cpu64.mask).max()) / scale64
    closures = chunk_launches["enc_fwd"]
    iterations = LINESEARCH_EPOCHS * hp.inner_iters
    chunk_masks_equal = bool((mask_k == mask_p).all())
    gap = float((xi_k * mask_k - xi_p * mask_p).abs().max())
    rec = {"phase": "linesearch", "walls": walls,
           "growth": {"seeds": len(SEEDS), "launches": growth_launches,
                      "masks_equal_cpu": masks_equal,
                      "joint_success": int(np.all(card.correct_form > 0, axis=1).sum()),
                      "joint_success_cpu": int(np.all(cpu.correct_form > 0, axis=1).sum()),
                      "float64_masks_equal_cpu": masks_equal64,
                      "float64_max_rel_diff_cpu": rel64,
                      "finite": bool(np.isfinite(card.Xi).all() and np.isfinite(card64.Xi).all())},
           "chunk": {"seeds": SYMREG_SEEDS, "rows": SYMREG_ROWS, "epochs": LINESEARCH_EPOCHS,
                     "launches": chunk_launches, "closures": closures,
                     "closures_per_iteration": closures / iterations,
                     "finite": finite_k and finite_p,
                     "masks_equal_plain_chains": chunk_masks_equal,
                     "max_coef_gap_plain_chains": gap}}
    if growth_launches["lbfgs_sweep"] or growth_launches["lbfgs_dir"]:
        failures.append(f"linesearch growth leg launched {growth_launches}")
    if masks_equal < LINESEARCH_MASK_SHARE * len(SEEDS):
        failures.append(f"linesearch growth leg: masks equal to the CPU run's on {masks_equal} "
                        f"of {len(SEEDS)} seeds (limit {LINESEARCH_MASK_SHARE} of them)")
    if masks_equal64 != len(SEEDS) or not rel64 <= LINESEARCH_F64_REL:
        failures.append(f"linesearch growth leg in float64: masks equal on {masks_equal64} "
                        f"seeds, coefficients {rel64} of the largest from the CPU's (limit "
                        f"{LINESEARCH_F64_REL})")
    if not rec["growth"]["finite"]:
        failures.append("linesearch growth leg: non-finite coefficients")
    for fn in ("enc_fwd", "enc_bwd", "dec_jvp", "dec_jvp_bwd"):
        if chunk_launches[fn] < 1:
            failures.append(f"linesearch chunk: no {fn} launch inside the zoom search")
    if chunk_launches["lbfgs_dir"] or chunk_launches["lbfgs_sweep"]:
        failures.append(f"linesearch chunk launched K4 or K1: {chunk_launches}")
    if not (finite_k and finite_p):
        failures.append("linesearch chunk: non-finite parameters")
    if not chunk_masks_equal:
        failures.append("linesearch chunk: masks differ from the plain chains' run")
    rec["failures"] = failures
    emit_fn(rec)
    return rec


# the subprocesses load utils/watchdog.py from its file, without the package
# (whose import loads torch): only the recovered relaunch imports torch
WATCHDOG_PRELUDE = """\
import importlib.util, os, sys, time
spec = importlib.util.spec_from_file_location("watchdog", %(path)r)
watchdog = importlib.util.module_from_spec(spec)
spec.loader.exec_module(watchdog)
"""

WATCHDOG_STALL_ONCE = WATCHDOG_PRELUDE + """\
if os.environ.get("SODT_WATCHDOG_RETRIED"):
    import torch  # the relaunch reaches the card

def work():
    if not os.environ.get("SODT_WATCHDOG_RETRIED"):
        time.sleep(120)  # the first launch stalls
    return watchdog.probe_first_dispatch(device="cuda")

print("RECOVERED", watchdog.run_with_watchdog(work, timeout_s=%(timeout)s))
"""

WATCHDOG_STALL_TWICE = WATCHDOG_PRELUDE + """\
watchdog.run_with_watchdog(lambda: time.sleep(120), timeout_s=%(timeout)s)
"""

WATCHDOG_HEARTBEAT = WATCHDOG_PRELUDE + """\
if "--resume" in sys.argv:
    print("RESUMED")
    sys.exit(0)
watchdog.start_heartbeat(timeout_s=%(timeout)s, extra_argv=["--resume"], poll_s=0.1)
time.sleep(120)  # no beat
"""
WATCHDOG_TIMEOUT_S = 1.0     # the subprocesses' watchdog window
WATCHDOG_WAIT_S = 90.0       # each subprocess's own limit


def watchdog_phase(dev, emit_fn, during=None):
    """utils/watchdog.py: the probe on the card in this process (its 32 MB
    copy time above 0), then three subprocesses started together: a first
    launch that stalls and a relaunch that recovers and probes the card, a
    second stall that exits 42, and an unfed heartbeat that relaunches with
    --resume. Each subprocess is killed at WATCHDOG_WAIT_S. ``during()``,
    when given, runs in this process while they do (they wait on their
    watchdogs and on torch's import). Returns (the record with its
    failures, during's result)."""
    import subprocess
    import sys

    from symmetry_ode_discovery_tpu_torch.utils import watchdog
    from symmetry_ode_discovery_tpu_torch.utils.watchdog import (
        STALL_EXIT_CODE, probe_first_dispatch)

    t0 = time.perf_counter()
    probe_s = probe_first_dispatch(device=dev)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SODT_WATCHDOG")
           and k != "SODT_NO_WATCHDOG"}
    cases = {"stall_once": (WATCHDOG_STALL_ONCE, {}),
             "stall_twice": (WATCHDOG_STALL_TWICE, {"SODT_WATCHDOG_RETRIED": "1"}),
             "heartbeat": (WATCHDOG_HEARTBEAT, {})}
    out, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (src, extra) in cases.items():
            path = os.path.join(tmp, name + ".py")
            with open(path, "w") as f:
                f.write(src % {"timeout": WATCHDOG_TIMEOUT_S, "path": watchdog.__file__})
            with open(path + ".out", "w") as so, open(path + ".err", "w") as se:
                procs[name] = subprocess.Popen([sys.executable, path], env=dict(env, **extra),
                                               stdout=so, stderr=se, start_new_session=True)
        result = during() if during is not None else None
        for name, p in procs.items():
            try:
                p.wait(timeout=max(1.0, WATCHDOG_WAIT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, 9)
                p.wait()
            path = os.path.join(tmp, name + ".py")
            out[name] = {"rc": p.returncode,
                         "stdout": open(path + ".out").read().strip()[-300:],
                         "stderr": open(path + ".err").read().strip()[-300:]}
    # wall_s: from the probe to the last subprocess's end, during() included
    rec = {"phase": "watchdog", "probe_s": probe_s, "wall_s": time.perf_counter() - t0,
           "overlapped": during is not None, "cases": out}
    if not probe_s > 0.0:
        failures.append(f"watchdog: the probe's copy took {probe_s} s on {dev}")
    once = out["stall_once"]
    if once["rc"] != 0 or "RECOVERED" not in once["stdout"] \
            or "relaunching self once" not in once["stderr"]:
        failures.append(f"watchdog: a stalled first launch did not recover on the relaunch: "
                        f"{once}")
    else:
        rec["relaunch_probe_s"] = float(once["stdout"].split()[-1])
    if out["stall_twice"]["rc"] != STALL_EXIT_CODE:
        failures.append(f"watchdog: a second stall exited {out['stall_twice']['rc']}, "
                        f"not {STALL_EXIT_CODE}")
    hb = out["heartbeat"]
    if hb["rc"] != 0 or "RESUMED" not in hb["stdout"]:
        failures.append(f"watchdog: an unfed heartbeat did not relaunch with --resume: {hb}")
    rec["failures"] = failures
    emit_fn(rec)
    return rec, result
