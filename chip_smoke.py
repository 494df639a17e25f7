#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Drives the port's three main paths at full size through their public entry
points and holds every hand-written kernel against its plain PyTorch
version. One JSON line per phase, flushed as it ends, so a stall shows where
it happened:

  device   nvidia-smi's name and power limit, torch's device name, the torch,
           CUDA and sympy versions (no sympy: the run fails)
  build    nvcc of csrc/lbfgs_sweep.cu, csrc/symmpen.cu, csrc/lbfgs_dir.cu,
           csrc/tape_eval.cu and the L2 probe csrc/l2_probe.cu, and g++ of the
           GP breeding core csrc/evolve.cpp, into build/torch_kernels/, one
           compiler per source, all started together; each kernel's
           registers, stack frame and spill bytes from -Xptxas -v (K1 and K4
           are gated on a report for every template instantiation, with no
           stack and no spills; the bf16 instantiations of K2/K3 and K5
           likewise, K5's up to the stack frame its f32 instantiation has);
           the tensor-core instructions (HMMA) of each symmpen.cu entry in
           its SASS (cuobjdump -sass): every bf16 entry must hold them, no
           f32 entry may
  data     gen_data on the card: the LV train split at the 11 noise levels
           (200 ICs x 10000 RK4 steps each) and the growth train split at
           noise 0.05; kept in memory, no cache written
  kernel   K1 against lbfgs_sweep_plain on the inputs of the main path's two
           launches (50 growth lanes; 550 LV lanes, 11 levels x 50 seeds):
           per-lane mask and stop-epoch mismatches (also per level; every
           level is held to >= 49 of 50 agreeing lanes), lanes not bit-equal
           (theta, mask or stop), max |dtheta|, median kernel ms over 5 runs,
           plain ms, warm prep ms, the bound, and the device ns per dependent
           reduction of the slowest lane (from the kernel's work counts)
  sweep    path 1 with every launch count set to 0 first: 11 LV levels x 50
           seeds in one stacked sweep (plain SINDy) and growth EquivSINDy-c x
           50 seeds, a warm pass then a timed pass each
  symmpen  K2 (encoder chain and its VJP), K3 (decoder JVP and its VJP) and
           K4 (two-loop direction: elements not bit-equal, the wrapper's host
           time, device ns per dependent dot product) against their plain
           versions on the inputs of one EquivSINDy-r closure at full width:
           the LV noise-0.99 data,
           4 seeds x 20,000 rows, the frozen LaLiGAN checkpoint
           saved_models/laligan-noise99-lv (missing: the run fails); K2/K3
           again at hidden width 128 on the selkov checkpoint
           saved_models/laligan-noise20-selkov (80,000 rows in its IC box).
           Each backward reads its forward's masks (the kernel's or the plain
           chain's); the forwards' mask bits are counted against the plain
           chain's; bounds of this design and of the recomputing one; the
           sum of the four functions per closure
  l2       the L2 read rate: csrc/l2_probe.cu's CTAs each read one 2 MiB
           buffer (the LV chain's hidden weights in bf16), bytes over device
           time
  symmpen_bf16  the same K2/K3 cases in their bf16 modes against the bf16
           plain versions (max |diff| within 1e-2 of the output scale, at
           most 0.1% of the mask bits differing; bounds at the bf16
           tensor-core peak); each with the hidden weight bytes its launch
           reads out of L2 and their time at the measured L2 rate, and as
           library_ms the device time of the same chain through cuBLAS (a
           bf16 torch.matmul a layer, bias, ReLU and mask compare in f32), a
           yardstick the port never calls
  symreg   path 2 with every launch count set to 0 first: the CLI run of
           lv/noise99_eq_isymreg.cfg --symmpen_pallas --ae_dtype f32
           --lbfgs_dir_backend pallas on one 4-seed chunk, full width and the
           full 100-epoch protocol, on the noise-0.99 data of the data phase
  symreg_bf16  the same chunk with --ae_dtype bf16 (K2/K3's bf16 modes; no
           f32 K2/K3 launch allowed), its equations beside the f32 chunk's
  tape     K5 (tape evaluation) and K6 (constant gradient) against their
           plain versions on the inputs of one generation of each GP leg at
           full size (10 seeds; plain: 20 units x 1024 tapes on 2,500 rows,
           EquivGP-r: 10 units x 2048 tapes on 5,000 rows; K6 on the top-256
           groups' tapes and the first 512 rows): the predictions' elements
           not bit-equal (gate 0) on the population and on the top-256
           groups' first 512 rows and all rows, their NaN and finite
           mismatches and max |diff| over each element's magnitude, units
           whose top-256 set differs, K6's max |diff| over each element's
           sum over rows of |its rows' contributions| and its bits on a
           repeat run; times and bounds; then K5 at the three shapes a
           generation launches (the population on all rows, the top-256
           groups on the first 512 rows and on all rows) and K6 at its one,
           at the units the gp phase runs, each with its bound and its
           launches per chunk (gated against the gp phase's counts)
  tape_bf16  K5's bf16 mode at the shapes a --gp_eval_dtype bf16 generation
           launches it (the population and the top-256 groups on all rows)
           against its plain version in bf16 on the card: elements not
           bit-equal (gate 0), times, bytes bound, launches per chunk (gated
           against the gp_bf16 phase's counts)
  gp       path 3 with every launch count set to 0 first: one 10-seed chunk
           of the plain GP leg and one 4-seed chunk of the EquivGP-r leg
           through cli/main_gp.py::run at the full protocol (population 1024,
           40 generations, 2,500 rows), on the LV noise-0.99 data of the
           data phase and the LV checkpoint
  gp_bf16  the same two chunks with --gp_eval_dtype bf16
  profile  (--profile) torch.profiler over one EquivSINDy-r epoch of the same
           chunk: device time by kernel family, launches, idle share
  kernels  one line per ported kernel (the bf16 modes of K2, K3 and K5 as
           entries of their own), with its launches on its path,
           agreement with the plain version, times and bound, and launches x
           (time - bound) by either time (gap_s, device_gap_s)

Every kernel has two times: ms, one launch between CUDA events (the host's
launch cost included), and device_ms, the device time per launch of 20
back-to-back launches that the host queued behind a sleep.

The last line is {"ok": true, "device": {...}}. Any failed check raises and
the script exits non-zero without it. It exits non-zero at once when there
is no CUDA device. Budget: 600 s for the whole run, build included; a hard
alarm ends the process at 1100 s. The 50-seed flagship and GP sweeps are
commands of their own, through the port's CLIs (README).
"""

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BUDGET_S = 600.0
HARD_LIMIT_S = 1100
H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores, data sheet (SXM)
H100_BF16_FLOPS = 989e12       # bf16 on the tensor cores, dense, data sheet (SXM)
LV_LEVELS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.99]
SEEDS = list(range(50))
REPO = Path(__file__).resolve().parent
CKPT_ROOT = REPO / "saved_models"
SYMREG_SEEDS = 4         # one chunk of the EquivSINDy-r sweep
SYMREG_ROWS = 20000      # per seed: subsample 0.01 of the 2,000,000 LV rows
K23_MAX_REL = 1e-4       # K2/K3: max |diff| over all rows, as a share of the output scale
K23_ROW_REL = 1e-5       # K2/K3: a row beyond this share of the scale is counted ...
ROW_SHARE_GATE = 1e-3    # ... and at most this share of the rows may be
K23_BF16_MAX_REL = 1e-2  # K2/K3 bf16: max |diff| over all rows, as a share of the output scale
K23_BF16_MASK_SHARE = 1e-3  # K2/K3 bf16: mask bits that may differ from the plain chain's
K5_MAX_REL = 1e-6        # K5: max |diff| over each element's magnitude (and bit-equal)
K6_MAX_REL = 1e-5        # K6: max |diff| over each element's sum of |row contributions|
GP_SEEDS = {"plain": 10, "equivgp_r": 4}   # one chunk of each GP leg
TAPE_SEEDS = 10          # the tape phase's generation: seeds of each leg
GP_TOPK = 256
K1_REDUCTIONS_PER_EVAL = 2  # csrc/lbfgs_sweep.cu: the 8-value reduction and g.d
# template instantiations in -Xptxas -v: K1's 1-4 slices, K4's widths 16-128
PTXAS_KERNELS = {"lbfgs_sweep.cu": 4, "lbfgs_dir.cu": 5}
# the bf16 instantiations, gated the same way among all of their source's
# entries: K2/K3's three tile widths (symmpen.cu: 6 f32 and 3 bf16 entries)
# and K5's (tape_eval.cu: K6, K5 f32 and K5 bf16), whose only stack is the
# 32-byte frame its f32 twin and K6 have too: sinf/cosf's reduction of
# large arguments keeps its multi-word product in local memory (the
# kernels' SASS, cuobjdump)
PTXAS_BF16 = {"symmpen.cu": (9, r"symmpen_kernelILi\d+ELb1ELb1E", 3),
              "tape_eval.cu": (3, r"tape_eval_kernelILb1E", 1)}
L2_PROBE_BYTES = 2 << 20   # the LV chain's hidden weights in bf16: 4 x 512 x 512 x 2 B
L2_PROBE_CTAS = 1056       # 8 a streaming multiprocessor


def emit(obj):
    print(json.dumps(obj), flush=True)


class Clock:
    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0

    def check(self, phase):
        if self.elapsed() > BUDGET_S:
            raise RuntimeError(f"over the {BUDGET_S:.0f} s budget after phase {phase}")


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


def ptxas_functions(report):
    """Each kernel entry of nvcc's -Xptxas -v report: its registers and its
    stack frame and spill bytes."""
    out = []
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            out.append({"function": m[1]})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1].update(stack_bytes=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m[1])
    return out


def sass_hmma(library):
    """{kernel entry: its tensor-core (HMMA) instructions} in the SASS of a
    built library, by cuobjdump -sass."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", library], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = m[1]
            out[entry] = 0
        elif entry and re.search(r"\bHMMA\.", line):
            out[entry] += 1
    return out


def l2_probe_kernel():
    """csrc/l2_probe.cu with the port's nvcc flags (ops/_nvcc.py)."""
    import ctypes

    from symmetry_ode_discovery_tpu_torch.ops import _nvcc

    return _nvcc.Kernel(_nvcc.CSRC / "l2_probe.cu", _nvcc.ARCH_FLAGS, {
        "l2_read_launch": ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p], ctypes.c_int),
        "l2_probe_threads": ([], ctypes.c_int)})


def l2_phase(dev, probe, emit_fn):
    """The L2 read rate: L2_PROBE_CTAS CTAs each read one L2_PROBE_BYTES
    buffer (resident in L2 after the warm launch); bytes read over device
    time (device_ms)."""
    import torch

    lib = probe.lib()
    buf = torch.ones(L2_PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    out = torch.empty(L2_PROBE_CTAS * lib.l2_probe_threads(), dtype=torch.int32, device=dev)

    def fn():
        rc = lib.l2_read_launch(buf.data_ptr(), L2_PROBE_BYTES, out.data_ptr(), L2_PROBE_CTAS,
                                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"l2_read_launch failed: CUDA error {rc}")

    ms = device_ms(fn)
    rec = {"phase": "l2", "buffer_bytes": L2_PROBE_BYTES, "ctas": L2_PROBE_CTAS,
           "device_ms": ms, "bytes_per_s": L2_PROBE_BYTES * L2_PROBE_CTAS / (ms * 1e-3)}
    emit_fn(rec)
    return rec


def gap_s(launches, ms, bound_ms):
    """Seconds that ``launches`` launches of ``ms`` each spend beyond their bound."""
    return launches * (ms - bound_ms) / 1e3


def k1_bound(cfg, lanes, work, has_mmap):
    """Least time the card could take for the sweep on these inputs: each
    input read once and each output written once over the memory rate, or
    the f32 operations these inputs needed (from the kernel's own count of
    loss/gradient evaluations and two-loop history pairs) over the f32 rate;
    the larger of the two. Without an Mmap (plain SINDy) theta is vec(Xi)
    itself, so the function needs neither the Mmap input nor its products."""
    d, p, n = cfg.d, cfg.p, cfg.n_params
    nv = d * p
    bytes_in = 4 * (lanes * (p * p + nv + 2 + n) + (nv * n if has_mmap else 0))
    bytes_out = 4 * lanes * (n + nv + 1)
    # per evaluation: vec(Xi) = Mmap theta and dL/dtheta = Mmap^T g_vec (only
    # with an Mmap), the quadratic form, the loss sums, dL/dvec, and ~12
    # elementwise/reduction passes over theta for the break tests, curvature
    # terms, step and update; per history pair in the two-loop: two dot
    # products and two updates
    per_eval = (4 * nv * n if has_mmap else 0) + 2 * nv * p + 8 * nv + 12 * n
    per_pair = 8 * n
    evals = int(work[:, 0].sum())
    pairs = int(work[:, 1].sum())
    flops = evals * per_eval + pairs * per_pair
    t_bytes = (bytes_in + bytes_out) / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_in + bytes_out, "flops": flops,
            "evals": evals, "history_pairs": pairs}


def k1_slowest_lane_reductions(work):
    """The dependent reductions of K1's slowest lane, from the kernel's work
    counts: two per loss/gradient evaluation (the batched loss and
    break-test sums, then g.d) and two per two-loop pair."""
    return int((work[:, 0] * K1_REDUCTIONS_PER_EVAL + 2 * work[:, 1]).max())


def compare_k1(name, k1, cfg, inputs, Mmap, lanes, group, prep_ms):
    """K1 against its plain version on the same CUDA tensors; mismatching
    lanes are also counted per block of `group` lanes (one dataset's seeds).
    prep_ms: warm wall time of the subsample and normal equations that built
    the inputs, reported alongside."""
    import torch

    work = torch.zeros((lanes, 2), dtype=torch.int32, device="cuda")
    th_k, mask_k, stop_k = k1.lbfgs_sweep(cfg, *inputs, Mmap, work=work)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    th_p, mask_p, stop_p = k1.lbfgs_sweep_plain(cfg, *inputs, Mmap)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mask_ok = (mask_k == mask_p).all(dim=(1, 2))
    stop_ok = stop_k == stop_p
    bits_ok = (th_k.view(torch.int32) == th_p.view(torch.int32)).all(1) & mask_ok & stop_ok
    mask_bad = torch.nonzero(~mask_ok).flatten().tolist()
    stop_bad = torch.nonzero(~stop_ok).flatten().tolist()
    diff = (th_k - th_p).abs()
    both_nan = torch.isnan(th_k) & torch.isnan(th_p)
    diff = torch.where(both_nan, torch.zeros_like(diff), diff)
    agree = mask_ok.nonzero().flatten()
    max_diff = float(diff[agree].max()) if len(agree) else float("nan")
    kernel = lambda: k1.lbfgs_sweep(cfg, *inputs, Mmap)
    kernel_ms, kernel_device_ms = event_ms(kernel, 5), device_ms(kernel)
    bad = (~mask_ok | ~stop_ok).reshape(-1, group).sum(dim=1)
    stops = stop_k.float()
    out = {"phase": "kernel", "case": name, "lanes": lanes, "n_params": cfg.n_params,
           "mask_mismatch": len(mask_bad), "mask_mismatch_lanes": mask_bad,
           "stop_mismatch": len(stop_bad), "stop_mismatch_lanes": stop_bad,
           "mismatch_by_group": bad.tolist(),
           "lanes_not_bit_equal": int((~bits_ok).sum()),
           "max_abs_diff": max_diff, "ms": kernel_ms, "device_ms": kernel_device_ms,
           "plain_ms": plain_ms,
           "prep_ms": prep_ms,
           "stop_epoch_min_median_max": [float(stops.min()), float(stops.median()),
                                         float(stops.max())]}
    out.update(k1_bound(cfg, lanes, work.cpu(), Mmap is not None))
    out["slowest_lane_reductions"] = k1_slowest_lane_reductions(work)
    out["chain_ns_per_reduction"] = kernel_device_ms * 1e6 / out["slowest_lane_reductions"]
    for lane in sorted(set(mask_bad) | set(stop_bad)):
        out.setdefault("mismatches", []).append({
            "lane": lane, "stop_kernel": int(stop_k[lane]), "stop_plain": int(stop_p[lane]),
            "mask_kernel": mask_k[lane].flatten().tolist(),
            "mask_plain": mask_p[lane].flatten().tolist()})
    emit(out)
    return out


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


def cublas_chain_bf16(f, kind, a, b, masks):
    """One K2/K3 function of the bf16 chain ``f`` (``kind`` a key of
    symmpen.MODES) through cuBLAS, as a closure: a bf16 torch.matmul a
    layer with f32 output, the bias, ReLU, mask compare (forwards) or mask
    select (backwards, ``masks`` the plain chain's bools) in f32, on inputs
    a (and b: the JVP's tangent, a backward's cotangent). A yardstick of
    device time for library_ms; the port never calls it."""
    import torch

    bf16 = torch.bfloat16
    Ws = [w.to(bf16) for w in f.Ws]
    WTs = [w.T.contiguous() for w in Ws]
    mm = lambda h, w: torch.matmul(h.to(bf16), w).float()
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
    (bytes/s), their time at that rate; in bf16, library_ms is the device
    time of cublas_chain_bf16. Times by CUDA events; then the per-closure
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
               "library_ms": device_ms(cublas_chain_bf16(f, kind, *library[kind][1:]))
               if bf16 else None,
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


def tape_bf16_shapes(ti, leg):
    """The shapes at which a generation of ``leg`` with --gp_eval_dtype bf16
    launches K5's bf16 mode (its full-batch fitness evaluations: the
    population and the top-256 groups on all rows; its Adam steps launch the
    f32 K5 and K6 of tape_shapes): a list of (record of the shape with its
    bytes bound and launches per chunk, the launch at the units gp_phase
    runs, the kernel and its plain version on every unit of ``ti``)."""
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
        c, xs = c.to(torch.bfloat16).contiguous(), xs.to(torch.bfloat16).contiguous()
        sub = [v[:u_gp].contiguous() for v in (o, a, c, xs)]
        rec = tape_bound(sub[0], xs.shape[1], xs.shape[2], xs.shape[1], 1, elem=2)
        rec.update(kernel="K5_bf16", shape=shape, units=u_gp, tapes_per_unit=o.shape[1],
                   rows=xs.shape[1], launches_per_chunk=gens)
        out.append((rec, partial(te.eval_tapes_kernel, *sub, ti.depth, ti.table),
                    partial(te.eval_tapes_kernel, o, a, c, xs, ti.depth, ti.table),
                    partial(eval_tapes_plain, o, a, c, xs, ti.depth, ti.table)))
    return out


def tape_bf16_phase(ti, leg, emit_fn):
    """K5's bf16 mode against its plain version in bf16 on the card at every
    shape of tape_bf16_shapes, on every unit of ``ti``: elements not
    bit-equal (gate 0, NaN matching NaN), max |diff|, times of one launch
    and device times at the gp phase's units, the bytes bound, launches x
    gap per chunk."""
    import torch

    recs = []
    for rec, fn, full, plain in tape_bf16_shapes(ti, leg):
        got = full()
        torch.cuda.synchronize()
        want = plain()
        fin = torch.isfinite(want) & torch.isfinite(got)
        ms, dms, n = event_ms(fn, 5), device_ms(fn), rec["launches_per_chunk"]
        recs.append(dict(rec, not_bit_equal=not_bit_equal(got, want),
                         finite_mismatch=int((torch.isfinite(got) != torch.isfinite(want)).sum()),
                         max_abs_err=float(torch.where(fin, (got.float() - want.float()).abs(),
                                                       0.0).max()),
                         ms=ms, device_ms=dms, plain_ms=event_ms(plain, 1), library_ms=None,
                         gap_s_per_chunk=gap_s(n, ms, rec["bound_ms"]),
                         device_gap_s_per_chunk=gap_s(n, dms, rec["bound_ms"])))
    emit_fn({"phase": "tape_bf16", "kernel": "K5_bf16", "leg": leg, "shapes": recs})
    return recs


def tape_phase(dev, x, dx, emit_fn):
    """K5 and K6 against their plain versions on the inputs of one generation
    of each GP leg at full size (10 seeds each); then each at every shape a
    generation launches, at the units gp_phase runs; then K5's bf16 mode
    (tape_bf16_phase)."""
    import torch

    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te
    from symmetry_ode_discovery_tpu_torch.symgp.tape import eval_tapes_plain

    out = {}
    for leg in ("plain", "equivgp_r"):
        ti = tape_inputs(dev, x, dx, leg)
        ops, args, consts, pts = ti.ops, ti.args, ti.consts, ti.pts
        depth, table = ti.depth, ti.table
        sops, sargs, sconsts, spts, gbar = ti.sops, ti.sargs, ti.sconsts, ti.spts, ti.gbar
        U, P, L = ops.shape
        N, R = pts.shape[1], spts.shape[1]
        kernel = lambda: te.eval_tapes_kernel(ops, args, consts, pts, depth, table)
        plain = lambda: eval_tapes_plain(ops, args, consts, pts, depth, table)
        got = ti.pred
        torch.cuda.synchronize()
        want = plain()
        # K5 does no cross-row reduction: every element must be the plain
        # version's bits (any NaN against any NaN), inf and finite included
        n_not_bit_equal = not_bit_equal(got, want)
        nan_mismatch = int((torch.isnan(got) != torch.isnan(want)).sum())
        finite = torch.isfinite(want)
        finite_mismatch = int((torch.isfinite(got) != finite).sum())
        # each element against its own magnitude
        both = finite & torch.isfinite(got)
        diff = torch.where(both, (got - want).abs(), 0.0)
        rel = torch.where(diff > 0, diff / want.abs().clamp_min(torch.finfo(torch.float32).tiny), 0.0)
        # top-256 groups by the leg's fitness, from each version's predictions
        fit_p = ti.unit.of_preds(want, *ti.inp.data)
        idx_p = torch.sort(fit_p, dim=1, stable=True).indices[:, :GP_TOPK]
        topk_differ = sum(set(ti.idx[u].tolist()) != set(idx_p[u].tolist()) for u in range(U))
        # the top-256 groups' tapes at the two other shapes a generation
        # launches K5 at (tape_shapes), also bit for bit, on every unit
        top = {f"top-{GP_TOPK} groups, first {R} rows": (ti.spred, spts),
               f"top-{GP_TOPK} groups, all rows": (
                   te.eval_tapes_kernel(sops, sargs, sconsts, pts, depth, table), pts)}
        torch.cuda.synchronize()
        by_shape = {shape: not_bit_equal(got_s, eval_tapes_plain(sops, sargs, sconsts, xs, depth,
                                                                 table))
                    for shape, (got_s, xs) in top.items()}
        rec5 = {"phase": "tape", "name": "tape_eval", "kernel": "K5", "leg": leg,
                "units": U, "tapes_per_unit": P, "L": L, "rows": N,
                "max_abs_err": float(diff.max()), "rel_err": float(rel.max()),
                "not_bit_equal": n_not_bit_equal, "nan_mismatch": nan_mismatch,
                "finite_mismatch": finite_mismatch, "topk_units_differ": int(topk_differ),
                "not_bit_equal_by_shape": by_shape,
                "ms": event_ms(kernel, 5), "device_ms": device_ms(kernel),
                "plain_ms": event_ms(plain, 1), "library_ms": None}
        rec5.update(tape_bound(ops, N, 2, N, 1))
        emit_fn(rec5)
        # K6 on the top-256 groups' tapes and the first 512 rows, the
        # cotangent of the leg's loss in the predictions
        kernel6 = lambda: te.eval_tapes_grad_kernel(sops, sargs, sconsts, spts, gbar, depth, table)
        plain6 = lambda: te.eval_tapes_grad_plain(sops, sargs, sconsts, spts, gbar, depth, table)
        g_k = kernel6()
        torch.cuda.synchronize()
        g_p = plain6()
        # each element against the sum over rows of |its rows' contributions|
        # (K6 sums the rows in another order than autograd), from the plain
        # version run on every row as a unit of its own
        K = sops.shape[1]
        row_scale = torch.stack([te.eval_tapes_grad_plain(
            sops[u:u + 1].expand(R, -1, -1).contiguous(),
            sargs[u:u + 1].expand(R, -1, -1).contiguous(),
            sconsts[u:u + 1].expand(R, -1, -1).contiguous(), spts[u][:, None].contiguous(),
            gbar[u].T[..., None].contiguous(), depth, table).abs().sum(0) for u in range(U)])
        ok = torch.isfinite(g_p)
        gdiff = torch.where(ok & torch.isfinite(g_k), (g_k - g_p).abs(), 0.0)
        grel = torch.where(gdiff > 0, gdiff / row_scale.clamp_min(torch.finfo(torch.float32).tiny),
                           0.0)
        rec6 = {"phase": "tape", "name": "tape_grad", "kernel": "K6", "leg": leg,
                "units": U, "tapes_per_unit": K, "L": L, "rows": R,
                "max_abs_err": float(gdiff.max()), "rel_err": float(grel.max()),
                "finite_mismatch": int((torch.isfinite(g_k) != ok).sum()),
                "repeat_bit_equal": bool(torch.equal(g_k, kernel6())),
                "ms": event_ms(kernel6, 5), "device_ms": device_ms(kernel6),
                "plain_ms": event_ms(plain6, 1), "library_ms": None}
        rec6.update(tape_bound(sops, R, 2, L, 2, extra_in_bytes=4 * gbar.numel()))
        emit_fn(rec6)
        shapes = []
        for rec, fn in tape_shapes(ti, leg):
            ms, dms, n = event_ms(fn, 5), device_ms(fn), rec["launches_per_chunk"]
            shapes.append(dict(rec, ms=ms, device_ms=dms,
                               gap_s_per_chunk=gap_s(n, ms, rec["bound_ms"]),
                               device_gap_s_per_chunk=gap_s(n, dms, rec["bound_ms"])))
        emit_fn({"phase": "tape_shapes", "leg": leg, "shapes": shapes})
        out[leg] = {"K5": rec5, "K6": rec6, "shapes": shapes,
                    "K5_bf16": tape_bf16_phase(ti, leg, emit_fn)}
        del ti, got, want, top, gbar, g_k, g_p, row_scale
        torch.cuda.empty_cache()
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


def profile_phase(dev, x, dx, emit_fn):
    """torch.profiler over the first EquivSINDy-r epoch (20 closures) of the
    4-seed chunk, after the symreg phase warmed every kernel: device time by
    kernel family (a kernel counts to the Euler pair or the L-BFGS update
    when it starts inside that label's device-side span), kernel launches,
    and the share of the epoch's wall time no kernel ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.training.siged import (
        LBFGSHParams, _make_param_fns, make_lbfgs_stepper)
    from symmetry_ode_discovery_tpu_torch.training.sweep import _init_theta, _subsample_idx
    from symmetry_ode_discovery_tpu_torch.training.symmreg import make_symmreg_i_fast

    args, ae, spec, g_state = flagship_models(dev)
    cfg, Q = make_config(2, poly_order=2, include_exp=True, threshold=args["threshold"])
    hp = LBFGSHParams(num_epochs=args["num_epochs"], lr_sindy=args["lr_sindy"],
                      w_sindy_x=args["w_sindy_x"], w_sindy_reg=args["w_sindy_reg"],
                      w_sym_reg=args["w_sym_reg"], st_freq=args["st_freq"],
                      threshold=args["threshold"], dir_backend="pallas")
    prep, pen = make_symmreg_i_fast(ae, spec, g_state, args["int_t"], args["int_dt"],
                                    pallas=True, fused_rollout_lib=cfg.library)
    init, step, _ = make_lbfgs_stepper(cfg, Q, hp, pen, prep, epochs_per_call=1)
    seeds = list(range(SYMREG_SEEDS))
    idx = _subsample_idx(seeds, x.shape[0], SYMREG_ROWS, dev)
    theta0 = _init_theta(seeds, _make_param_fns(cfg, Q)[0], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(init(x[idx], dx[idx], theta0), 0)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3  # the same epoch, no profiler
    carry = init(x[idx], dx[idx], theta0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = step(carry, 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cpu_names = {e.name for e in events if getattr(e, "device_type", None) == DeviceType.CPU}
    on_device = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    # device-side events named like a host range are label spans (the
    # record_function labels and autograd Functions), not kernels
    labels = [e for e in on_device if e.name in cpu_names]
    kernels = [e for e in on_device if e.name not in cpu_names]
    if not kernels:
        raise RuntimeError("profile: the trace holds no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s

    def spans_of(names):
        return [(lab.time_range.start, lab.time_range.end) for lab in labels
                if lab.name in names]

    def in_label(e, spans):
        return any(a <= e.time_range.start <= b for a, b in spans)

    euler = spans_of(("euler_pair", "euler_pair.backward"))
    update = spans_of(("lbfgs_update",))

    family = {"symmpen (K2, K3)": lambda e: "symmpen" in e.name,
              "lbfgs_dir (K4)": lambda e: "lbfgs_dir" in e.name,
              "euler pair (forward and backward)":
                  lambda e: in_label(e, euler),
              "L-BFGS update around K4": lambda e: in_label(e, update)}
    ms = {k: 0.0 for k in list(family) + ["other kernels"]}
    counts = {k: 0 for k in ms}
    for e in kernels:
        key = next((k for k, f in family.items() if f(e)), "other kernels")
        ms[key] += (e.time_range.end - e.time_range.start) / 1e3
        counts[key] += 1
    top = sorted(prof.key_averages(), key=lambda e: -getattr(e, "self_device_time_total", 0))
    rec = {"phase": "profile", "iterations": 20, "lanes": SYMREG_SEEDS,
           "epoch_wall_ms_unprofiled": plain_wall_ms,
           "epoch_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us,
           "device_ms_by_family": ms, "launches_by_family": counts,
           "kernel_launches": len(kernels),
           "top_ops_by_self_device_ms": [
               (e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
               for e in top[:12]]}
    emit_fn(rec)
    return rec


def tape_line(tape, gp, kernel):
    """The kernels-line entry of K5 or K6: agreement, times and bound at the
    plain leg's first generation (the EquivGP-r leg's beside them), launches
    on path 3 (both legs), and each shape's times and launches x gap, whose
    sums over the shapes and legs are ``gap_s`` (one launch) and
    ``device_gap_s`` (device time)."""
    rec, sysrec = tape["plain"][kernel], tape["equivgp_r"][kernel]
    fn = rec["name"]
    line = {"name": fn, "kernel": kernel, "route": "cuda",
            "source": "symmetry_ode_discovery_tpu_torch/csrc/tape_eval.cu",
            "replaces": "symmetry_ode_discovery_tpu/symgp/pallas_eval.py:"
                        + ("50" if kernel == "K5" else "222"),
            "launches": sum(g["launches"][fn] for g in gp.values()),
            "launches_by_leg": {leg: g["launches"][fn] for leg, g in gp.items()}}
    line.update({k: rec[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")})
    line["shapes"] = (f"{rec['units']} units x {rec['tapes_per_unit']} tapes x L {rec['L']} "
                      f"on {rec['rows']} rows")
    line["equivgp_r"] = {k: sysrec[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                                "bound_ms", "bound_by", "units", "tapes_per_unit",
                                                "rows")}
    keys = ("shape", "units", "tapes_per_unit", "rows", "ms", "device_ms", "bound_ms",
            "launches_per_chunk", "gap_s_per_chunk", "device_gap_s_per_chunk")
    by_shape = {leg: [{k: r[k] for k in keys} for r in recs["shapes"] if r["kernel"] == kernel]
                for leg, recs in tape.items()}
    line["by_shape"] = by_shape
    for key in ("gap_s", "device_gap_s"):
        line[key] = sum(r[key + "_per_chunk"] for recs in by_shape.values() for r in recs)
    return line


def tape_bf16_line(tape, gp_bf16):
    """The kernels-line entry of K5's bf16 mode: agreement, times and bound
    at the plain leg's population shape (every shape of both legs under
    by_shape), launches on path 3 with --gp_eval_dtype bf16 (both legs) and
    launches x gap summed over the shapes and legs."""
    recs = {leg: t["K5_bf16"] for leg, t in tape.items()}
    first = recs["plain"][0]
    keys = ("shape", "units", "tapes_per_unit", "rows", "not_bit_equal", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "launches_per_chunk",
            "gap_s_per_chunk", "device_gap_s_per_chunk")
    line = {"name": "tape_eval_bf16", "kernel": "K5", "route": "cuda",
            "source": "symmetry_ode_discovery_tpu_torch/csrc/tape_eval.cu",
            "replaces": "symmetry_ode_discovery_tpu/symgp/pallas_eval.py:50",
            "launches": sum(g["launches"]["tape_eval_bf16"] for g in gp_bf16.values()),
            "launches_by_leg": {leg: g["launches"]["tape_eval_bf16"]
                                for leg, g in gp_bf16.items()},
            "not_bit_equal": sum(r["not_bit_equal"] for rs in recs.values() for r in rs),
            "max_abs_err": max(r["max_abs_err"] for rs in recs.values() for r in rs)}
    line.update({k: first[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")})
    line["shapes"] = (f"{first['units']} units x {first['tapes_per_unit']} tapes on "
                      f"{first['rows']} rows, bf16")
    line["by_shape"] = {leg: [{k: r[k] for k in keys} for r in rs] for leg, rs in recs.items()}
    for key in ("gap_s", "device_gap_s"):
        line[key] = sum(r[key + "_per_chunk"] for rs in recs.values() for r in rs)
    return line


def kernel_line(rec, launches, width_128, libs):
    """The kernels-line entry of one K2/K3/K4 function from the symmpen
    phase (K2/K3 in f32 or, named <function>_bf16, in bf16), with its
    launches on the EquivSINDy-r path of its dtype and their launches x gap
    by either time (for K2/K3, the width-128 case beside it; for K4, its
    elements not bit-equal, chain figure and ptxas report)."""
    names = {"symmpen_enc_fwd": ("symmpen.cu", "ops/pallas_symmpen.py:185", "enc_fwd"),
             "symmpen_enc_bwd": ("symmpen.cu", "ops/pallas_symmpen.py:191", "enc_bwd"),
             "symmpen_dec_jvp": ("symmpen.cu", "ops/pallas_symmpen.py:197", "dec_jvp"),
             "symmpen_dec_jvp_bwd": ("symmpen.cu", "ops/pallas_symmpen.py:215", "dec_jvp_bwd"),
             "lbfgs_dir": ("lbfgs_dir.cu", "ops/pallas_lbfgs_dir.py:47", "lbfgs_dir")}
    base = rec["name"].removesuffix("_bf16")
    src, replaces, key = names[base]
    key = key + rec["name"][len(base):]
    line = {"name": rec["name"], "kernel": rec["kernel"], "route": "cuda",
            "source": f"symmetry_ode_discovery_tpu_torch/csrc/{src}",
            "replaces": f"symmetry_ode_discovery_tpu/{replaces}",
            "launches": launches[key]}
    line.update({k: rec[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")})
    line["gap_s"] = gap_s(launches[key], rec["ms"], rec["bound_ms"])
    line["device_gap_s"] = gap_s(launches[key], rec["device_ms"], rec["bound_ms"])
    line["shapes"] = (f"{rec['rows']} rows (4 seeds x 20,000), widths 2-512x5-2"
                      if "rows" in rec else f"{rec['lanes']} lanes, m={rec['memory']}, n={rec['n']}")
    if "l2_weight_bytes" in rec:
        line.update({k: rec[k] for k in ("l2_weight_bytes", "l2_weight_ms") if k in rec})
    if rec["name"].endswith("_bf16"):
        line["shapes"] += ", bf16"
        if "mask_bits" in rec:
            line.update({k: rec[k] for k in ("mask_bits", "mask_bits_differ")})
    if rec["name"] == "lbfgs_dir":
        line.update({k: rec[k] for k in ("not_bit_equal", "host_ms", "enqueue_ms",
                                         "chain_ns_per_reduction")})
        line["ptxas"] = libs["lbfgs_dir.cu"]["ptxas"]
    if rec["name"] in width_128:
        line["bound_old_ms"] = rec["bound_old_ms"]
        line["width_128"] = {k: width_128[rec["name"]][k]
                             for k in ("max_abs_err", "scale", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_old_ms", "library_ms",
                                       "l2_weight_bytes")}
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description="smoke run of the port on one card")
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler split of one EquivSINDy-r epoch")
    opts = parser.parse_args(argv)
    clock = Clock()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1
    from symmetry_ode_discovery_tpu_torch.ops import _nvcc, lbfgs_dir, symmpen, tape_eval
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep as k1
    from symmetry_ode_discovery_tpu_torch.symgp import evolve

    signal.alarm(HARD_LIMIT_S)
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    device_kind = torch.cuda.get_device_name(0)
    import sympy  # the GP form projector's; a requirement of torch's own wheel

    emit({"phase": "device", "nvidia_smi": smi, "kind": device_kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "sympy": sympy.__version__})

    # ---- 2. build: one compiler per source, all started together ----
    t0 = time.perf_counter()
    probe = l2_probe_kernel()
    sources = [k1.KERNEL, symmpen.KERNEL, lbfgs_dir.KERNEL, tape_eval.KERNEL, probe,
               evolve.NATIVE]
    _nvcc.build_all(sources)
    libs = {}
    for k in sources:
        info = k.info
        libs[k.source.name] = {
            "seconds": info["seconds"], "compiled": info["compiled"], "library": info["path"],
            "compiler": k.compiler, "ptxas": ptxas_functions(info["ptxas"])}
    libs["symmpen.cu"]["hmma"] = sass_hmma(libs["symmpen.cu"]["library"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": libs})
    clock.check("build")

    # ---- 3. data ----
    t0 = time.perf_counter()
    xs, dxs, xg, dxg = make_data(dev)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "lv": {"levels": LV_LEVELS, "shape": [200, 10000, 2]},
          "growth": {"noise": 0.05, "shape": [100, 100, 2]}})
    clock.check("data")

    # ---- 4. kernel against its plain version, on the main path's launches ----
    checks = {name: compare_k1(name, k1, pcfg, lanes, Mmap, n_lanes, len(SEEDS), prep_ms)
              for name, (pcfg, lanes, Mmap, n_lanes, prep_ms)
              in k1_cases(dev, xs, dxs, xg, dxg).items()}
    clock.check("kernel")

    # ---- 5. path 1: the plain and constrained sweeps ----
    reset_launches()
    walls, res_lv, res_g = path1(dev, xs, dxs, xg, dxg)
    main_launches = k1.launches
    by_noise, ok_g, rmse_g = path1_outcomes(res_lv, res_g)
    emit({"phase": "sweep", "seeds": len(SEEDS), "walls": walls,
          "kernel_launches": main_launches,
          "lv_sindy_success_by_noise": by_noise,
          "growth_esindy_joint_success": int(ok_g.sum()),
          "growth_esindy_rmse": rmse_g,
          "growth_esindy_ref": {"joint_success": 50, "rmse": 0.0143}})
    clock.check("sweep")

    # ---- 6. K2, K3, K4 against their plain versions, full width ----
    x99, dx99 = xs[LV_LEVELS.index(0.99)], dxs[LV_LEVELS.index(0.99)]
    l2 = l2_phase(dev, probe, emit)
    sp_checks, sp_bf16 = symmpen_phase(dev, x99, emit, l2["bytes_per_s"])
    sp_128, sp_128_bf16 = symmpen_width_phase(dev, emit, l2["bytes_per_s"])
    clock.check("symmpen")

    # ---- 7. path 2: the EquivSINDy-r sweep through the CLI, one chunk each
    # with --ae_dtype f32 and bf16 ----
    symreg = symreg_phase(dev, x99, dx99, emit)
    clock.check("symreg")
    symreg_bf16 = symreg_phase(dev, x99, dx99, emit, "bf16")
    clock.check("symreg_bf16")

    # ---- 8. K5, K6 against their plain versions; path 3, the GP engine,
    # with --gp_eval_dtype f32 and bf16 ----
    tape = tape_phase(dev, x99, dx99, emit)
    clock.check("tape")
    gp = gp_phase(dev, x99, dx99, emit)
    clock.check("gp")
    gp_bf16 = gp_phase(dev, x99, dx99, emit, "bf16")
    clock.check("gp_bf16")
    if opts.profile:
        profile_phase(dev, x99, dx99, emit)

    lv_check = checks["lv_sindy_allnoise"]
    g_check = checks["growth_esindy"]
    max_diff = max(lv_check["max_abs_diff"], g_check["max_abs_diff"])
    failures = []
    if main_launches < 1:
        failures.append("the main path launched no lbfgs_sweep kernel")
    if g_check["mask_mismatch"] or g_check["stop_mismatch"]:
        failures.append("growth lanes: kernel and plain disagree on mask or stop epoch")
    for nl, lv_bad in zip(LV_LEVELS, lv_check["mismatch_by_group"]):
        if lv_bad > 1:
            failures.append(f"LV noise {nl:.2f}: {lv_bad} of 50 lanes disagree on mask "
                            "or stop epoch")
    if not max_diff <= 1e-3:
        failures.append(f"max |dtheta| {max_diff} > 1e-3 where masks agree")
    if int(ok_g.sum()) < 48 or not rmse_g <= 0.02:
        failures.append(f"growth EquivSINDy-c {int(ok_g.sum())}/50, RMSE {rmse_g}")
    if by_noise["0.00"] < 48:
        failures.append(f"LV plain SINDy at noise 0.00: {by_noise['0.00']}/50")
    if not all(np.isfinite(r.Xi).all() for r in res_lv + [res_g]):
        failures.append("non-finite coefficients on the main path")
    for name, rec in sp_checks.items():
        if name == "lbfgs_dir" and not rec["max_abs_err"] <= 1e-5 * rec["scale"]:
            failures.append(f"K4: max |diff| {rec['max_abs_err']} > 1e-5 of {rec['scale']}")
    for width, recs in ((512, sp_bf16), (128, sp_128_bf16)):
        for name, rec in recs.items():
            if not (rec["finite"] and rec["max_abs_err"] <= K23_BF16_MAX_REL * rec["scale"]):
                failures.append(f"{name} at width {width}: max |diff| {rec['max_abs_err']} (limit "
                                f"{K23_BF16_MAX_REL} of the output scale {rec['scale']}), "
                                f"finite: {rec['finite']}")
            if "mask_bits" in rec and rec["mask_bits_differ"] > K23_BF16_MASK_SHARE * rec["mask_bits"]:
                failures.append(f"{name} at width {width}: {rec['mask_bits_differ']} of "
                                f"{rec['mask_bits']} mask bits differ from the plain bf16 "
                                f"chain's (limit {K23_BF16_MASK_SHARE} of them)")
    for width, recs in ((512, sp_checks), (128, sp_128)):
        for name, rec in recs.items():
            if name == "lbfgs_dir":
                continue
            if not (rec["finite"] and rec["max_abs_err"] <= K23_MAX_REL * rec["scale"]
                    and rec["rows_beyond_1e-5"] <= ROW_SHARE_GATE * rec["rows"]):
                failures.append(f"{name} at width {width}: max |diff| {rec['max_abs_err']} (limit "
                                f"{K23_MAX_REL} of the output scale {rec['scale']}), "
                                f"{rec['rows_beyond_1e-5']} of {rec['rows']} rows beyond "
                                f"{K23_ROW_REL} of it (limit {ROW_SHARE_GATE} of the rows), "
                                f"finite: {rec['finite']}")
            if rec.get("mask_bits_differ_not_near_0"):
                failures.append(f"{name} at width {width}: {rec['mask_bits_differ_not_near_0']} "
                                "mask bits differ from the plain chain's where |p| is not "
                                "within rounding of 0")
    for src, count in PTXAS_KERNELS.items():
        report = libs[src]["ptxas"]
        if len(report) != count or any("stack_bytes" not in f for f in report):
            failures.append(f"{src}: the ptxas report holds {len(report)} complete kernel "
                            f"entries, expected {count}")
        for f in report:
            if f.get("stack_bytes") or f.get("spill_stores") or f.get("spill_loads"):
                failures.append(f"{src} {f['function']}: {f.get('stack_bytes')} bytes stack, "
                                f"{f.get('spill_stores')}/{f.get('spill_loads')} bytes spilled")
    for src, (count, pattern, n_bf16) in PTXAS_BF16.items():
        report = libs[src]["ptxas"]
        bf = [f for f in report if re.search(pattern, f["function"])]
        if len(report) != count or len(bf) != n_bf16 or any("stack_bytes" not in f for f in bf):
            failures.append(f"{src}: the ptxas report holds {len(report)} kernel entries, "
                            f"{len(bf)} bf16 ones, expected {count} and {n_bf16}")
        # the frame K5's f32 instance has too, and no more
        frame = max([f.get("stack_bytes", 0) for f in report if f not in bf
                     and "tape_eval_kernel" in f["function"]] or [0])
        for f in bf:
            if f.get("stack_bytes", 0) > frame or f.get("spill_stores") or f.get("spill_loads"):
                failures.append(f"{src} {f['function']}: {f.get('stack_bytes')} bytes stack "
                                f"(allowed {frame}), {f.get('spill_stores')}/"
                                f"{f.get('spill_loads')} bytes spilled")
    # the bf16 entries of K2/K3 on the tensor cores, the f32 ones on the FMA pipe
    bf_pattern = PTXAS_BF16["symmpen.cu"][1]
    for fn, n in libs["symmpen.cu"]["hmma"].items():
        if "symmpen_kernel" not in fn:
            continue
        if re.search(bf_pattern, fn) and n < 1:
            failures.append(f"symmpen.cu {fn}: a bf16 entry with no HMMA instruction in its SASS")
        if not re.search(bf_pattern, fn) and n:
            failures.append(f"symmpen.cu {fn}: an f32 entry with {n} HMMA instructions")
    hmma_entries = [fn for fn in libs["symmpen.cu"]["hmma"] if "symmpen_kernel" in fn]
    if len(hmma_entries) != PTXAS_BF16["symmpen.cu"][0]:
        failures.append(f"symmpen.cu: the SASS holds {len(hmma_entries)} kernel entries, "
                        f"expected {PTXAS_BF16['symmpen.cu'][0]}")
    for rec, dtype in ((symreg, "f32"), (symreg_bf16, "bf16")):
        tag = f"EquivSINDy-r ({dtype})"
        for fn, count in rec["launches"].items():
            own = fn.endswith("_bf16") == (dtype == "bf16") or fn.startswith("lbfgs")
            if fn != "lbfgs_sweep" and own and count < 1:
                failures.append(f"the {tag} path launched no {fn} kernel")
            if not own and count:
                failures.append(f"the {tag} path launched {fn} {count} times")
        if not rec["Xi_finite"] or rec["Xi_shape"] != [SYMREG_SEEDS, 2, 8]:
            failures.append(f"{tag} coefficients: shape {rec['Xi_shape']}, "
                            f"finite {rec['Xi_finite']}")
        if rec["eq0_success"] < 1:
            failures.append(f"{tag}: no seed of the chunk recovered equation 0")
    for leg, recs in tape.items():
        k5, k6 = recs["K5"], recs["K6"]
        if (k5["not_bit_equal"] or k5["nan_mismatch"] or k5["finite_mismatch"]
                or not k5["rel_err"] <= K5_MAX_REL):
            failures.append(f"K5 ({leg}): {k5['not_bit_equal']} elements not bit-equal to the "
                            f"plain version's, {k5['nan_mismatch']} NaN and "
                            f"{k5['finite_mismatch']} finite mismatches, max |diff| "
                            f"{k5['rel_err']} of the element (limit {K5_MAX_REL})")
        for shape, n in k5["not_bit_equal_by_shape"].items():
            if n:
                failures.append(f"K5 ({leg}, {shape}): {n} elements not bit-equal to the plain "
                                "version's")
        if k5["topk_units_differ"]:
            failures.append(f"K5 ({leg}): {k5['topk_units_differ']} units' top-{GP_TOPK} "
                            "sets differ from the plain version's")
        if not k6["rel_err"] <= K6_MAX_REL or k6["finite_mismatch"]:
            failures.append(f"K6 ({leg}): max |diff| {k6['rel_err']} of the element's row-sum "
                            f"scale (limit {K6_MAX_REL}), {k6['finite_mismatch']} finite "
                            "mismatches")
        if not k6["repeat_bit_equal"]:
            failures.append(f"K6 ({leg}): a repeat run gave other bits")
        for fn, kernel in (("tape_eval", "K5"), ("tape_grad", "K6")):
            timed = sum(r["launches_per_chunk"] for r in recs["shapes"] if r["kernel"] == kernel)
            if timed != gp[leg]["launches"][fn]:
                failures.append(f"{kernel} ({leg}): the timed shapes account for {timed} "
                                f"launches a chunk, the GP path made {gp[leg]['launches'][fn]}")
        for r in recs["K5_bf16"]:
            if r["not_bit_equal"] or r["finite_mismatch"]:
                failures.append(f"K5 bf16 ({leg}, {r['shape']}): {r['not_bit_equal']} elements "
                                f"not bit-equal to the plain version's, {r['finite_mismatch']} "
                                "finite mismatches")
        # a bf16 generation: K5 bf16 at the fitness shapes, f32 K5 and K6 in
        # the Adam steps only
        counts = gp_bf16[leg]["launches"]
        timed = {"tape_eval_bf16": sum(r["launches_per_chunk"] for r in recs["K5_bf16"]),
                 "tape_eval": sum(r["launches_per_chunk"] for r in recs["shapes"]
                                  if r["kernel"] == "K5" and "first" in r["shape"]),
                 "tape_grad": sum(r["launches_per_chunk"] for r in recs["shapes"]
                                  if r["kernel"] == "K6")}
        for fn, n in timed.items():
            if n != counts[fn]:
                failures.append(f"{fn} ({leg}, --gp_eval_dtype bf16): the timed shapes account "
                                f"for {n} launches a chunk, the GP path made {counts[fn]}")
    for dtype, legs in (("f32", gp), ("bf16", gp_bf16)):
        for leg, rec in legs.items():
            fns = ("tape_eval", "tape_grad") + (("tape_eval_bf16",) if dtype == "bf16" else ())
            for fn in fns:
                if rec["launches"][fn] < 1:
                    failures.append(f"the GP {leg} leg ({dtype}) launched no {fn} kernel")
            if dtype == "f32" and rec["launches"]["tape_eval_bf16"]:
                failures.append(f"the GP {leg} leg (f32) launched tape_eval_bf16")
            if not rec["best_fit_finite"]:
                failures.append(f"GP {leg} ({dtype}): a unit's best fitness is not finite")
            if rec["eq0"] + rec["eq1"] < 1:
                failures.append(f"GP {leg} ({dtype}): no equation recovered in the chunk")

    print(smi, flush=True)
    emit({"phase": "total", "seconds": clock.elapsed(), "budget_s": BUDGET_S,
          "failures": failures})
    # ---- 8. kernels ----
    emit({"kernels": [{
        "name": "lbfgs_sweep", "route": "cuda",
        "source": "symmetry_ode_discovery_tpu_torch/csrc/lbfgs_sweep.cu",
        "replaces": "symmetry_ode_discovery_tpu/ops/pallas_lbfgs.py:87",
        "launches": main_launches,
        "max_abs_err": max_diff, "max_abs_diff": max_diff,
        "mask_mismatch": lv_check["mask_mismatch"] + g_check["mask_mismatch"],
        "lanes_not_bit_equal": lv_check["lanes_not_bit_equal"],
        "growth_lanes_not_bit_equal": g_check["lanes_not_bit_equal"],
        "chain_ns_per_reduction": lv_check["chain_ns_per_reduction"],
        "growth_chain_ns_per_reduction": g_check["chain_ns_per_reduction"],
        "ptxas": libs["lbfgs_sweep.cu"]["ptxas"],
        "ms": lv_check["ms"], "device_ms": lv_check["device_ms"],
        "plain_ms": lv_check["plain_ms"],
        "bound_ms": lv_check["bound_ms"], "bound_by": lv_check["bound_by"],
        "library_ms": None,
        # path 1 runs each leg twice (warm and timed): half the launches each
        "gap_s": sum(gap_s(main_launches / 2, c["ms"], c["bound_ms"]) for c in (lv_check, g_check)),
        "device_gap_s": sum(gap_s(main_launches / 2, c["device_ms"], c["bound_ms"])
                            for c in (lv_check, g_check)),
        "shapes": f"{lv_check['lanes']} LV lanes (11 levels x 50 seeds), d=2, p=8, n=16",
        "growth_ms": g_check["ms"], "growth_device_ms": g_check["device_ms"],
        "growth_plain_ms": g_check["plain_ms"],
        "growth_bound_ms": g_check["bound_ms"], "growth_bound_by": g_check["bound_by"],
        "growth_shapes": f"{g_check['lanes']} lanes, d=2, p=6, n={g_check['n_params']}"}]
        + [kernel_line(rec, symreg["launches"], sp_128, libs) for rec in sp_checks.values()]
        + [tape_line(tape, gp, k) for k in ("K5", "K6")]
        + [kernel_line(rec, symreg_bf16["launches"], sp_128_bf16, libs)
           for rec in sp_bf16.values()]
        + [tape_bf16_line(tape, gp_bf16)]})
    if failures:
        raise SystemExit("chip_smoke failed: " + "; ".join(failures))
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
