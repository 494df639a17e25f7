#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Drives the port's main paths (the L-BFGS sweeps, EquivSINDy-r, the GP
engine, WSINDy and STLSQ, LaLiGAN symmetry discovery, long-term prediction,
the Adam trainer and the latent-space fit) at full size through
their public entry points and holds every hand-written kernel against its plain PyTorch
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
           plain versions: at most 0.1% of the forwards' mask bits
           differing, none beyond 1e-2 of its terms from 0; K2 fwd within
           1e-2 of the output scale on every row; K3 fwd and both backwards
           within 1e-2 on the rows whose forward masks agree with the plain
           chain's, the flip rows (masks differing in some layer) at most
           0.1% of the rows and finite; each record with its flip rows and
           its max |diff| on them and on the others; bounds at the bf16
           tensor-core peak; each with the hidden weight bytes its launch
           reads out of L2 and their time at the measured L2 rate, and as
           library_ms the device time of the same chain through cuBLAS (a
           bf16 torch.matmul a layer, bias, ReLU and mask compare in f32), a
           yardstick the port never calls; the f32 records of the symmpen
           phase have the f32 chain's (no TF32) as theirs
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
  wsindy   WSINDy through cli/main_wsindy.py::run on the LV noise-0.99
           trajectories of the data phase (lv/noise99_eq_wsindy.cfg, 50
           seeds, the reference's windows, --subsample_rng ref), with every
           launch count set to 0 first (the path has no kernel of its own:
           cuSOLVER's batched QR and SVD); then the same run on the CPU:
           masks equal on at least 48 of 50 seeds, coefficients within 1e-3
           where they are, all finite
  stlsq    STLSQ through cli/main_sindy.py::run on all 2,000,000 rows of the
           same data (lv/noise99_eq_sindy_2.cfg's library and threshold), 4
           seeds, launch counts as for wsindy; then the same solve on the CPU
           on the same rows: masks equal on every seed, coefficients within
           1e-3, all finite
  laligan  path 4, symmetry discovery, with every launch count set to 0 first
           (the path has no kernel of its own: cuBLAS and elementwise torch):
           two epochs of lv/noise99_sym.cfg through cli/main.py::run at full
           width (5 x 512, batch 8192) on the LV noise-0.99 trajectories of
           the data phase (1,996,000 two-step windows, in memory), saved to a
           temporary --save_root; finite components every epoch, the epoch
           walls and batches a second; the checkpoint reloaded through
           convert.laligan_from_npz, its encoder within 1e-6 of the trainer's
           in eval mode; one batch step of one init, batch and draw on the
           card and on the CPU, every component within 1e-4 relative
  rd       path 5, the reaction-diffusion pipeline, with every launch count
           set to 0 first (no kernel of its own either: cuFFT, cuBLAS,
           cuSOLVER and elementwise torch): the rd solver (100 x 100 grid,
           201 samples, 804 RK4 steps) on the card against the same solver
           on the CPU, uf and duf within 1e-4 of the field's maximum; the
           100 epochs of rd/sym_eq.cfg (joint SINDy-in-latent, the constrained
           least-squares branch) through cli/main.py::run at full width
           (10,000 inputs, 5 x 512, latent 2, batch 64) on the card's data;
           finite components every epoch; the checkpoint's encoder within
           1e-6 of the trainer's and regressor.npz equal to its Xi and
           mask; the singular values next to Q's 5e-3 cutoff; one joint step
           of one init, batch and draw on the card and on the CPU, every
           component within 1e-4 relative and the masks equal
  rd_ltp   cli/eval_rd_ltp.py::run on the checkpoint the rd phase trained, on
           its data, the val and traintail splits, on the card (every launch
           count 0 first) and on the CPU: every series (the five relative
           errors, z_pred, z_true) within 1e-4 of its largest magnitude
  ltp      long-term prediction (cli/eval_ltp_sweep.py::ltp_sweep_errors,
           float32 as the CLI): the 20 clean LV validation trajectories
           generated on the card (noise 0, 10,000 steps), path 1's 50
           noise-0.99 coefficient matrices and the truth in one batched RK4 on
           the card (launch counts 0 first) and on the CPU: the same
           diverging seeds, per-seed errors within 1e-4 relative where
           finite, the truth floor under 1e-6; the wall
  adam     20 Adam steps (one epoch of 20 batches of 256) of
           selkov/noise20_eq_symreg.cfg with --sindy_optimizer adam through
           cli/main.py::run at full width (4 x 128, laligan-noise20-selkov,
           the composed symmreg_i) on a selkov set generated on the card
           (noise 0.2, GP smoothing), the draws fed alike to the card's
           (launch counts 0 first) and the CPU's run: the parameters within
           1e-4 of their largest magnitude, finite losses
  latent   one --use_latent --distill_latent L-BFGS fit of the same config,
           checkpoint and data through cli/main.py::run (2,000 rows, the
           config's 200 epochs), the draws fed alike, card (launch counts 0
           first) against CPU: latent and distilled masks equal; then the
           CLI's chunk (cli/main.py::fit_latent_chunk) in float64, card
           against CPU: masks equal, latent coefficients within 1e-6 and
           distilled within 1e-3 of their largest; the float32 coefficient
           differences recorded (the fixed-lr L-BFGS amplifies float32
           rounding: ROADMAP fault 12)
  mesh     seed sharding (parallel/mesh.py) on a Mesh of two (four) shards,
           distinct GPUs where the machine has them, else cuda:0 repeated:
           path 1 (550 LV lanes, 50 growth lanes, one K1 launch a shard)
           against path 1's unsharded results, every lane bit-equal; the
           EquivSINDy-r chunk (4 seeds, full width, K2-K4) for its first 5
           epochs through cli/main.py::run sharded 2 x 2 and unsharded, masks
           equal, the largest coefficient difference recorded, bit-equal to
           one device in chunks of 2 seeds, the unsharded run repeated and
           its bit-equality recorded; the plain GP
           leg's 10-seed chunk (20 units) for 5 generations on 4 shards and
           unsharded, tapes identical, best_fit and constants within 1e-4;
           every launch count 0 before each part and read after it
  dp       data-parallel LaLiGAN training (parallel/dp.py) on 2 ranks,
           run_lassi_dp's ranks (cli/main.py::_lassi_rank), all four
           trainings in one launch (NCCL on distinct GPUs, gloo when the
           ranks share cuda:0), against the single-device CLI from
           the same seed: one epoch of lv/noise99_sym.cfg at full width and
           three of rd/sym_eq.cfg (the joint least-squares path), each in
           float32 and in float64 (the same init and draws widened). Gated
           in float64: the whole run within tests/test_dp_lassi.py's bars
           (epoch means within rtol 5e-3 and atol 1e-5, parameters and
           BatchNorm statistics within relative L2 0.02; on rd the mask
           equal and loss_sindy_z within rtol 5e-2), the first 9 batches'
           metrics within 1e-6 of one device's, on rd the whole run too.
           Recorded: the float64 per-batch gap curve; the float32 runs
           against the same bars beside the single-device float32 run's
           distance from float64; walls, all-reduces a batch
  linesearch  the zoom line-search L-BFGS (LBFGSHParams(linesearch=True),
           ops/linesearch.py): path 1's growth leg (50 seeds, EquivSINDy-c)
           through sweep_sindy_lbfgs with every launch count 0 first, no K1
           or K4 launch allowed (K1 runs the fixed-lr protocol only), masks
           equal to the same call on the CPU on at least 48 of 50 seeds, and
           in float64 on every seed with coefficients within 1e-6 of the
           largest; then the EquivSINDy-r chunk (4 seeds, full width) for 3
           epochs through make_lbfgs_stepper with K2/K3 (counts 0 first: K2
           and K3 launched, K4 not) and with the plain f32 chains: finite,
           masks equal; recorded the largest coefficient gap and the
           closures per iteration (the search's trial steps); walls by
           utils/profiling.timed
  watchdog utils/watchdog.py on CUDA: the first-dispatch probe's 32 MB copy
           time above 0; three subprocesses started together, running while
           the linesearch phase does: a stalled first launch recovered by the
           relaunch (which probes the card), a second stall exiting 42, an
           unfed heartbeat relaunching with --resume
  profile  (--profile) utils/profiling.py's trace over one EquivSINDy-r epoch
           of the same chunk: device time by kernel family, launches, idle
           share, summarize_trace's top kernels
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
commands of their own, through the port's CLIs (README). The data, inputs,
timing helpers and phases that cli/kernel_ab.py runs too live in the
package (symmetry_ode_discovery_tpu_torch/smoke_setup.py); the gates are
this script's.
"""

import argparse
import json
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from symmetry_ode_discovery_tpu_torch.smoke_setup import (
    GP_SEEDS, GP_TOPK, H100_BYTES_PER_S, H100_F32_FLOPS, K23_ROW_REL, LALIGAN_RELOAD_ATOL,
    LALIGAN_STEP_REL, LV_LEVELS, RD_SOLVER_REL, RD_STEP_REL, SEEDS, SYMREG_ROWS, SYMREG_SEEDS,
    TAPE_SEEDS, device_ms, event_ms, flagship_models, gap_s, gp_args, gp_phase, k1_cases,
    adam_phase, dp_phase, k1_slowest_lane_reductions, laligan_phase, latent_phase,
    launch_key, linesearch_phase, ltp_phase, make_data, mesh_phase,
    not_bit_equal, path1, path1_outcomes, rd_ltp_phase, rd_phase, reset_launches, selkov_data,
    stlsq_phase, symmpen_phase, symmpen_width_phase, symreg_phase, tape_bound, tape_inputs,
    tape_shapes, watchdog_phase, wsindy_phase)

BUDGET_S = 600.0
HARD_LIMIT_S = 1100
K23_MAX_REL = 1e-4       # K2/K3: max |diff| over all rows, as a share of the output scale
ROW_SHARE_GATE = 1e-3    # K2/K3: at most this share of the rows may lie beyond K23_ROW_REL
K23_BF16_MAX_REL = 1e-2  # K2/K3 bf16: max |diff| (K2 fwd: all rows; the others: rows with no
                         # flipped mask) as a share of the output scale
K23_BF16_MASK_SHARE = 1e-3  # K2/K3 bf16: mask bits that may differ from the plain chain's
K5_MAX_REL = 1e-6        # K5: max |diff| over each element's magnitude (and bit-equal)
K6_MAX_REL = 1e-5        # K6: max |diff| over each element's sum of |row contributions|
SOLVER_MASK_SHARE = 0.96  # WSINDy/STLSQ: share of seeds whose masks equal the CPU run's
SOLVER_ATOL = 1e-3       # WSINDy/STLSQ: coefficients against the CPU run where masks agree
# template instantiations in -Xptxas -v: K1's 1-4 slices, K4's widths 16-128
PTXAS_KERNELS = {"lbfgs_sweep.cu": 4, "lbfgs_dir.cu": 5}
# the bf16 instantiations, gated the same way among all of their source's
# entries: K2/K3's three tile widths (symmpen.cu: 6 f32 entries, and 6 bf16
# ones, the forwards' and mode 2's)
# and K5's (tape_eval.cu: K6, K5 f32 and K5 bf16), whose only stack is the
# 32-byte frame its f32 twin and K6 have too: sinf/cosf's reduction of
# large arguments keeps its multi-word product in local memory (the
# kernels' SASS, cuobjdump)
PTXAS_BF16 = {"symmpen.cu": (12, r"symmpen_kernelILi\d+ELb1ELb1E", 6),
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


def profile_phase(dev, x, dx, emit_fn):
    """utils/profiling.py's trace over the first EquivSINDy-r epoch (20
    closures) of the 4-seed chunk, after the symreg phase warmed every
    kernel: device time by kernel family (a kernel counts to the Euler pair
    or the L-BFGS update when it starts inside that label's device-side
    span), kernel launches, the share of the epoch's wall time no kernel
    ran, and summarize_trace's top kernels by device time."""
    import torch
    from torch.autograd import DeviceType

    from symmetry_ode_discovery_tpu_torch.cli.profile_paths import busy_us
    from symmetry_ode_discovery_tpu_torch.utils.profiling import summarize_trace, trace
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
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir) as prof:
            t0 = time.perf_counter()
            carry = step(carry, 0)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        top = summarize_trace(log_dir, plane="device", top=12, print_table=False)
    events = prof.events()
    cpu_names = {e.name for e in events if getattr(e, "device_type", None) == DeviceType.CPU}
    on_device = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    # device-side events named like a host range are label spans (the
    # record_function labels and autograd Functions), not kernels
    labels = [e for e in on_device if e.name in cpu_names]
    kernels = [e for e in on_device if e.name not in cpu_names]
    if not kernels:
        raise RuntimeError("profile: the trace holds no device kernels")
    busy = busy_us(kernels)

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
    rec = {"phase": "profile", "iterations": 20, "lanes": SYMREG_SEEDS,
           "epoch_wall_ms_unprofiled": plain_wall_ms,
           "epoch_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us,
           "device_ms_by_family": ms, "launches_by_family": counts,
           "kernel_launches": len(kernels),
           "top_kernels_by_device_ms": [(name[:80], sec * 1e3, n) for name, sec, n in top]}
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
        line.update({k: rec[k] for k in ("flip_rows", "max_abs_err_agreeing_rows",
                                         "max_abs_err_flip_rows")})
        if "mask_bits" in rec:
            line.update({k: rec[k] for k in ("mask_bits", "mask_bits_differ",
                                             "mask_bits_differ_not_near_0")})
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


def with_mesh_launches(line, mesh):
    """The kernels line with each kernel's launches on the mesh phase's
    sharded paths (K1: path 1; K2-K4: the EquivSINDy-r chunk; K5/K6: the
    GP chunk) beside its main path's."""
    counts = dict(mesh["symreg"]["launches"], lbfgs_sweep=mesh["path1"]["launches"],
                  **{k: v for k, v in mesh["gp"]["launches"].items() if k.startswith("tape")})
    for k in line["kernels"]:
        k["mesh_launches"] = counts[launch_key(k["name"])]
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

    # ---- 9. WSINDy and STLSQ through their CLIs, against the CPU ----
    solvers = [wsindy_phase(dev, x99.reshape(200, 10000, 2), emit)]
    clock.check("wsindy")
    solvers.append(stlsq_phase(dev, x99, dx99, emit))
    clock.check("stlsq")

    # ---- 10. path 4: LaLiGAN symmetry discovery through the CLI ----
    laligan = laligan_phase(dev, x99, dx99, emit)
    clock.check("laligan")

    # ---- 11. path 5: the rd data and joint SINDy-in-latent through the CLI,
    # then the latent equation's rollout on its checkpoint ----
    with tempfile.TemporaryDirectory() as rd_dir:
        rd = rd_phase(dev, emit, workdir=rd_dir)
        clock.check("rd")
        new_phases = [rd_ltp_phase(dev, rd, rd_dir, emit)]
        clock.check("rd_ltp")
        # ---- 11b. the multi-device layer: seed sharding of paths 1-3, and
        # data-parallel LaLiGAN training on LV and on the rd data ----
        mesh = mesh_phase(dev, xs, dxs, xg, dxg, res_lv, res_g, x99, dx99, emit)
        new_phases.append(mesh)
        clock.check("mesh")
        new_phases.append(dp_phase(dev, x99, dx99, rd_dir, emit))
        clock.check("dp")

    # ---- 12. long-term prediction of path 1's LV noise-0.99 sweep; the Adam
    # trainer and the latent-space fit on selkov ----
    new_phases.append(ltp_phase(dev, res_lv, emit))
    clock.check("ltp")
    x_sk, dx_sk = selkov_data(dev)
    new_phases.append(adam_phase(dev, x_sk, dx_sk, emit))
    clock.check("adam")
    new_phases.append(latent_phase(dev, x_sk, dx_sk, emit))
    clock.check("latent")

    # ---- 13. the zoom line-search L-BFGS (K2/K3 in every trial of its
    # search) and the stall watchdog on CUDA ----
    # the watchdog's subprocesses wait on their windows and on torch's
    # import while the linesearch phase runs
    wd, ls = watchdog_phase(dev, emit, during=lambda: linesearch_phase(
        dev, xg, dxg, x99, dx99, emit))
    new_phases += [ls, wd]
    clock.check("linesearch and watchdog")
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
            limit = K23_BF16_MAX_REL * rec["scale"]
            if not rec["finite"]:
                failures.append(f"{name} at width {width}: not finite")
            if name.startswith("symmpen_enc_fwd"):  # continuous in the masks: every row
                if not rec["max_abs_err"] <= limit:
                    failures.append(f"{name} at width {width}: max |diff| {rec['max_abs_err']} "
                                    f"(limit {K23_BF16_MAX_REL} of the output scale "
                                    f"{rec['scale']})")
            else:  # a row gated by a flipped mask moves with it
                if not rec["max_abs_err_agreeing_rows"] <= limit:
                    failures.append(f"{name} at width {width}: max |diff| "
                                    f"{rec['max_abs_err_agreeing_rows']} on the rows whose masks "
                                    f"agree (limit {K23_BF16_MAX_REL} of the output scale "
                                    f"{rec['scale']})")
                if rec["flip_rows"] > ROW_SHARE_GATE * rec["rows"]:
                    failures.append(f"{name} at width {width}: {rec['flip_rows']} of {rec['rows']} "
                                    f"rows gated by a flipped mask (limit {ROW_SHARE_GATE} of "
                                    "the rows)")
            if "mask_bits" in rec and rec["mask_bits_differ"] > K23_BF16_MASK_SHARE * rec["mask_bits"]:
                failures.append(f"{name} at width {width}: {rec['mask_bits_differ']} of "
                                f"{rec['mask_bits']} mask bits differ from the plain bf16 "
                                f"chain's (limit {K23_BF16_MASK_SHARE} of them)")
            if rec.get("mask_bits_differ_not_near_0"):
                failures.append(f"{name} at width {width}: {rec['mask_bits_differ_not_near_0']} "
                                "mask bits differ from the plain bf16 chain's where |p| is "
                                f"beyond {rec['mask_rel']} of its terms")
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

    for rec in solvers:
        tag = f"{rec['phase']} ({rec['config']}, {rec['seeds']} seeds)"
        if not rec["finite"] or rec["Xi_shape"] != [rec["seeds"], 2, 8]:
            failures.append(f"{tag}: coefficients of shape {rec['Xi_shape']}, finite "
                            f"{rec['finite']}")
        if rec["masks_equal_cpu"] < SOLVER_MASK_SHARE * rec["seeds"]:
            failures.append(f"{tag}: masks equal to the CPU run's on {rec['masks_equal_cpu']} "
                            f"seeds (limit {SOLVER_MASK_SHARE} of them)")
        if not rec["max_coef_diff_cpu"] <= SOLVER_ATOL:
            failures.append(f"{tag}: coefficients {rec['max_coef_diff_cpu']} from the CPU run's "
                            f"where masks agree (limit {SOLVER_ATOL})")

    if not laligan["finite"]:
        failures.append(f"LaLiGAN: a non-finite component in {laligan['history']}")
    if (not laligan["reload_max_abs_err"] <= LALIGAN_RELOAD_ATOL
            or not laligan["reload_masks_equal"]):
        failures.append(f"LaLiGAN: the reloaded checkpoint's encoder lies "
                        f"{laligan['reload_max_abs_err']} from the trainer's (limit "
                        f"{LALIGAN_RELOAD_ATOL}), masks equal {laligan['reload_masks_equal']}")
    if not laligan["step_card_vs_cpu"]["max_rel"] <= LALIGAN_STEP_REL:
        failures.append(f"LaLiGAN: one step on the card lies {laligan['step_card_vs_cpu']} "
                        f"from the CPU's (limit {LALIGAN_STEP_REL} relative)")

    if not rd["finite"]:
        failures.append(f"rd: a non-finite component in {rd['history_last']}")
    if not max(rd["solver_rel_card_cpu"].values()) <= RD_SOLVER_REL:
        failures.append(f"rd: the solver on the card lies {rd['solver_rel_card_cpu']} from the "
                        f"CPU's, of the field's maximum (limit {RD_SOLVER_REL})")
    if not rd["reload_max_abs_err"] <= LALIGAN_RELOAD_ATOL or not rd["regressor_equal"]:
        failures.append(f"rd: the reloaded encoder lies {rd['reload_max_abs_err']} from the "
                        f"trainer's (limit {LALIGAN_RELOAD_ATOL}), regressor.npz equal "
                        f"{rd['regressor_equal']}")
    step = rd["step_card_vs_cpu"]
    if not step["max_rel"] <= RD_STEP_REL or not step["masks_equal"]:
        failures.append(f"rd: one joint step on the card lies {step['max_rel']} from the CPU's "
                        f"(limit {RD_STEP_REL} relative), masks equal {step['masks_equal']}")
    if any(rd["launches"].values()):
        failures.append(f"rd: the path launched a hand-written kernel: {rd['launches']}")
    for rec in new_phases:
        failures += rec["failures"]

    print(smi, flush=True)
    emit({"phase": "total", "seconds": clock.elapsed(), "budget_s": BUDGET_S,
          "failures": failures})
    # ---- 14. kernels ----
    emit(with_mesh_launches({"kernels": [{
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
        + [tape_bf16_line(tape, gp_bf16)]}, mesh))
    if failures:
        raise SystemExit("chip_smoke failed: " + "; ".join(failures))
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
