#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path, the multi-seed L-BFGS discovery sweep, at full
size through its public entry points, and holds the hand-written kernel
against its plain PyTorch version. One JSON line per phase, flushed as it
ends, so a stall shows where it happened:

  device   nvidia-smi's name and power limit, torch's device name
  build    nvcc build of csrc/lbfgs_sweep.cu into build/torch_kernels/
  data     gen_data on the card: the LV train split at the 11 noise levels
           (200 ICs x 10000 RK4 steps each) and the growth train split at
           noise 0.05; kept in memory, no cache written
  kernel   K1 against lbfgs_sweep_plain on the inputs of the main path's two
           launches (50 growth lanes; 550 LV lanes, 11 levels x 50 seeds):
           per-lane mask and stop-epoch mismatches (also per level; every
           level is held to >= 49 of 50 agreeing lanes), max |dtheta|, median
           kernel ms over 5 runs, plain ms, warm prep ms, the bound
  sweep    the main path with every launch count set to 0 first: 11 LV
           levels x 50 seeds in one stacked sweep (plain SINDy) and growth
           EquivSINDy-c x 50 seeds, a warm pass then a timed pass each
  kernels  one line per ported kernel, with its launches on the main path,
           agreement with the plain version, times and bound

The last line is {"ok": true, "device": {...}}. Any failed check raises and
the script exits non-zero without it. It exits non-zero at once when there
is no CUDA device. Budget: 600 s for the whole run, build included; a hard
alarm ends the process at 1100 s.
"""

import json
import signal
import subprocess
import sys
import time

BUDGET_S = 600.0
HARD_LIMIT_S = 1100
H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores, data sheet (SXM)
LV_LEVELS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.99]
SEEDS = list(range(50))


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
    mask_bad = torch.nonzero(~mask_ok).flatten().tolist()
    stop_bad = torch.nonzero(~stop_ok).flatten().tolist()
    diff = (th_k - th_p).abs()
    both_nan = torch.isnan(th_k) & torch.isnan(th_p)
    diff = torch.where(both_nan, torch.zeros_like(diff), diff)
    agree = mask_ok.nonzero().flatten()
    max_diff = float(diff[agree].max()) if len(agree) else float("nan")
    kernel_ms = event_ms(lambda: k1.lbfgs_sweep(cfg, *inputs, Mmap), 5)
    bad = (~mask_ok | ~stop_ok).reshape(-1, group).sum(dim=1)
    stops = stop_k.float()
    out = {"phase": "kernel", "case": name, "lanes": lanes,
           "mask_mismatch": len(mask_bad), "mask_mismatch_lanes": mask_bad,
           "stop_mismatch": len(stop_bad), "stop_mismatch_lanes": stop_bad,
           "mismatch_by_group": bad.tolist(),
           "max_abs_diff": max_diff, "ms": kernel_ms, "plain_ms": plain_ms,
           "prep_ms": prep_ms,
           "stop_epoch_min_median_max": [float(stops.min()), float(stops.median()),
                                         float(stops.max())]}
    out.update(k1_bound(cfg, lanes, work.cpu(), Mmap is not None))
    for lane in sorted(set(mask_bad) | set(stop_bad)):
        out.setdefault("mismatches", []).append({
            "lane": lane, "stop_kernel": int(stop_k[lane]), "stop_plain": int(stop_p[lane]),
            "mask_kernel": mask_k[lane].flatten().tolist(),
            "mask_plain": mask_p[lane].flatten().tolist()})
    emit(out)
    return out


def main():
    clock = Clock()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1
    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed
    from symmetry_ode_discovery_tpu_torch.evaluation import sindy_truth
    from symmetry_ode_discovery_tpu_torch.models.sindy import make_config
    from symmetry_ode_discovery_tpu_torch.ops import lbfgs_sweep as k1
    from symmetry_ode_discovery_tpu_torch.training.siged import LBFGSHParams
    from symmetry_ode_discovery_tpu_torch.training.sweep import (
        stacked_lanes, sweep_sindy_lbfgs, sweep_sindy_lbfgs_stacked)

    signal.alarm(HARD_LIMIT_S)
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ----
    k1.build()
    ptxas = [ln.strip() for ln in k1.build_info["ptxas"].splitlines()
             if "registers" in ln or "bytes stack" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": k1.build_info["seconds"],
          "compiled": k1.build_info["compiled"], "library": k1.build_info["path"],
          "ptxas": ptxas})
    clock.check("build")

    # ---- 3. data ----
    t0 = time.perf_counter()
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
    xg, dxg = xg.reshape(-1, 2), dxg.reshape(-1, 2)
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "lv": {"levels": LV_LEVELS, "shape": [200, 10000, 2]},
          "growth": {"noise": 0.05, "shape": [100, 100, 2]}})
    clock.check("data")

    # protocols of bench.py legs 1-2
    cfg_lv, _ = make_config(2, poly_order=2, include_exp=True, threshold=0.15)
    hp_lv = LBFGSHParams(num_epochs=100, lr_sindy=0.1, w_sindy_x=1.0, w_sindy_reg=0.0,
                         sindy_reg_type="l1", st_freq=20, threshold=0.15)
    L_scaling2 = np.array([[2.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    cfg_g, Q_g = make_config(2, poly_order=2, L_list=[L_scaling2],
                             constrain_constant=True, threshold=5e-2)
    hp_g = LBFGSHParams(num_epochs=100, lr_sindy=1.0, w_sindy_x=1.0, w_sindy_reg=0.0,
                        sindy_reg_type="l1", st_freq=100, threshold=5e-2)

    # ---- 4. kernel against its plain version, on the main path's launches ----
    checks = {}
    for name, cfg, Q, hp, x_list, dx_list, sub in [
            ("growth_esindy", cfg_g, Q_g, hp_g, [xg], [dxg], 0.5),
            ("lv_sindy_allnoise", cfg_lv, None, hp_lv, xs, dxs, 0.01)]:
        stacked_lanes(cfg, Q, x_list, dx_list, hp, SEEDS, sub, dev)  # warm pass
        torch.cuda.synchronize()
        t_prep = time.perf_counter()
        pcfg, lanes, Mmap = stacked_lanes(cfg, Q, x_list, dx_list, hp, SEEDS, sub, dev)
        torch.cuda.synchronize()
        t_prep = (time.perf_counter() - t_prep) * 1e3  # subsample + normal equations
        checks[name] = compare_k1(name, k1, pcfg, lanes, Mmap,
                                  len(x_list) * len(SEEDS), len(SEEDS), t_prep)
    clock.check("kernel")

    # ---- 5. the main path ----
    k1.launches = 0
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
    main_launches = k1.launches

    def joint(res):
        return np.all(res.correct_form > 0, axis=1)

    by_noise = {f"{nl:.2f}": int(joint(r).sum()) for nl, r in zip(LV_LEVELS, res_lv)}
    ok_g = joint(res_g)
    rmse_g = float(np.mean(np.sqrt(res_g.mse[ok_g]))) if ok_g.any() else float("nan")
    emit({"phase": "sweep", "seeds": len(SEEDS), "walls": walls,
          "kernel_launches": main_launches,
          "lv_sindy_success_by_noise": by_noise,
          "growth_esindy_joint_success": int(ok_g.sum()),
          "growth_esindy_rmse": rmse_g,
          "growth_esindy_ref": {"joint_success": 50, "rmse": 0.0143}})
    clock.check("sweep")

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

    print(smi, flush=True)
    emit({"phase": "total", "seconds": clock.elapsed(), "budget_s": BUDGET_S,
          "failures": failures})
    # ---- 6. kernels ----
    emit({"kernels": [{
        "name": "lbfgs_sweep", "route": "cuda",
        "source": "symmetry_ode_discovery_tpu_torch/csrc/lbfgs_sweep.cu",
        "replaces": "symmetry_ode_discovery_tpu/ops/pallas_lbfgs.py:87",
        "launches": main_launches,
        "max_abs_err": max_diff, "max_abs_diff": max_diff,
        "mask_mismatch": lv_check["mask_mismatch"] + g_check["mask_mismatch"],
        "ms": lv_check["ms"], "plain_ms": lv_check["plain_ms"],
        "bound_ms": lv_check["bound_ms"], "bound_by": lv_check["bound_by"],
        "library_ms": None,
        "shapes": f"{lv_check['lanes']} LV lanes (11 levels x 50 seeds), d=2, p=8, n=16",
        "growth_ms": g_check["ms"], "growth_plain_ms": g_check["plain_ms"],
        "growth_bound_ms": g_check["bound_ms"], "growth_bound_by": g_check["bound_by"],
        "growth_shapes": f"{g_check['lanes']} lanes, d=2, p=6, n={cfg_g.n_free}"}]})
    if failures:
        raise SystemExit("chip_smoke failed: " + "; ".join(failures))
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
