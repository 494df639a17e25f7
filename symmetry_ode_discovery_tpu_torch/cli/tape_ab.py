"""K5 and K6 of this tree against another build of csrc/tape_eval.cu, in
turns on one card.

    python -m symmetry_ode_discovery_tpu_torch.cli.tape_ab --other <tape_eval.cu> \\
        [--rounds other,this,this,other] [--gp]
    python -m symmetry_ode_discovery_tpu_torch.cli.tape_ab --other <tape_eval.cu> \\
        --main_gp -- <cli/main_gp.py arguments>

Run from the repository's root (it reads chip_smoke.py's phases). Makes the
LV noise-0.99 training split on the card and, for each GP leg, the K5 and K6
inputs of one generation at full size (chip_smoke.py's tape_inputs: 10
seeds; plain 20 units x 1024 tapes on 2,500 rows, EquivGP-r 10 units x 2048
tapes on 5,000 rows; K6 on the top-256 groups and the first 512 or 1,024
rows). Builds both sources with the same flags, then runs the rounds in the
order given. Each times K5 on the population and K6 on its shape (one
launch between CUDA events, ``ms``, and the device time of 20 back-to-back
launches queued behind a sleep, ``device_ms``), then each shape a
generation launches at the units of chip_smoke.py's gp phase (its
tape_shapes) and each kernel's launches x (time - bound) per chunk by
either time. Checks that each side's K5 gives the plain interpreter's bits
and reports K6's largest difference between the sides over the largest
|gradient|. One JSON line per round and leg, then a summary with each
time's mean per side and their ratio; exits non-zero if a side's K5 is not
bit-equal to the plain version. With --gp, chip_smoke.py's gp phase then
runs once per round with that side's kernels (chunk wall, device and host
seconds per generation, outcomes).

With --main_gp, it instead runs the GP CLI (cli/main_gp.py) once on the
arguments after ``--`` with the other build in place of this tree's, so that
two builds can be held against each other seed by seed (compare_evals.py on
the two --eval_root directories).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def other_build(source):
    """K5 and K6's launchers built from ``source``. The wrapper's size check
    (ops/tape_eval.py::geometry) asks this tree's launcher, since an earlier
    source need not export tape_eval_geometry."""
    from symmetry_ode_discovery_tpu_torch.ops import _nvcc
    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te

    this = te.KERNEL

    class OtherBuild(_nvcc.Kernel):
        def lib(self):
            if self._lib is None:
                super().lib().tape_eval_geometry = this.lib().tape_eval_geometry
            return self._lib

    return OtherBuild(Path(source), te.NVCC_FLAGS,
                      {k: v for k, v in this.signatures.items() if k.endswith("_launch")})


def run_main_gp(other, argv):
    """cli/main_gp.py on argv, with K5 and K6 built from ``other``."""
    from symmetry_ode_discovery_tpu_torch.cli import main_gp
    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te

    te.KERNEL = other_build(other)
    main_gp.main(argv)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another tape_eval.cu")
    parser.add_argument("--rounds", default="other,this,this,other")
    parser.add_argument("--gp", action="store_true",
                        help="then chip_smoke.py's gp phase (one chunk of each GP leg through "
                             "cli/main_gp.py) with each side's kernels, in the same order")
    parser.add_argument("--main_gp", action="store_true",
                        help="run cli/main_gp.py on the arguments after -- with the other "
                             "build, and nothing else")
    opts = parser.parse_args(argv[:cut])
    if opts.main_gp:
        return run_main_gp(opts.other, argv[cut + 1:])
    import torch

    if not torch.cuda.is_available():
        print("tape_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed
    from symmetry_ode_discovery_tpu_torch.ops import _nvcc
    from symmetry_ode_discovery_tpu_torch.ops import tape_eval as te
    from symmetry_ode_discovery_tpu_torch.symgp.tape import eval_tapes_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}), flush=True)
    kernels = {"this": te.KERNEL, "other": other_build(opts.other)}
    _nvcc.build_all(kernels.values())
    print(json.dumps({"build": {side: {"seconds": k.info["seconds"], "ptxas": [
        ln.strip() for ln in k.info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]}
        for side, k in kernels.items()}}), flush=True)

    dev = torch.device("cuda", 0)
    lv = SYSTEMS["lv"]
    gen = torch.Generator(device=dev).manual_seed(cache_seed("train", 0.99))
    x, dx = gen_data(lv, gen, noise=0.99, multiplicative_noise=lv.multiplicative_noise,
                     smoothing="gp", device=dev)
    x, dx = x.reshape(-1, 2), dx.reshape(-1, 2)
    legs = {leg: cs.tape_inputs(dev, x, dx, leg) for leg in ("plain", "equivgp_r")}
    want = {leg: eval_tapes_plain(t.ops, t.args, t.consts, t.pts, t.depth, t.table)
            for leg, t in legs.items()}
    shapes = {leg: cs.tape_shapes(t, leg) for leg, t in legs.items()}
    grads = {}
    times = {}
    failures = []
    for r, side in enumerate(opts.rounds.split(",")):
        te.KERNEL = kernels[side]
        for leg, t in legs.items():
            k5 = lambda: te.eval_tapes_kernel(t.ops, t.args, t.consts, t.pts, t.depth, t.table)
            k6 = lambda: te.eval_tapes_grad_kernel(t.sops, t.sargs, t.sconsts, t.spts, t.gbar,
                                                   t.depth, t.table)
            not_bit_equal = cs.not_bit_equal(k5(), want[leg])
            g = k6()
            ref = grads.setdefault(leg, g)
            ok = torch.isfinite(ref) & torch.isfinite(g)
            k6_rel = float(torch.where(ok, (g - ref).abs(), 0.0).max()
                           / torch.where(ok, ref.abs(), 0.0).max().clamp_min(1e-30))
            rec = {"round": r, "side": side, "leg": leg, "k5_not_bit_equal": not_bit_equal,
                   "k6_max_diff_over_max_grad": k6_rel,
                   "k6_finite_mismatch": int((torch.isfinite(g) != torch.isfinite(ref)).sum()),
                   "k5_ms": cs.event_ms(k5, 5), "k5_device_ms": cs.device_ms(k5),
                   "k6_ms": cs.event_ms(k6, 5), "k6_device_ms": cs.device_ms(k6)}
            gap = {}
            for srec, fn in shapes[leg]:
                ms, dms, n = cs.event_ms(fn, 5), cs.device_ms(fn), srec["launches_per_chunk"]
                name, shape = srec["kernel"], srec["shape"]
                rec[f"{name} {shape} ms"] = ms
                rec[f"{name} {shape} device_ms"] = dms
                gap[f"{name} gap_s_per_chunk"] = (gap.get(f"{name} gap_s_per_chunk", 0.0)
                                                  + cs.gap_s(n, ms, srec["bound_ms"]))
                gap[f"{name} device_gap_s_per_chunk"] = (
                    gap.get(f"{name} device_gap_s_per_chunk", 0.0)
                    + cs.gap_s(n, dms, srec["bound_ms"]))
            rec.update(gap)
            print(json.dumps(rec), flush=True)
            if not_bit_equal:
                failures.append(f"{side} K5 ({leg}): {not_bit_equal} elements not bit-equal")
            for key, value in rec.items():
                if key.endswith(("ms", "per_chunk")):
                    times.setdefault((leg, key, side), []).append(value)
    for r, side in enumerate(opts.rounds.split(",") if opts.gp else []):
        te.KERNEL = kernels[side]
        for leg, rec in cs.gp_phase(dev, x, dx, lambda rec: None).items():
            keep = {k: rec[k] for k in ("chunk_wall_s", "device_s_per_gen", "host_s_per_gen",
                                        "joint", "eq0", "eq1", "launches")}
            print(json.dumps({"round": r, "side": side, "leg": leg, "gp": keep}), flush=True)
            for key in ("chunk_wall_s", "device_s_per_gen", "host_s_per_gen"):
                times.setdefault((leg, "gp " + key, side), []).append(rec[key])
    te.KERNEL = kernels["this"]
    summary = {}
    for (leg, key, side), ts in sorted(times.items()):
        summary.setdefault(leg, {}).setdefault(key, {})[side] = sum(ts) / len(ts)
    for leg in summary.values():
        for sides in leg.values():
            if "this" in sides and "other" in sides:
                sides["other_over_this"] = sides["other"] / sides["this"]
    print(json.dumps({"summary": summary, "device": smi, "failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
