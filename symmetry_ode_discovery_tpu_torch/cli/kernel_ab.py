"""The port's kernels against other builds of their sources, in turns on
one card.

    python -m symmetry_ode_discovery_tpu_torch.cli.kernel_ab --other <source.cu> \\
        [--other <source.cu> ...] [--rounds other,this,this,other] [--paths] [--gp]
    python -m symmetry_ode_discovery_tpu_torch.cli.kernel_ab --other <source.cu> \\
        --main_gp -- <cli/main_gp.py arguments>
    python -m symmetry_ode_discovery_tpu_torch.cli.kernel_ab --other <source.cu> \\
        --main -- <cli/main.py arguments>

It runs the smoke run's phases (smoke_setup.py). Each --other is a copy of
one of the port's kernel sources, recognised by its file name:
lbfgs_sweep.cu (K1), symmpen.cu (K2/K3), lbfgs_dir.cu (K4) or tape_eval.cu
(K5/K6), built with this tree's flags for that source. Each
round puts one side's builds in place ("this": the tree's own) and times, at
the smoke run's shapes, one launch between CUDA events (``ms``) and the
device time of 20 back-to-back launches queued behind a sleep
(``device_ms``) of each compared kernel, and its agreement:

- K1 on path 1's two launches (550 LV lanes, 50 growth lanes): lanes whose
  theta bits, mask or stop epoch differ from the first "this" round's, lanes
  whose mask or stop epoch differs from the plain version's, and the device
  ns per dependent reduction of the slowest lane (its loss/gradient
  evaluations x 2 + 2 x its two-loop pairs, from the kernel's work counts);
- K4 at the flagship's shape (4 lanes, 100 pairs, 16 parameters): elements
  not bit-equal to the first "this" round's and to the plain version's;
- K2/K3 on one EquivSINDy-r closure (the smoke run's symmpen phase) and at
  width 128 (its selkov case), in f32 and in bf16: max |diff|, mask bits
  and flip rows against the plain chain, the output elements and forward
  mask bits not bit-equal to this tree's build's (a pass before the
  rounds), and each backward's output elements not bit-equal to this
  tree's when both read this tree's forward masks;
- K5/K6 on one generation of each GP leg, at every shape a generation
  launches: K5's elements not bit-equal to the plain interpreter's, K6's
  largest difference from the first round's over the largest |gradient|,
  launches x (time - bound) per chunk; K5's bf16 mode at every shape a
  --gp_eval_dtype bf16 generation launches it, the same way.

With --paths each round then runs path 1 (LV successes by noise level,
growth joint successes, sweep walls) and one 4-seed EquivSINDy-r chunk
through cli/main.py (wall, outcomes, coefficients against the first "this"
round's) with that side's builds; with --gp, one chunk of each GP leg. A
pass of these with this tree's builds comes before the rounds, so that no
round carries the process's one-time costs. One JSON line per round, then a
summary with each time's mean per side and their ratio; exits non-zero if a
side's K5 (f32 or bf16) is not bit-equal to the plain version.

With --main_gp (--main), it instead runs the GP CLI, cli/main_gp.py (the
SINDy family's CLI, cli/main.py), once on the arguments after ``--`` with
the other builds in place of this tree's, so that two builds can be held
against each other seed by seed (compare_evals.py on the two --eval_root
directories).
"""

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

SOURCES = ("lbfgs_sweep", "symmpen", "lbfgs_dir", "tape_eval")


def other_build(source):
    """(the wrapper module of ``source``'s kernels, their build from
    ``source``). K5/K6's size check (ops/tape_eval.py::geometry) asks this
    tree's launcher, since an earlier source need not export
    tape_eval_geometry; a symmpen.cu without symmpen_cluster launches no
    clusters (1 CTA each)."""
    from symmetry_ode_discovery_tpu_torch.ops import _nvcc

    stem = Path(source).stem
    if stem not in SOURCES:
        raise ValueError(f"{source}: not one of the port's kernel sources {SOURCES}")
    mod = importlib.import_module(f"symmetry_ode_discovery_tpu_torch.ops.{stem}")
    this = mod.KERNEL
    if stem == "symmpen":
        class SymmpenBuild(_nvcc.Kernel):
            def lib(self):
                if self._lib is None:
                    lib = super().lib()
                    if not hasattr(lib, "symmpen_cluster"):
                        lib.symmpen_cluster = lambda: 1
                return self._lib

        return mod, SymmpenBuild(Path(source), mod.NVCC_FLAGS,
                                 {k: v for k, v in this.signatures.items()
                                  if k != "symmpen_cluster"})
    if stem != "tape_eval":
        return mod, _nvcc.Kernel(Path(source), mod.NVCC_FLAGS, this.signatures)

    class OtherBuild(_nvcc.Kernel):
        def lib(self):
            if self._lib is None:
                super().lib().tape_eval_geometry = this.lib().tape_eval_geometry
            return self._lib

    return mod, OtherBuild(Path(source), mod.NVCC_FLAGS,
                           {k: v for k, v in this.signatures.items() if k.endswith("_launch")})


def k1_round(cs, k1, cases, plain, ref):
    """K1 at path 1's two launches with the builds in place: times, lanes
    not bit-equal to ``ref`` (filled on the first call), mask/stop
    mismatches against ``plain``, the slowest lane's ns per reduction."""
    import torch

    rec = {}
    for name, (pcfg, lanes, Mmap, n_lanes, _) in cases.items():
        work = torch.zeros((n_lanes, 2), dtype=torch.int32, device=lanes[0].device)
        th, mask, stop = k1.lbfgs_sweep(pcfg, *lanes, Mmap, work=work)
        th0, mask0, stop0 = ref.setdefault(name, (th, mask, stop))
        same = ((th.view(torch.int32) == th0.view(torch.int32)).all(1)
                & (mask == mask0).all(dim=(1, 2)) & (stop == stop0))
        mp, sp = plain[name]
        fn = lambda: k1.lbfgs_sweep(pcfg, *lanes, Mmap)
        dms = cs.device_ms(fn)
        chain = cs.k1_slowest_lane_reductions(work)
        rec[f"K1 {name}"] = {
            "ms": cs.event_ms(fn, 5), "device_ms": dms,
            "lanes_not_bit_equal_to_first_this": int((~same).sum()),
            "lanes_mask_or_stop_differ_from_plain": int(
                (~((mask == mp).all(dim=(1, 2)) & (stop == sp))).sum()),
            "slowest_lane_reductions": chain, "chain_ns_per_reduction": dms * 1e6 / chain}
    return rec


def k4_round(cs, k4, inputs, want, ref):
    """K4 at the flagship's shape with the build in place."""
    out = k4.two_loop_direction(*inputs)
    ref0 = ref.setdefault("K4", out)
    fn = lambda: k4.two_loop_direction(*inputs)
    return {"K4": {"ms": cs.event_ms(fn, 21), "device_ms": cs.device_ms(fn),
                   "not_bit_equal_to_first_this": cs.not_bit_equal(out, ref0),
                   "not_bit_equal_to_plain": cs.not_bit_equal(out, want),
                   "max_abs_err": float((out - want).abs().max())}}


def symmpen_round(cs, dev, x, ref):
    """K2/K3 in f32 and bf16 at width 512 (one closure) and 128 with the
    build in place: times and agreement with the plain chain, and the
    output elements and forward mask bits not bit-equal to ``ref`` (filled
    by the first call, a pass with this tree's build before the rounds);
    each backward also on ``ref``'s forward masks, its output against
    ``ref``'s."""
    import torch

    from symmetry_ode_discovery_tpu_torch.ops import symmpen as sp

    popcount = torch.tensor([bin(i).count("1") for i in range(256)], device=dev)
    out = {}
    for width, phase in ((512, lambda o: cs.symmpen_phase(dev, x, lambda r: None, outputs=o)),
                         (128, lambda o: cs.symmpen_width_phase(dev, lambda r: None, outputs=o))):
        got = {}
        f32, bf16 = phase(got)
        first = ref.setdefault(width, got)
        for name, srec in {**f32, **bf16}.items():
            if name == "lbfgs_dir":
                continue
            rec = {k: srec[k] for k in ("ms", "device_ms", "max_abs_err", "scale",
                                        "mask_bits_differ", "mask_bits_differ_not_near_0",
                                        "flip_rows", "max_abs_err_agreeing_rows",
                                        "max_abs_err_flip_rows") if k in srec}
            rec["not_bit_equal_to_first_this"] = cs.not_bit_equal(got[name], first[name])
            if name + " masks" in got:
                diff = torch.bitwise_xor(got[name + " masks"], first[name + " masks"])
                rec["mask_bits_not_equal_to_first_this"] = int(popcount[diff.long()].sum())
            kind = name.removeprefix("symmpen_").removesuffix("_bf16")
            if kind in got["inputs"]:
                f, cz = got["inputs"][kind]
                fwd = name.replace(kind, "enc_fwd" if kind == "enc_bwd" else "dec_jvp")
                dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
                fed = getattr(sp, kind + "_kernel")(f, first[fwd + " masks"], cz, dtype)
                rec["on_first_this_masks_not_bit_equal"] = cs.not_bit_equal(fed, first[name])
            out[f"symmpen {name}" + ("" if width == 512 else f" w{width}")] = rec
    return out


def tape_round(cs, te, legs, want, shapes, grads, bf16_shapes, bf16_want):
    """K5/K6 on one generation of each GP leg with the builds in place, then
    K5's bf16 mode at every shape a --gp_eval_dtype bf16 generation launches
    it (smoke_setup.tape_bf16_shapes): its elements not bit-equal to the
    plain version in bf16 on every unit (``bf16_want``), its times at the
    gp phase's units."""
    import torch

    out = {}
    for leg, t in legs.items():
        k5 = lambda: te.eval_tapes_kernel(t.ops, t.args, t.consts, t.pts, t.depth, t.table)
        k6 = lambda: te.eval_tapes_grad_kernel(t.sops, t.sargs, t.sconsts, t.spts, t.gbar,
                                               t.depth, t.table)
        g = k6()
        ref = grads.setdefault(leg, g)
        ok = torch.isfinite(ref) & torch.isfinite(g)
        rec = {"k5_not_bit_equal": cs.not_bit_equal(k5(), want[leg]),
               "k6_max_diff_over_max_grad": float(
                   torch.where(ok, (g - ref).abs(), 0.0).max()
                   / torch.where(ok, ref.abs(), 0.0).max().clamp_min(1e-30)),
               "k6_finite_mismatch": int((torch.isfinite(g) != torch.isfinite(ref)).sum()),
               "k5_ms": cs.event_ms(k5, 5), "k5_device_ms": cs.device_ms(k5),
               "k6_ms": cs.event_ms(k6, 5), "k6_device_ms": cs.device_ms(k6)}
        for srec, fn in shapes[leg]:
            ms, dms, n = cs.event_ms(fn, 5), cs.device_ms(fn), srec["launches_per_chunk"]
            name, shape = srec["kernel"], srec["shape"]
            rec[f"{name} {shape} ms"] = ms
            rec[f"{name} {shape} device_ms"] = dms
            for key, t_ in (("gap_s_per_chunk", ms), ("device_gap_s_per_chunk", dms)):
                rec[f"{name} {key}"] = rec.get(f"{name} {key}", 0.0) + cs.gap_s(
                    n, t_, srec["bound_ms"])
        rec["k5_bf16_not_bit_equal"] = 0
        for (srec, fn, full, _, _), w in zip(bf16_shapes[leg], bf16_want[leg]):
            rec["k5_bf16_not_bit_equal"] += cs.not_bit_equal(full(), w)
            ms, dms, n = cs.event_ms(fn, 5), cs.device_ms(fn), srec["launches_per_chunk"]
            rec[f"K5_bf16 {srec['shape']} ms"] = ms
            rec[f"K5_bf16 {srec['shape']} device_ms"] = dms
            for key, t_ in (("gap_s_per_chunk", ms), ("device_gap_s_per_chunk", dms)):
                rec[f"K5_bf16 {key}"] = rec.get(f"K5_bf16 {key}", 0.0) + cs.gap_s(
                    n, t_, srec["bound_ms"])
        out[f"tape {leg}"] = rec
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", required=True,
                        help="another build's source: lbfgs_sweep.cu, symmpen.cu, lbfgs_dir.cu "
                             "or tape_eval.cu (repeat for several)")
    parser.add_argument("--rounds", default="other,this,this,other")
    parser.add_argument("--paths", action="store_true",
                        help="then path 1 and one EquivSINDy-r chunk per round")
    parser.add_argument("--gp", action="store_true",
                        help="then the smoke run's gp phase (one chunk of each GP leg through "
                             "cli/main_gp.py) per round")
    parser.add_argument("--main_gp", action="store_true",
                        help="run cli/main_gp.py on the arguments after -- with the other "
                             "builds, and nothing else")
    parser.add_argument("--main", action="store_true",
                        help="run cli/main.py on the arguments after -- with the other "
                             "builds, and nothing else")
    opts = parser.parse_args(argv[:cut])
    builds = dict(other_build(src) for src in opts.other)
    if opts.main_gp or opts.main:
        from symmetry_ode_discovery_tpu_torch.cli import main as main_cli, main_gp

        for mod, kernel in builds.items():
            mod.KERNEL = kernel
        (main_gp if opts.main_gp else main_cli).main(argv[cut + 1:])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from symmetry_ode_discovery_tpu_torch import smoke_setup as cs
    from symmetry_ode_discovery_tpu_torch.ops import _nvcc, lbfgs_dir, lbfgs_sweep, tape_eval
    from symmetry_ode_discovery_tpu_torch.symgp.tape import eval_tapes_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__}), flush=True)
    sides = {mod: {"this": mod.KERNEL, "other": other} for mod, other in builds.items()}
    _nvcc.build_all([k for s in sides.values() for k in s.values()])
    print(json.dumps({"build": {f"{mod.__name__.rsplit('.', 1)[1]} {side}": {
        "seconds": k.info["seconds"], "ptxas": [
            ln.strip() for ln in k.info["ptxas"].splitlines()
            if "registers" in ln or "stack" in ln or "spill" in ln]}
        for mod, s in sides.items() for side, k in s.items()}}), flush=True)

    dev = torch.device("cuda", 0)
    compared = {mod.__name__.rsplit(".", 1)[1] for mod in sides}
    if "lbfgs_sweep" in compared or opts.paths:
        xs, dxs, xg, dxg = cs.make_data(dev)
        x, dx = xs[cs.LV_LEVELS.index(0.99)], dxs[cs.LV_LEVELS.index(0.99)]
    else:
        from symmetry_ode_discovery_tpu_torch.data import SYSTEMS, gen_data
        from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed

        lv = SYSTEMS["lv"]
        gen = torch.Generator(device=dev).manual_seed(cache_seed("train", 0.99))
        x, dx = gen_data(lv, gen, noise=0.99, multiplicative_noise=lv.multiplicative_noise,
                         smoothing="gp", device=dev)
        x, dx = x.reshape(-1, 2), dx.reshape(-1, 2)
    refs, grads, times, failures = {}, {}, {}, []
    if "lbfgs_sweep" in compared:
        k1_cases = cs.k1_cases(dev, xs, dxs, xg, dxg)
        k1_plain = {name: lbfgs_sweep.lbfgs_sweep_plain(pcfg, *lanes, Mmap)[1:]
                    for name, (pcfg, lanes, Mmap, _, _) in k1_cases.items()}
    if "lbfgs_dir" in compared:
        k4_in = cs.k4_inputs(dev, torch.Generator(device=dev).manual_seed(0))
        k4_want = lbfgs_dir.two_loop_direction_plain(*k4_in)
    if "tape_eval" in compared:
        legs = {leg: cs.tape_inputs(dev, x, dx, leg) for leg in ("plain", "equivgp_r")}
        tape_want = {leg: eval_tapes_plain(t.ops, t.args, t.consts, t.pts, t.depth, t.table)
                     for leg, t in legs.items()}
        shapes = {leg: cs.tape_shapes(t, leg) for leg, t in legs.items()}
        bf16_shapes = {leg: cs.tape_bf16_shapes(t, leg) for leg, t in legs.items()}
        bf16_want = {leg: [plain() for _, _, _, plain, _ in s] for leg, s in bf16_shapes.items()}
    if "symmpen" in compared:  # this tree's outputs, which every round's are held to
        symmpen_round(cs, dev, x, refs.setdefault("symmpen", {}))
    if opts.paths or opts.gp:  # the process's first chunks carry one-time costs: not a round's
        quiet = lambda rec: None
        if opts.paths:
            cs.path1(dev, xs, dxs, xg, dxg)
            cs.symreg_phase(dev, x, dx, quiet)
        if opts.gp:
            cs.gp_phase(dev, x, dx, quiet)
    rounds = opts.rounds.split(",")
    for r, side in enumerate(rounds):
        for mod, s in sides.items():
            mod.KERNEL = s[side]
        rec = {}
        if "lbfgs_sweep" in compared:
            rec.update(k1_round(cs, lbfgs_sweep, k1_cases, k1_plain, refs))
        if "lbfgs_dir" in compared:
            rec.update(k4_round(cs, lbfgs_dir, k4_in, k4_want, refs))
        if "symmpen" in compared:
            rec.update(symmpen_round(cs, dev, x, refs.setdefault("symmpen", {})))
        if "tape_eval" in compared:
            trec = tape_round(cs, tape_eval, legs, tape_want, shapes, grads, bf16_shapes,
                              bf16_want)
            for leg, t in trec.items():
                for key, name in (("k5_not_bit_equal", "K5"), ("k5_bf16_not_bit_equal", "K5 bf16")):
                    if t[key]:
                        failures.append(f"{side} {name} ({leg}): {t[key]} elements not "
                                        "bit-equal")
            rec.update(trec)
        if opts.paths:
            walls, res_lv, res_g = cs.path1(dev, xs, dxs, xg, dxg)
            by_noise, ok_g, rmse_g = cs.path1_outcomes(res_lv, res_g)
            sym = cs.symreg_phase(dev, x, dx, lambda rec: None)
            xi0 = refs.setdefault("xi", sym["xi"])
            rec["paths"] = {"walls": walls, "lv_success_by_noise": by_noise,
                            "growth_joint": int(ok_g.sum()), "growth_rmse": rmse_g,
                            "symreg_wall_s": sym["wall_s"], "symreg_joint": sym["joint_success"],
                            "symreg_eq0": sym["eq0_success"],
                            "symreg_correct_form": sym["correct_form"],
                            "symreg_xi_equal_to_first_this": sym["xi"] == xi0}
        if opts.gp:
            for leg, grec in cs.gp_phase(dev, x, dx, lambda rec: None).items():
                rec[f"gp {leg}"] = {k: grec[k] for k in (
                    "chunk_wall_s", "device_s_per_gen", "host_s_per_gen", "joint", "eq0", "eq1")}
        print(json.dumps({"round": r, "side": side, **rec}), flush=True)
        for group, vals in rec.items():
            for key, value in (vals.items() if isinstance(vals, dict) else ()):
                if isinstance(value, float) and key.endswith(("ms", "_s", "per_chunk", "per_gen",
                                                              "per_reduction")):
                    times.setdefault((group, key, side), []).append(value)
            if group == "paths":
                for key, value in vals["walls"].items():
                    times.setdefault((group, key, side), []).append(value)
    for mod, s in sides.items():
        mod.KERNEL = s["this"]
    summary = {}
    for (group, key, side), ts in sorted(times.items()):
        summary.setdefault(group, {}).setdefault(key, {})[side] = sum(ts) / len(ts)
    for group in summary.values():
        for vals in group.values():
            if "this" in vals and "other" in vals:
                vals["other_over_this"] = vals["other"] / vals["this"]
    print(json.dumps({"summary": summary, "device": smi, "failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
