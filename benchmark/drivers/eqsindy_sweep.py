"""The EquivSINDy-r sweep: chunks of seeds through the program's
host-stepped L-BFGS (training/siged.py::make_lbfgs_stepper) on the penalty
of cli/main.py::build_fit, as the flagship CLI runs them.

Set-up: the kernels' builds started, the trajectories made on the device
(data/generate.py), the frozen autoencoder and its penalty (build_fit), the
first chunk's subsample and initial parameters drawn and its init (the
penalty's prep), and one closure at the chunk's
shapes with its gradient and one L-BFGS direction as the warm-up. The
window: stepper calls of ``epochs_per_call`` epochs back to back, the host
reading whether every lane is done after each (as the CLI does); a chunk
that ends is scored, and the next chunk's inputs are drawn and initialised,
inside the window. Progress: a chunk that stepped e of the protocol's
epochs counts chunk * e / epochs seeds, one whose lanes are all done counts
the whole chunk.

The comparison follows the window's first stepper call: the plain reference
makes the trajectories again, evaluates the closure and runs the optimizer
itself from the same subsample and initial parameters (reference/eqsindy.py,
reference/lbfgs.py). ``numbers`` gives the numbers that the cell's limits
hold a run to; ``readings`` adds every lane's gaps, for benchmark/control.py.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import flops
from benchmark.drivers.common import Phases, program_args, sync
from benchmark.harness import ROOT
from benchmark.profiling import Stretch
from benchmark.reference import checkpoint as ref_ckpt
from benchmark.reference import data as ref_data
from benchmark.reference import eqsindy as ref_eqsindy
from benchmark.reference import lbfgs as ref_lbfgs
from benchmark.reference.precision import matmul_tf32

# Every seed runs the same problems: one set of trajectories and, for each
# chunk, one set of lanes (subsample and initial parameters), drawn from fixed
# streams; the seed only orders the lanes. The work of a closure (its live
# lanes) and of an epoch (when lanes freeze, converge or overflow) depends on
# the problems, so problems drawn from the seed would make the seed change the
# work by several percent.
PROBLEMS = 20260101
DATA_SEED = int(np.random.SeedSequence([PROBLEMS, 0]).generate_state(1, np.uint32)[0])


def chunk_inputs(seed: int, chunk: int, lanes: int, n: int, k: int, n_params: int, device):
    """(subsample indices (lanes, k), initial parameters (lanes, n_params))
    of the ``chunk``-th chunk: each lane k distinct rows of n and
    standard-normal parameters, from a fixed generator on the device, the
    lanes in an order drawn from the seed."""
    fixed = int(np.random.SeedSequence([PROBLEMS, 1, chunk]).generate_state(1, np.uint32)[0])
    gen = torch.Generator(device=device).manual_seed(fixed)
    idx = torch.stack([torch.randperm(n, generator=gen, device=device)[:k]
                       for _ in range(lanes)])
    theta0 = torch.randn((lanes, n_params), generator=gen, device=device)
    order = np.random.default_rng(np.random.SeedSequence([seed, chunk])).permutation(lanes)
    order = torch.as_tensor(order, device=device)
    return idx[order], theta0[order]


class Recorder:
    """The penalty passed through: keeps the first call's output (a
    reference, no copy) and counts the rows evaluated."""

    def __init__(self, fn):
        self.fn = fn
        self.wants_coefs = getattr(fn, "wants_coefs", False)
        self.first, self.rows = None, 0

    def __call__(self, XiM, x, ctx):
        out = self.fn(XiM, x, ctx)
        if self.first is None:
            self.first = out.detach()
        self.rows += x.shape[0] * x.shape[1]
        return out


def make_trajectories(config: dict, device):
    """The program's data layer: (x, dx), each (n_ics * num_steps, dim)."""
    from symmetry_ode_discovery_tpu_torch.data.generate import gen_data
    from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS

    d = config["data"]
    gen = torch.Generator(device=device).manual_seed(DATA_SEED)
    x, dx = gen_data(SYSTEMS[d["system"]], gen, n_ics=d["n_ics"], dt=d["dt"],
                     num_steps=d["num_steps"], subsample_rate=1, noise=d["noise"],
                     smoothing=d["smoothing"], gp_sigma_in=d["gp_sigma_in"], device=device)
    return x.reshape(-1, d["dim"]), dx.reshape(-1, d["dim"])


class Sweep:
    """The program's objects of one run, from set-up on."""

    def __init__(self, cell: dict, seed: int, device):
        self.t_created = time.perf_counter()
        from symmetry_ode_discovery_tpu_torch.cli.main import build_fit
        from symmetry_ode_discovery_tpu_torch.ops import lbfgs_dir, symmpen
        from symmetry_ode_discovery_tpu_torch.training.siged import (MEMORY_SIZE,
                                                                     _make_param_fns,
                                                                     make_lbfgs_stepper)

        self.cell, self.seed, self.device = cell, seed, device
        config, traffic = cell["config"], cell["traffic"]
        phases = Phases(device)
        if device.type == "cuda":
            for kern in (symmpen.KERNEL, lbfgs_dir.KERNEL):
                kern.start()  # the compilers run beside the data, on a first run
        self.args = args = program_args(config)
        phases.mark("start")
        self.x, self.dx = make_trajectories(config, device)
        self.setup_data_s = phases.mark("data")
        self.fit = build_fit(args, train_data=(self.x, self.dx), device=device,
                             ckpt_root=str(ROOT / config["checkpoint_root"]))
        cfg, Q, hp = self.fit["cfg"], self.fit["Q"], self.fit["hp"]
        self.hp, self.d, self.p = hp, cfg.latent_dim, cfg.n_terms
        self.n_params = _make_param_fns(cfg, Q)[0]
        self.lanes = traffic["seed_chunk"]
        self.epc = traffic["epochs_per_call"]
        self.k = int(self.x.shape[0] * args["lbfgs_subsample"])
        self.rec = Recorder(self.fit["sym_reg_fn"])
        self.init, self.step, self.extract = make_lbfgs_stepper(
            cfg, Q, hp, self.rec, self.fit["sym_reg_prep"], epochs_per_call=self.epc)
        self.chunk = 0
        phases.mark("model")
        self.idx0, self.theta0 = self.draw(0)
        phases.mark("draw")
        self.carry = self.init(self.x[self.idx0], self.dx[self.idx0], self.theta0)
        phases.mark("chunk")
        self.n_basis = self.carry["srctx"]["v_xs"].shape[1]
        # warm-up: one closure at the chunk's shapes, its gradient, one direction
        th = self.theta0.clone().requires_grad_(True)
        with torch.enable_grad():
            pen = self.fit["sym_reg_fn"](th.reshape(self.lanes, self.d, self.p),
                                         self.carry["x"], self.carry["srctx"])
            (g,) = torch.autograd.grad(pen.sum(), th)
        lbfgs_dir.update(lbfgs_dir.init_state(self.theta0, MEMORY_SIZE), g, self.theta0,
                         hp.lr_sindy, hp.dir_backend == "pallas")
        phases.mark("warm-up")
        self.phases = phases.seconds
        self.symmpen = symmpen

    def draw(self, chunk: int):
        return chunk_inputs(self.seed, chunk, self.lanes, self.x.shape[0], self.k,
                            self.n_params, self.device)

    def score(self, carry):
        """The CLI's end of a chunk: the coefficients scored against the
        ground truth (no file written)."""
        from symmetry_ode_discovery_tpu_torch.evaluation.eval_eq import sindy_truth
        from symmetry_ode_discovery_tpu_torch.training.sweep import _finalize

        Xi, mask = self.extract(carry)
        truth = sindy_truth.get(self.args["task"])
        if truth is not None:
            _finalize(Xi.detach().reshape(self.lanes, self.d * self.p), mask, None, self.d,
                      self.p, truth)

    def next_chunk(self):
        self.chunk += 1
        idx, theta0 = self.draw(self.chunk)
        return self.init(self.x[idx], self.dx[idx], theta0)


TRACED_CALLS = {1: "device", 2: "host"}  # stepper calls traced with --trace 1


def window(sw: Sweep, seconds: float, trace: bool, t_start: float) -> dict:
    """The timed window (module docstring). With ``trace`` the second
    stepper call runs in a device stretch and the third in a host stretch
    (profiling.py)."""
    dev, num_epochs = sw.device, sw.hp.num_epochs
    carry, e, calls, seeds_done = sw.carry, 0, 0, 0.0
    first, traced = None, {}
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        kind = TRACED_CALLS.get(calls) if trace else None
        closures0, rows0 = sw.symmpen.launches["enc_fwd"], sw.rec.rows
        with Stretch(dev, kind) if kind else contextlib.nullcontext() as stretch:
            carry = sw.step(carry, e)
            done_all = bool(carry["done"].all())
        if kind:
            traced[kind] = {"trace": stretch.trace,
                            "closures": sw.symmpen.launches["enc_fwd"] - closures0,
                            "chain_rows": (sw.rec.rows - rows0) * sw.n_basis}
        calls += 1
        e += sw.epc
        if calls == 1:
            first = carry
        if done_all or e >= num_epochs:
            sw.score(carry)
            seeds_done += sw.lanes
            carry, e = sw.next_chunk(), 0
        if time.perf_counter() - t0 >= seconds and (not trace or calls > max(TRACED_CALLS)):
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    seeds_done += sw.lanes * min(e, num_epochs) / num_epochs
    return {"setup_s": setup_s, "window_s": window_s, "seeds": seeds_done, "calls": calls,
            "first": first, "traced": traced}


def program_outputs(sw: Sweep, first: dict) -> dict:
    """What the comparison reads of the program's first call: its first
    closure's penalties (every lane, in order) and the parameters the call
    left."""
    return {"pen0": sw.rec.first, "params": first["params"], "theta0": sw.theta0,
            "idx": sw.idx0}


def reference_outputs(cell: dict, idx, theta0, device, tf32: bool = False) -> dict:
    """The plain reference's first call from the same inputs: the
    trajectories made again, the closure evaluated and the
    optimizer run by reference/; with ``tf32`` every product in TF32 (the
    control)."""
    config, args = cell["config"], program_args(cell["config"])
    x, dx = ref_data.trajectories(config["data"], DATA_SEED, device)
    x, dx = x.reshape(-1, x.shape[-1])[idx], dx.reshape(-1, dx.shape[-1])[idx]
    ck = ref_ckpt.load(str(ROOT / config["checkpoint_root"] / args["load_laligan"]), device)
    with matmul_tf32(tf32):
        clo = ref_eqsindy.Closure(ck, args)
        ctx = clo.prep(x)
        mask = torch.ones((x.shape[0], clo.latent, clo.lib.n_terms), device=device)

        def vg(theta, lanes):
            return clo.value_and_grad(theta, mask[lanes], x[lanes], dx[lanes],
                                      (ctx[0][lanes], [v[lanes] for v in ctx[1]]))

        epochs = min(cell["traffic"]["epochs_per_call"], args["num_epochs"])
        if epochs != 1:
            raise ValueError("the reference follows a first call of one epoch")
        params, evals = ref_lbfgs.first_epoch(vg, theta0, args["lr_sindy"])
    return {"pen0": evals[0]["pen"], "params": params, "theta0": theta0}


def _gaps(p, r, scale):
    """Per lane |p - r| / scale. A lane non-finite on both sides (the
    protocol's NaN stop) is left out; on one side only, its gap is
    infinite."""
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    gap = torch.where(fp & fr, (p - r).abs() / scale, torch.full_like(p, float("inf")))
    return gap[fp | fr]


def _norms_gaps(p, r):
    """Per lane |p - r| over the larger of |r| and the median lane's
    (finite) |r|."""
    fin = torch.isfinite(r)
    med = r[fin].abs().median() if bool(fin.any()) else r.new_ones(())
    return _gaps(p, r, torch.maximum(r.abs(), med))


def lane_gaps(prog: dict, ref: dict) -> dict:
    """Each lane's gaps. ``pen0``: the first closure's penalty (every lane
    at its initial parameters: the same inputs on both sides), relative;
    ``epoch_change``: the norm of the lane's change over the first call, over
    the larger of the reference's and the median lane's."""
    p, r = prog["pen0"].cpu(), ref["pen0"].cpu()
    theta0 = prog["theta0"].cpu()
    dp = (prog["params"].cpu() - theta0).norm(dim=-1)
    dr = (ref["params"].cpu() - theta0).norm(dim=-1)
    return {"pen0": _gaps(p, r, r.abs()), "epoch_change": _norms_gaps(dp, dr)}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers a run is held to: the median lane's gaps, and the worst
    lane's first penalty, which a fault of a single lane moves."""
    g = lane_gaps(prog, ref)
    return {"pen0_gap_median": float(g["pen0"].median()),
            "pen0_gap_worst": float(g["pen0"].max()),
            "epoch_change_gap_median": float(g["epoch_change"].median())}


def readings(prog: dict, ref: dict) -> dict:
    """What benchmark/control.py records of a comparison: the compared
    numbers, every lane's gaps and both sides' values, lane by lane."""
    theta0 = prog["theta0"].cpu()
    raw = {"pen0_prog": prog["pen0"], "pen0_ref": ref["pen0"],
           "change_prog": (prog["params"].cpu() - theta0).norm(dim=-1),
           "change_ref": (ref["params"].cpu() - theta0).norm(dim=-1)}
    raw.update({f"{k}_gaps": v for k, v in lane_gaps(prog, ref).items()})
    return dict(numbers(prog, ref), **{k: v.cpu().tolist() for k, v in raw.items()})


def first_program(cell: dict, seed: int, device) -> dict:
    """The program's outputs that the comparison reads, without a window:
    set-up and the first stepper call."""
    sw = Sweep(cell, seed, device)
    return program_outputs(sw, sw.step(sw.carry, 0))


def reference(cell: dict, seed: int, prog: dict, device, tf32: bool = False) -> dict:
    return reference_outputs(cell, prog["idx"], prog["theta0"], device, tf32)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    sw = Sweep(cell, seed, device)
    w = window(sw, seconds, trace, t_start)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog = program_outputs(sw, w["first"])
    ctx = {"setup_data_s": sw.setup_data_s}
    phases = dict(sw.phases, start=sw.phases["start"] + sw.t_created - t_start)
    del sw, w["first"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, prog, device)
    got = numbers(prog, ref)
    checks = harness.checks(got, cell["limits"])
    out = {"e2e": {"seeds_per_min": 60.0 * w["seeds"] / w["window_s"], "setup_s": w["setup_s"]},
           "attempted": w["calls"], "failed": 0, "memory_peak_bytes": memory_peak,
           "checks": checks, "ctx": ctx, "setup_phases": phases}
    if w["traced"]:
        args = program_args(cell["config"])
        ctx.update(w["traced"], enc_widths=flops.mlp_widths(
            args["input_dim"], args["hidden_dim"], args["n_layers"], args["latent_dim"]),
            dec_widths=flops.mlp_widths(args["latent_dim"], args["hidden_dim"],
                                        args["n_layers"], args["input_dim"]))
        dev_t, host_t = w["traced"]["device"]["trace"], w["traced"]["host"]["trace"]
        out.update(busy_s=dev_t.busy_s(), window_s=dev_t.window_s,
                   breakdown={"device_ops": dev_t.device_ops(),
                              "idle_gaps": host_t.gaps_by_host()})
    return out
