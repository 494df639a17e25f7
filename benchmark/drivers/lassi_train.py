"""LaLiGAN training: batch steps of the program's trainer
(training/lassi.py::LassiTrainer.step, built by cli/main.py::build_trainer)
back to back, each epoch's permutation and every step's coefficient draw
made from the seed as LassiTrainer.epoch makes them; no validation, no
snapshot.

Set-up: the trajectories made on the device from the seed (data/generate.py)
and windowed (data/datasets.py::MTODEDataset), the trainer built, its
weights drawn on the device from the seed in one call (flax's initialisers:
lecun-normal kernels, zero biases, BatchNorms at unit scale; a
standard-normal Lie generator) and handed to it, and its first three steps,
which are the warm-up. The window continues on the same trainer: a CUDA
event recorded after each step times the intervals between step
completions, read after the window (``laligan_step_ms_p95``, a per-layer
metric: host noise spreads it too widely for a bound).

The comparison follows those first three steps: the plain reference
(reference/lassi.py) takes the same weights, batches and draws; ``numbers``
gives the numbers the cell's limits hold a run to (the first step's loss, the
first gradient as Adam holds it after one step, the leaves' change over the
steps); ``readings`` adds the candidates weighed beside them, for
benchmark/control.py. Leaves whose reference gradient is under a
thousandth of the median leaf's (a bias followed by a training-mode
BatchNorm) move under Adam by round-off alone and are left out of the
change.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counts import flops
from benchmark.drivers.common import Phases, program_args, sync
from benchmark.profiling import Stretch
from benchmark.reference import data as ref_data
from benchmark.reference import lassi as ref_lassi
from benchmark.reference.precision import matmul_tf32

WARM_STEPS = 3         # set-up steps, followed by the reference
TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated at +-2
GRAD_FLOOR = 1e-3      # of the median leaf's first gradient: leaves left out of the change


def seeds(seed: int):
    """(data seed, weights seed, feed seed) of a run."""
    s = np.random.SeedSequence([seed, 2]).generate_state(3, np.uint32)
    return tuple(int(v) for v in s)


def init_weights(args: dict, seed: int, device) -> dict:
    """The benchmark's weights by reference/lassi.py's names: every kernel
    from one truncated-normal draw on the device, scaled to lecun-normal over
    its fan-in; then the Lie generator's standard-normal Li."""
    h, n, lat, d_in, nc = (args["hidden_dim"], args["n_layers"], args["latent_dim"],
                           args["input_dim"], args["n_comps"])
    shapes = {}
    for prefix, w in (("enc", flops.mlp_widths(d_in, h, n, h)[:-1]),
                      ("dec", flops.mlp_widths(lat, h, n, d_in)),
                      ("disc", flops.mlp_widths(nc * lat, h, n, 1))):
        for k, (a, b) in enumerate(zip(w[:-1], w[1:])):
            shapes[f"{prefix}.{k}.kernel"] = (a, b)
    shapes["enc.out.V"] = (h, lat)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(a * b for a, b in shapes.values()), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    P, at = {}, 0
    for name, (a, b) in shapes.items():
        P[name] = flat[at:at + a * b].reshape(a, b) * ((1.0 / a) ** 0.5 / TRUNC_STD)
        at += a * b
        P[name.replace(".kernel", ".bias").replace(".V", ".bias")] = torch.zeros(b, device=device)
    for k in list(range(n)) + ["f"]:
        w = h if k != "f" else lat
        P[f"enc.bn{k}.scale"] = torch.ones(w, device=device)
        P[f"enc.bn{k}.bias"] = torch.zeros(w, device=device)
    ch, dd = _block(args)
    P["gen.Li"] = torch.randn((ch, dd, dd), generator=gen, device=device)
    P["gen.sigma"] = torch.eye(ch, device=device) * float(args["sigma_init"])
    P["gen.struct_const"] = torch.zeros((ch, ch, ch), device=device)
    P["gen.mask"] = torch.ones((ch, dd, dd), device=device)
    return P


def _block(args):
    from benchmark.reference.eqsindy import parse_learnable_repr

    blocks = parse_learnable_repr(args["repr"])
    if len(blocks) != 1:
        raise ValueError("the driver takes one learnable generator block")
    return blocks[0][1], blocks[0][2]


def port_names(n_layers: int) -> dict:
    """{program parameter name: benchmark name} of the autoencoder ("ae."),
    the discriminator ("d.") and the generator ("g.")."""
    out = {}
    for k in range(n_layers):
        out[f"ae.encoder.dense.{k}.weight"] = f"enc.{k}.kernel"
        out[f"ae.encoder.dense.{k}.bias"] = f"enc.{k}.bias"
        out[f"ae.encoder.bn.{k}.weight"] = f"enc.bn{k}.scale"
        out[f"ae.encoder.bn.{k}.bias"] = f"enc.bn{k}.bias"
    out.update({"ae.encoder.out.V": "enc.out.V", "ae.encoder.out.bias": "enc.out.bias",
                "ae.encoder.bn_final.weight": "enc.bnf.scale",
                "ae.encoder.bn_final.bias": "enc.bnf.bias"})
    for k in range(n_layers + 1):
        for w, v in (("weight", "kernel"), ("bias", "bias")):
            out[f"ae.decoder.dense.{k}.{w}"] = f"dec.{k}.{v}"
            out[f"d.dense.{k}.{w}"] = f"disc.{k}.{v}"
    out.update({"g.Li.0": "gen.Li", "g.struct_const.0": "gen.struct_const"})
    return out


def to_program(P: dict, n_layers: int):
    """(autoencoder state_dict, discriminator state_dict, GeneratorState)."""
    from symmetry_ode_discovery_tpu_torch.models.lie_generator import GeneratorState

    ae, disc = {}, {}
    for port, ours in port_names(n_layers).items():
        v = P[ours].T if ours.endswith(".kernel") else P[ours]
        if port.startswith("ae."):
            ae[port[3:]] = v.contiguous()
        elif port.startswith("d."):
            disc[port[2:]] = v.contiguous()
    for k in list(range(n_layers)) + ["_final"]:
        name = f"encoder.bn.{k}" if k != "_final" else "encoder.bn_final"
        w = ae[f"{name}.weight"]
        ae[f"{name}.running_mean"] = torch.zeros_like(w)
        ae[f"{name}.running_var"] = torch.ones_like(w)
        ae[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=w.device)
    g = GeneratorState(Li=(P["gen.Li"],), sigma=(P["gen.sigma"],),
                       struct_const=(P["gen.struct_const"],), masks=(P["gen.mask"],))
    return ae, disc, g


def program_leaves(trainer) -> list:
    """[(benchmark name, parameter, its Adam group, its index there)]."""
    names = port_names(trainer.ae.cfg.n_layers)
    out = []
    for i, (n, p) in enumerate(trainer.ae.named_parameters()):
        out.append((names[f"ae.{n}"], p, "ae", i))
    for i, (n, p) in enumerate(trainer.disc.named_parameters()):
        out.append((names[f"d.{n}"], p, "d", i))
    g = trainer.opt["g"].params
    for i, (n, p) in enumerate((("Li.0", g[0]), ("struct_const.0", g[1]))):
        out.append((names[f"g.{n}"], p, "g", i))
    return out


class Feed:
    """Batches of the windows: an epoch's permutation from the feed
    generator, then each step's rows and coefficient draw, in the order
    LassiTrainer.epoch draws them."""

    def __init__(self, x, batch: int, channels: int, seed: int):
        self.x, self.bs, self.ch = x, min(batch, x.shape[0]), channels
        self.nb = x.shape[0] // self.bs
        self.gen = torch.Generator(device=x.device).manual_seed(seed)
        self.i = self.nb

    def next(self):
        if self.i == self.nb:
            n = self.x.shape[0]
            self.perm = torch.randperm(n, generator=self.gen, device=self.x.device)
            self.perm = self.perm[:self.nb * self.bs].reshape(self.nb, self.bs)
            self.i = 0
        rows = self.perm[self.i]
        coef = torch.randn((self.bs, self.ch), generator=self.gen, device=self.x.device)
        self.i += 1
        return rows, coef, self.i == self.nb


def total_loss(args: dict, m: dict):
    """The step's loss from its components, as training/lassi.py sums them."""
    reg = args["w_reg_norm"] if abs(args["w_reg_norm"]) > 1e-8 else (
        args["w_reg_sim"] if abs(args["w_reg_sim"]) > 1e-8 else 0.0)
    return (args["w_recon"] * m["loss_ae"] + args["w_gan"] * m["loss_g"]
            + reg * m["loss_reg_norm"] + args["w_reg_ortho"] * m["loss_reg_ortho"]
            + args["w_reg_closure"] * m["loss_reg_closure"]
            + (m["loss_d_real"] + m["loss_d_fake"]) / 2)


class Training:
    """The program's objects of one run, from set-up on."""

    def __init__(self, cell: dict, seed: int, device):
        self.t_created = time.perf_counter()
        from symmetry_ode_discovery_tpu_torch.cli.main import build_trainer
        from symmetry_ode_discovery_tpu_torch.data.datasets import MTODEDataset
        from symmetry_ode_discovery_tpu_torch.data.generate import gen_data
        from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS

        self.cell, self.device = cell, device
        config, traffic = cell["config"], cell["traffic"]
        self.args = args = program_args(config)
        args["batch_size"] = traffic["batch_size"]
        self.data_seed, self.weights_seed, self.feed_seed = seeds(seed)
        d = config["data"]
        phases = Phases(device)
        phases.mark("start")
        gen = torch.Generator(device=device).manual_seed(self.data_seed)
        x, dx = gen_data(SYSTEMS[d["system"]], gen, n_ics=d["n_ics"], dt=d["dt"],
                         num_steps=d["num_steps"], subsample_rate=1, noise=d["noise"],
                         smoothing=d["smoothing"], gp_sigma_in=d["gp_sigma_in"], device=device)
        self.x = MTODEDataset(x, dx, n_timesteps=d["n_timesteps"],
                              interval=d["interval"]).materialize()[0]
        self.setup_data_s = phases.mark("data")
        self.P0 = init_weights(args, self.weights_seed, device)
        ch, _ = _block(args)
        self.feed = Feed(self.x, args["batch_size"], ch, self.feed_seed)
        self.trainer = build_trainer(args, device, steps_per_epoch=self.feed.nb)
        self.trainer.load_state(*to_program(self.P0, args["n_layers"]))
        self.leaves = program_leaves(self.trainer)
        phases.mark("model")
        self.warm = {"rows": [], "coef": [], "loss": []}
        for s in range(WARM_STEPS):
            rows, coef, last = self.feed.next()
            m = self.trainer.step(self.x[rows], None, coef=[coef], is_last=last)
            self.warm["rows"].append(rows)
            self.warm["coef"].append(coef)
            self.warm["loss"].append(total_loss(args, m))
            if s == 0:
                self.warm["grad1"] = {n: self.trainer.opt[g].mu[i].norm() / (1 - ref_lassi.B1)
                                      for n, _, g, i in self.leaves}
        self.warm["change"] = {n: (p.detach() - self.P0_port(n)).norm()
                               for n, p, _, _ in self.leaves}
        phases.mark("warm-up")
        self.phases = phases.seconds

    def P0_port(self, name):
        v = self.P0[name]
        return v.T if name.endswith(".kernel") else v

    def step(self):
        rows, coef, last = self.feed.next()
        return self.trainer.step(self.x[rows], None, coef=[coef], is_last=last)


# window steps traced with --trace 1: [first, last) of each stretch
TRACED_STEPS = {"device": (5, 25), "host": (25, 35)}


def window(tr: Training, seconds: float, trace: bool, t_start: float) -> dict:
    """The timed window (module docstring). With ``trace`` a device stretch
    and then a host stretch (profiling.py) cover TRACED_STEPS."""
    dev = tr.device
    events, traced, stretch = [], {}, None
    steps, metrics = 0, []
    last = max(b for _, b in TRACED_STEPS.values())
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    start = torch.cuda.Event(enable_timing=True) if dev.type == "cuda" else None
    if start is not None:
        start.record()
    while True:
        for kind, (a, b) in TRACED_STEPS.items() if trace else ():
            if steps == a:
                stretch = Stretch(dev, kind).__enter__()
        metrics.append(tr.step())
        steps += 1
        if start is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        for kind, (a, b) in TRACED_STEPS.items() if trace else ():
            if steps == b:
                stretch.__exit__(None, None, None)
                traced[kind] = {"trace": stretch.trace, "steps": b - a}
        if time.perf_counter() - t0 >= seconds and (not trace or steps >= last):
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    intervals = []
    if start is not None:
        marks = [start] + events
        skip = {i for a, b in TRACED_STEPS.values() for i in range(a, b + 1)} if trace else ()
        # step i's interval ends at its completion; a stretch's steps, and the
        # one after it (the trace's export), are left out
        intervals = [a.elapsed_time(b) for i, (a, b) in enumerate(zip(marks[:-1], marks[1:]))
                     if i not in skip]
    finite = torch.stack([total_loss(tr.args, m) for m in metrics]).isfinite()
    return {"setup_s": setup_s, "window_s": window_s, "steps": steps, "intervals": intervals,
            "failed": int((~finite).sum()), "traced": traced}


def program_outputs(tr: Training) -> dict:
    w = tr.warm
    return {"loss": torch.stack(w["loss"]), "grad1": dict(w["grad1"]),
            "change": dict(w["change"]), "rows": w["rows"], "coef": w["coef"]}


def first_program(cell: dict, seed: int, device) -> dict:
    """The program's outputs that the comparison reads, without a window:
    set-up and its first steps."""
    return program_outputs(Training(cell, seed, device))


def reference(cell: dict, seed: int, prog: dict, device, tf32: bool = False) -> dict:
    return reference_outputs(cell, seed, prog["rows"], prog["coef"], device, tf32)


def reference_outputs(cell: dict, seed: int, rows, coefs, device, tf32: bool = False) -> dict:
    """The plain reference's first steps from the same weights, batches and
    draws; with ``tf32`` every product in TF32 (the control)."""
    config, args = cell["config"], program_args(cell["config"])
    args["batch_size"] = cell["traffic"]["batch_size"]
    data_s, weights_s, _ = seeds(seed)
    d = config["data"]
    x, _ = ref_data.trajectories(d, data_s, device)
    x = ref_data.windows(x, d["n_timesteps"], d["interval"])
    P0 = init_weights(args, weights_s, device)
    with matmul_tf32(tf32):
        ref = ref_lassi.Lassi(args)
        P, opt = dict(P0), ref.fresh_opt(P0)
        losses, grad1 = [], None
        for r, c in zip(rows, coefs):
            loss, grads = ref.step(P, opt, x[r], c)
            losses.append(loss)
            if grad1 is None:
                grad1 = {n: g.norm() for n, g in grads.items()}
    change = {n: (P[n] - P0[n]).norm() for n in grad1}
    return {"loss": torch.stack(losses), "grad1": grad1, "change": change}


def _leaf_gaps(prog: dict, ref: dict, names) -> torch.Tensor:
    """Per leaf |‖p‖ - ‖r‖| over the larger of ‖r‖ and the median leaf's
    ‖r‖."""
    r = torch.stack([ref[n] for n in names]).cpu()
    p = torch.stack([prog[n] for n in names]).cpu()
    return (p - r).abs() / torch.maximum(r, r.median())


def gaps(prog: dict, ref: dict) -> dict:
    """``loss``: each step's relative gap of the loss; ``grad``: each leaf's
    first gradient as Adam holds it, and ``change``: each moved leaf's change
    over the steps, gap of norms (``_leaf_gaps``); ``moved``: those leaves'
    names."""
    g = torch.stack(list(ref["grad1"].values()))
    moved = [n for n, v in ref["grad1"].items() if float(v) >= GRAD_FLOOR * float(g.median())]
    return {"loss": (prog["loss"] - ref["loss"]).abs() / ref["loss"].abs(),
            "grad": _leaf_gaps(prog["grad1"], ref["grad1"], list(ref["grad1"])),
            "change": _leaf_gaps(prog["change"], ref["change"], moved), "moved": moved}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers a run is held to: the first step's loss, the worst leaf's
    first gradient, the median moved leaf's change."""
    g = gaps(prog, ref)
    return {"loss1_gap": float(g["loss"][0]), "grad_gap": float(g["grad"].max()),
            "change_gap_median": float(g["change"].median())}


def readings(prog: dict, ref: dict) -> dict:
    """What benchmark/control.py records of a comparison: the compared
    numbers, the worst step's loss, the median leaf's gradient and the worst
    moved leaf's change with its name (the candidates the look weighed)."""
    g = gaps(prog, ref)
    return dict(numbers(prog, ref), loss_gap=float(g["loss"].max()),
                grad_gap_median=float(g["grad"].median()), change_gap=float(g["change"].max()),
                change_worst_leaf=g["moved"][int(g["change"].argmax())])


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    tr = Training(cell, seed, device)
    w = window(tr, seconds, trace, t_start)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog = program_outputs(tr)
    args, bs = tr.args, tr.feed.bs
    ctx = {"setup_data_s": tr.setup_data_s}
    phases = dict(tr.phases, start=tr.phases["start"] + tr.t_created - t_start)
    del tr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, prog, device)
    got = numbers(prog, ref)
    checks = harness.checks(got, cell["limits"])
    e2e = {"laligan_samples_per_s": w["steps"] * bs / w["window_s"], "setup_s": w["setup_s"]}
    if w["intervals"]:
        ctx["step_ms_p95"] = float(np.percentile(w["intervals"], 95))
        ctx["step_ms_median"] = float(np.median(w["intervals"]))
    out = {"e2e": e2e, "attempted": w["steps"], "failed": w["failed"],
           "memory_peak_bytes": memory_peak, "checks": checks, "ctx": ctx,
           "setup_phases": phases}
    if w["traced"]:
        ctx.update(w["traced"], step_flops=flops.lassi_step_flops(
            bs, args["n_comps"], args["input_dim"], args["latent_dim"], args["hidden_dim"],
            args["n_layers"]))
        dev_t, host_t = w["traced"]["device"]["trace"], w["traced"]["host"]["trace"]
        out.update(busy_s=dev_t.busy_s(), window_s=dev_t.window_s,
                   breakdown={"device_ops": dev_t.device_ops(),
                              "idle_gaps": host_t.gaps_by_host()})
    return out
