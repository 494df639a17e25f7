"""Multi-seed GP sweeps: the units of a sweep as a batch axis of every
launch.

The port's counterpart of symmetry_ode_discovery_tpu/symgp/sweep.py. Each
generation evaluates and constant-optimises the populations of all units at
once, each unit on its own rows (one launch of K5 per fitness pass and one
of K6 per Adam step, over every unit), then breeds each unit on the host
with the C++ core. Two unit layouts:

- plain (``gp_sweep_plain``): units are (seed, dimension) pairs, each a
  scalar regression;
- system (``gp_sweep_system``): units are seeds, each holding two
  interleaved component tapes per individual, scored by the
  symmetry-regularised objective.

Constant optimisation is top-K: fitness ranks the whole population, then
Adam tunes the constants of the best K groups per unit on the first
``const_subsample`` rows, and a tuned group is kept only where its
full-batch fitness improved. Both packages' fitness and gradient backends
agree by design, so the port has one: K5 forward and K6 backward through
``tape_eval.eval_tapes`` (the plain versions on the CPU). With
``eval_dtype=torch.bfloat16`` the full-batch fitness evaluations (the
ranking and the accept/reject comparison) run K5's bf16 mode, predictions
cast to f32 before the loss reductions, as the reference's ``fit_loss``;
the Adam gradient stays f32.

With a ``Mesh`` (parallel/mesh.py) the unit axis is sharded over its
devices: shard i holds the contiguous slice i of the units and their rows
on its device, and every shard's generation step (its K5 and K6 launches)
is enqueued before any result is read. A unit count the mesh does not
divide is padded with copies of the last unit, whose results are dropped
and never bred. Breeding stays on the host, each unit with its own
generator, so the random streams are the single-device run's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import tape_eval
from ..parallel.mesh import Mesh, on_device
from .evolve import Adam, GPConfig, breed, const_grad
from .tape import TapeSpec, random_population, spec_op_table, tape_length


def _f32(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def plain_loss(pred, y):
    """(U, P, N) predictions, y (U, N) -> (U, P): the MSE per tape, +inf
    where it is not finite."""
    mse = ((pred - y[:, None, :]) ** 2).mean(dim=-1)
    return torch.where(torch.isfinite(mse), mse, torch.inf)


def system_points(X, gx):
    """X (U, N, d) and gx (U, n_g, N, d) -> (U, (1 + n_g) N, d): every row
    the system objective evaluates, in one batch."""
    U, N, d = X.shape
    return torch.cat([X[:, None], gx], dim=1).reshape(U, -1, d) if gx.shape[1] else X


def system_loss(preds, dX, Jg, w_sym_reg: float, reference_bug_compat: bool = False):
    """Predictions (U, 2P, (1 + n_g) N) of interleaved two-component tapes
    (ops[:, 2k] is h1 of individual k, ops[:, 2k + 1] its h2) -> (U, P):

        MSE(h(x), dx) + w_sym_reg * sum_i mean || J_gi(x) h(x) - h(g_i x) ||^2

    With ``reference_bug_compat`` the Jacobian multiplies h(g_i x) instead of
    h(x), as the reference's Julia objective does."""
    U, N, _ = dX.shape
    preds = preds.reshape(U, preds.shape[1] // 2, 2, -1)
    h_x = preds[..., :N]
    out = ((h_x.transpose(-1, -2) - dX[:, None]) ** 2).mean(dim=(-2, -1))
    for i in range(Jg.shape[1]):
        h_gx = preds[..., (1 + i) * N:(2 + i) * N]
        lhs = torch.einsum("unij,upjn->upin", Jg[:, i], h_gx if reference_bug_compat else h_x)
        out = out + w_sym_reg * ((lhs - h_gx) ** 2).mean(dim=(-2, -1))
    return torch.where(torch.isfinite(out), out, torch.inf)


@dataclasses.dataclass
class UnitLoss:
    """A per-unit loss in its two halves: ``points(*data)`` gives the rows
    (U, R, n_vars) every tape runs on, ``of_preds(preds, *data)`` turns the
    predictions (U, G*P, R) into the loss (U, P). Called as
    ``loss(ops, args, consts, *data)`` it evaluates the tapes through
    ``tape_eval.eval_tapes`` (K5, with K6 as its backward) and scores them.
    With ``eval_dtype`` bfloat16 the rows and constants are cast to it for
    the evaluation (K5's bf16 mode, forward only) and the predictions back
    to f32 for the loss."""
    points: Callable
    of_preds: Callable
    stack_depth: int
    op_table: tuple
    eval_dtype: torch.dtype = torch.float32

    def __call__(self, ops, args, consts, *data):
        pts = self.points(*data).to(self.eval_dtype).contiguous()
        preds = tape_eval.eval_tapes(ops, args, consts.to(self.eval_dtype).contiguous(), pts,
                                     self.stack_depth, self.op_table)
        return self.of_preds(preds.float(), *data)


def _plain_unit_loss(spec: TapeSpec) -> UnitLoss:
    """(ops (U, P, L), args, consts, X (U, N, d), y (U, N)) -> (U, P)."""
    return UnitLoss(points=lambda X, y: X, of_preds=lambda preds, X, y: plain_loss(preds, y),
                    stack_depth=spec.stack_depth, op_table=spec_op_table(spec))


def _system_unit_loss(spec: TapeSpec, w_sym_reg: float, n_g: int,
                      reference_bug_compat: bool = False) -> UnitLoss:
    """(ops (U, 2P, L), args, consts, X (U, N, d), dX (U, N, d),
    gx (U, n_g, N, d), Jg (U, n_g, N, d, d)) -> (U, P): ``system_loss`` with
    every row of x and g_i(x) evaluated in one launch."""
    return UnitLoss(
        points=lambda X, dX, gx, Jg: system_points(X, gx[:, :n_g]),
        of_preds=lambda preds, X, dX, gx, Jg: system_loss(preds, dX, Jg[:, :n_g], w_sym_reg,
                                                          reference_bug_compat),
        stack_depth=spec.stack_depth, op_table=spec_op_table(spec))


def _take_rows(a, rows):
    """a (U, R, L), rows (U, K) -> (U, K, L)."""
    return torch.gather(a, 1, rows[..., None].expand(-1, -1, a.shape[-1]))


def make_sweep_gen_step(unit_loss, steps: int, lr: float, topk: int, group: int = 1,
                        n_data: int = 0, fit_loss=None):
    """One generation over all units: gen(ops (U, G*P, L), args, consts,
    *data, *data_small) -> (consts (U, G*P, L), fitness (U, P)).

    ``data`` (n_data tensors, each (U, ...)) feeds the population fitness
    and the accept/reject comparison, both through ``fit_loss`` (default
    ``unit_loss``; e.g. its bf16 evaluation); ``data_small``, the same
    tensors cut to the first const_subsample rows, feeds the Adam gradient
    of ``unit_loss``. The best ``topk`` groups per unit are taken by a
    stable ascending sort of the fitness, so ties go to the lower index as
    in jax.lax.top_k."""
    opt = Adam(lr)
    fit_loss = unit_loss if fit_loss is None else fit_loss

    @torch.no_grad()
    def gen(ops, args, consts, *all_data):
        data, data_small = all_data[:n_data], all_data[n_data:]
        fit0 = fit_loss(ops, args, consts, *data)  # (U, P)
        if steps <= 0 or topk <= 0:
            return consts, fit0
        idx = torch.sort(fit0, dim=1, stable=True).indices[:, :topk]  # (U, K)
        ar = torch.arange(group, device=idx.device)
        rows = (idx[..., None] * group + ar).reshape(idx.shape[0], -1)  # (U, K*G)
        sub_ops, sub_args, c0 = (_take_rows(a, rows) for a in (ops, args, consts))
        c, state = c0, opt.init(c0)
        for _ in range(steps):
            c, state = opt.step(c, const_grad(unit_loss, sub_ops, sub_args, c, *data_small),
                                state)
        fit_new = fit_loss(sub_ops, sub_args, c, *data)
        fit_old = torch.gather(fit0, 1, idx)
        take = torch.repeat_interleave(fit_new < fit_old, group, dim=1)
        c_final = torch.where(take[..., None], c, c0)
        consts = consts.scatter(1, rows[..., None].expand_as(c_final), c_final)
        fitness = fit0.scatter(1, idx, torch.minimum(fit_new, fit_old))
        return consts, fitness

    return gen


@dataclasses.dataclass
class SweepResult:
    best: List[tuple]        # per unit: (ops, args, consts), each (G, L)
    best_fit: np.ndarray     # (U,)
    history: np.ndarray      # (U, n_generations)
    device_s: np.ndarray     # per generation: the device step, wall to its sync
    host_s: np.ndarray       # per generation: selection bookkeeping and breeding


@dataclasses.dataclass
class SweepInputs:
    """Everything one sweep starts from: the initial populations (ops, args,
    consts) as numpy (U, G*P, L); ``data`` for fitness and acceptance and
    ``data_small``, the same cut to the first const_subsample rows, for the
    constant gradient, each a tuple of (U, ...) tensors on the device; the
    per-unit breeding rngs; the unit loss; and G, the tapes per individual."""
    populations: tuple
    data: tuple
    data_small: tuple
    rngs: list
    unit_loss: UnitLoss
    group: int


def plain_inputs(X_all: np.ndarray, dX_all: np.ndarray, spec: TapeSpec, cfg: GPConfig, seeds,
                 const_subsample: int = 512, device=None) -> SweepInputs:
    """The plain sweep's units: (seed, dim) pairs in that order, each with
    rng default_rng(1000 * seed + dim), its seed's rows X_all[s] (N, d) and
    target dX_all[s, :, dim]."""
    device = resolve_device(device)
    S, N, d = X_all.shape
    rngs = [np.random.default_rng(int(1000 * s + dim)) for s in seeds for dim in range(d)]
    pops = [random_population(rng, spec, cfg.pop_size) for rng in rngs]
    X_u = _f32(np.repeat(X_all, d, axis=0), device)                            # (U, N, d)
    y_u = _f32(np.stack([dX_all[s, :, dim] for s in range(S) for dim in range(d)]), device)
    k = min(N, const_subsample)  # rows are already a random subsample
    return SweepInputs(tuple(np.stack([p[i] for p in pops]) for i in range(3)), (X_u, y_u),
                       (X_u[:, :k].contiguous(), y_u[:, :k].contiguous()), rngs,
                       _plain_unit_loss(spec), 1)


def system_inputs(X_all: np.ndarray, dX_all: np.ndarray, spec: TapeSpec, cfg: GPConfig, seeds,
                  gx_all: Optional[np.ndarray] = None, Jgx_all: Optional[np.ndarray] = None,
                  w_sym_reg: float = 0.0, const_subsample: int = 512,
                  reference_bug_compat: bool = False, device=None) -> SweepInputs:
    """The system sweep's units: one per seed, rng default_rng(seed), two
    interleaved component tapes per individual, on X_all[s], dX_all[s]
    (N, 2) and, for EquivGP-r, gx_all[s] (n_g, N, 2) and Jgx_all[s]
    (n_g, N, 2, 2)."""
    from .objective import paired_population

    device = resolve_device(device)
    S, N, d = X_all.shape
    if d != 2:
        raise ValueError(f"the system objective takes two components, got {d}")
    n_g = 0 if gx_all is None else gx_all.shape[1]
    rngs = [np.random.default_rng(int(s)) for s in seeds]
    pops = [paired_population(rng, spec, cfg.pop_size) for rng in rngs]
    if n_g:
        gx, Jg = _f32(gx_all, device), _f32(Jgx_all, device)
    else:
        gx = torch.zeros((S, 0, N, d), device=device)
        Jg = torch.zeros((S, 0, N, d, d), device=device)
    data = (_f32(X_all, device), _f32(dX_all, device), gx, Jg)
    k = min(N, const_subsample)
    small = tuple(a.contiguous() for a in (data[0][:, :k], data[1][:, :k], gx[:, :, :k],
                                           Jg[:, :, :k]))
    return SweepInputs(tuple(np.stack([p[i] for p in pops]) for i in range(3)), data, small,
                       rngs, _system_unit_loss(spec, w_sym_reg, n_g, reference_bug_compat), 2)


def _pad_units(a, pad: int):
    """a (U, ...) with ``pad`` copies of its last unit appended."""
    if not pad:
        return a
    if isinstance(a, np.ndarray):
        return np.concatenate([a] + [a[-1:]] * pad)
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])


def _run_sweep(inputs: SweepInputs, spec: TapeSpec, cfg: GPConfig, topk: int, device,
               verbose: bool = False, select: str = "penalized",
               eval_dtype: torch.dtype = torch.float32, mesh: Optional[Mesh] = None):
    """Evolution loop over a batch of units from ``inputs``. select: the
    score that picks the reported best: 'penalized' (loss + parsimony *
    length) or 'raw' (loss alone); breeding always uses the penalized
    fitness. eval_dtype: the dtype of the full-batch fitness evaluations.
    mesh: the devices the unit axis is sharded over (see the module
    docstring); None runs every unit on ``device``."""
    ops, args, consts = inputs.populations
    group, rngs = inputs.group, inputs.rngs
    U = ops.shape[0]
    P = ops.shape[1] // group
    data = tuple(inputs.data) + tuple(inputs.data_small)
    if mesh is None:
        mesh = Mesh((device,))
    pad = (-U) % mesh.size
    Up = U + pad
    ops, args, consts = (_pad_units(a, pad) for a in (ops, args, consts))
    slices = mesh.slices(Up)
    shard_data = [tuple(_pad_units(a, pad)[sl].to(dev) for a in data)
                  for dev, sl in zip(mesh.devices, slices)]
    fit_loss = dataclasses.replace(inputs.unit_loss, eval_dtype=eval_dtype)
    gen_step = make_sweep_gen_step(inputs.unit_loss, cfg.const_opt_steps, cfg.const_opt_lr, topk,
                                   group, n_data=len(inputs.data), fit_loss=fit_loss)
    best = [None] * U
    best_fit = np.full(U, np.inf)
    history = np.zeros((U, cfg.n_generations), np.float32)
    device_s = np.zeros(cfg.n_generations)
    host_s = np.zeros(cfg.n_generations)
    for gen in range(cfg.n_generations):
        t0 = time.perf_counter()
        outs = []
        for dev, sl, dat in zip(mesh.devices, slices, shard_data):
            with on_device(dev):
                outs.append(gen_step(*(torch.as_tensor(a[sl], device=dev)
                                       for a in (ops, args, consts)), *dat))
        consts = np.concatenate([c.cpu().numpy() for c, _ in outs])
        base = np.concatenate([b.cpu().numpy() for _, b in outs])
        t1 = time.perf_counter()
        lens = tape_length(ops.reshape(Up * group * P, -1)).reshape(Up, P, group).sum(-1)
        fit = base + cfg.parsimony * lens  # rows from U on are padding
        score = base if select == "raw" else fit
        for u in range(U):
            i = int(np.argmin(score[u]))
            # a unit whose every score is inf or NaN still records a tape
            if best[u] is None or score[u, i] < best_fit[u]:
                best_fit[u] = float(score[u, i])
                rows = slice(group * i, group * (i + 1))
                best[u] = (ops[u, rows].copy(), args[u, rows].copy(), consts[u, rows].copy())
            history[u, gen] = best_fit[u]
        if verbose and gen % 10 == 0:
            print(f"gen {gen}: best fit median {np.median(best_fit):.5f} "
                  f"min {best_fit.min():.5f}")
        new = [np.empty_like(a) for a in (ops, args, consts)]
        for u in range(U):
            pop_u = (ops[u], args[u], consts[u])
            if group == 1:
                o, a, c = breed(pop_u, fit[u], rngs[u], spec, cfg)
            else:
                from .objective import paired_breed

                o, a, c = paired_breed(pop_u, fit[u], rngs[u], spec, cfg)
            new[0][u], new[1][u], new[2][u] = o, a, c
        for a in new:  # padding units mirror the last real one
            a[U:] = a[U - 1]
        ops, args, consts = new
        device_s[gen], host_s[gen] = t1 - t0, time.perf_counter() - t1
    return SweepResult(best=best, best_fit=best_fit, history=history, device_s=device_s,
                       host_s=host_s)


def gp_sweep_plain(X_all: np.ndarray, dX_all: np.ndarray, spec: TapeSpec, cfg: GPConfig,
                   seeds, topk: Optional[int] = None, verbose: bool = False,
                   const_subsample: int = 512, select: str = "penalized", device=None,
                   eval_dtype: torch.dtype = torch.float32, mesh: Optional[Mesh] = None):
    """Per-dimension GP for S seeds: X_all, dX_all (S, N, d) per-seed
    subsamples; units as in ``plain_inputs``; eval_dtype and mesh as for
    ``_run_sweep``. Returns (per seed, per dim best tapes [[(ops, args,
    consts) for dim] for seed], SweepResult)."""
    device = resolve_device(device)
    d = X_all.shape[2]
    topk = topk if topk is not None else max(1, cfg.pop_size // 4)
    inputs = plain_inputs(X_all, dX_all, spec, cfg, seeds, const_subsample, device)
    res = _run_sweep(inputs, spec, cfg, topk=topk, device=device, verbose=verbose, select=select,
                     eval_dtype=eval_dtype, mesh=mesh)
    per_seed = [[tuple(arr[0] for arr in res.best[s * d + dim]) for dim in range(d)]
                for s in range(X_all.shape[0])]
    return per_seed, res


def gp_sweep_system(X_all: np.ndarray, dX_all: np.ndarray, spec: TapeSpec, cfg: GPConfig,
                    seeds, gx_all: Optional[np.ndarray] = None,
                    Jgx_all: Optional[np.ndarray] = None, w_sym_reg: float = 0.0,
                    topk: Optional[int] = None, verbose: bool = False,
                    const_subsample: int = 512, reference_bug_compat: bool = False,
                    device=None, eval_dtype: torch.dtype = torch.float32,
                    mesh: Optional[Mesh] = None):
    """Two-component system GP, optionally symmetry-regularised, for S
    seeds; inputs as in ``system_inputs``; eval_dtype and mesh as for
    ``_run_sweep``.
    The reported best is the raw loss's. Returns (per-seed best pairs
    [(h1, h2)], SweepResult)."""
    device = resolve_device(device)
    topk = topk if topk is not None else max(1, cfg.pop_size // 4)
    inputs = system_inputs(X_all, dX_all, spec, cfg, seeds, gx_all, Jgx_all, w_sym_reg,
                           const_subsample, reference_bug_compat, device)
    res = _run_sweep(inputs, spec, cfg, topk=topk, device=device, verbose=verbose, select="raw",
                     eval_dtype=eval_dtype, mesh=mesh)
    per_seed = [tuple((res.best[s][0][c], res.best[s][1][c], res.best[s][2][c])
                      for c in range(2)) for s in range(X_all.shape[0])]
    return per_seed, res
