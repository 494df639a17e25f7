"""Genetic-programming evolution: fitness and constant optimisation on the
device, breeding on the host.

The port's counterpart of symmetry_ode_discovery_tpu/symgp/evolve.py:

- FITNESS: the whole population evaluates on the whole dataset in one
  launch of K5 (ops/tape_eval.py), on the CPU through its plain version.
- CONSTANTS: a few Adam steps in optax's order per generation, the
  gradient by K6 through ``tape_eval.eval_tapes``'s backward.
- BREEDING: tournament selection, postfix-subtree crossover and point,
  hoist and subtree mutation in the C++ core (csrc/evolve.cpp, the port's
  copy of the JAX package's core), built with g++ at first use and bound by
  ctypes. A failed build or load raises: the JAX package's numpy fallback
  (``breed_numpy``) draws other random streams and is not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import platform

import numpy as np
import torch

from ..ops._nvcc import CSRC, Kernel
from .tape import ARITY, TapeSpec, random_population, tape_length


@dataclasses.dataclass(frozen=True)
class GPConfig:
    pop_size: int = 512
    n_generations: int = 40  # reference 'niterations' (main_pysr.py:139)
    tournament_size: int = 5
    p_crossover: float = 0.5
    p_mutate: float = 0.5
    elitism: int = 4
    parsimony: float = 0.0016  # complexity penalty (main_pysr.py:146)
    const_opt_steps: int = 8
    const_opt_lr: float = 0.05
    seed: int = 0


def subtree_span(ops_row: np.ndarray, i: int) -> int:
    """Start index of the postfix subtree ending at position i."""
    need = 1
    j = i
    while need > 0 and j >= 0:
        need -= 1
        need += int(ARITY[ops_row[j]])
        j -= 1
    return j + 1


# ---- the C++ breeding core ----

# -mfma, not -march=native: the library must load on any x86-64 host with
# FMA, and the JAX package's -march=native build contracts the point
# mutation's c * (1 + 0.3 n1) + 0.1 n2 into FMAs, so both cores breed the
# same bits only when this one may contract too.
BREED_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17") + (
    ("-mfma",) if platform.machine().lower() in ("x86_64", "amd64") else ())
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_PTRS = [_i32p, _i32p, _f32p, _f32p, _i32p, _i32p, _f32p]
_TAIL = [ctypes.c_int, ctypes.c_int,                  # tournament, elitism
         ctypes.c_float, ctypes.c_float, ctypes.c_int,
         _i32p, ctypes.c_int, _i32p, ctypes.c_int,
         ctypes.c_float, ctypes.c_ulonglong]
NATIVE = Kernel(CSRC / "evolve.cpp", BREED_FLAGS, {
    "breed": (_PTRS + [ctypes.c_int, ctypes.c_int] + _TAIL, None),            # P, L
    "breed_grouped": (_PTRS + [ctypes.c_int] * 3 + _TAIL, None)},             # groups, group, L
    compiler="g++")


def call_native_breed(fn, population, fitness, dims, rng, spec: TapeSpec, cfg: GPConfig):
    """ctypes marshalling shared by ``breed`` and ``breed_grouped``; ``dims``
    is (P, L) or (n_groups, group, L). Draws the core's seed as
    ``rng.integers(2**63)``, as the JAX package does."""
    ops, args, consts = (np.ascontiguousarray(x, dt)
                         for x, dt in zip(population, (np.int32, np.int32, np.float32)))
    out_ops = np.zeros_like(ops)
    out_args = np.zeros_like(args)
    out_consts = np.zeros_like(consts)
    fit = np.ascontiguousarray(np.asarray(fitness, np.float32))
    bins = np.asarray(list(spec.binary_ops), np.int32)
    uns = np.asarray(list(spec.unary_ops) or [0], np.int32)
    fn(ops.ctypes.data_as(_i32p), args.ctypes.data_as(_i32p),
       consts.ctypes.data_as(_f32p), fit.ctypes.data_as(_f32p),
       out_ops.ctypes.data_as(_i32p), out_args.ctypes.data_as(_i32p),
       out_consts.ctypes.data_as(_f32p),
       *dims, cfg.tournament_size, cfg.elitism,
       cfg.p_crossover, cfg.p_mutate, spec.n_vars,
       bins.ctypes.data_as(_i32p), len(bins),
       uns.ctypes.data_as(_i32p), len(spec.unary_ops),
       spec.const_range, int(rng.integers(2 ** 63)))
    return out_ops, out_args, out_consts


def breed(population, fitness, rng, spec: TapeSpec, cfg: GPConfig):
    """One generation of tournament selection, crossover and mutation."""
    P, L = population[0].shape
    return call_native_breed(NATIVE.lib().breed, population, fitness, (P, L), rng, spec, cfg)


# ---- fitness and constant optimisation ----

def make_fitness_fn(spec: TapeSpec, X: torch.Tensor, y: torch.Tensor):
    """MSE(h(X), y) per tape, with non-finite (diverged or stack-overflowed)
    tapes scored +inf; ops, args, consts (U, P, L) -> (U, P). X (U, N, d),
    y (U, N). The parsimony term is added on the host."""
    from .sweep import _plain_unit_loss

    loss = _plain_unit_loss(spec)
    return lambda ops, args, consts: loss(ops, args, consts, X, y)


class Adam:
    """optax.adam(lr) update for update (b1 0.9, b2 0.999, eps 1e-8):
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; the bias corrections
    1 - b^count in float32; update -lr * mu_hat / (sqrt(nu_hat) + eps)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, c):
        return torch.zeros_like(c), torch.zeros_like(c), 0

    def step(self, c, g, state):
        mu, nu, count = state
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * g ** 2 + self.b2 * nu
        count += 1
        f32 = dict(dtype=torch.float32, device=c.device)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** count
        bc2 = 1 - torch.tensor(self.b2, **f32) ** count
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return c + (-self.lr) * upd, (mu, nu, count)


def const_grad(loss_fn, ops, args, c, *data):
    """d sum(loss) / d consts with non-finite entries zeroed."""
    c = c.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(ops, args, c, *data).sum(), c)
    return torch.where(torch.isfinite(g), g, 0.0)


def make_gen_step(loss_fn, steps: int, lr: float, group: int = 1):
    """One generation of constant optimisation and fitness over whole
    populations (the single-seed path). loss_fn maps (ops, args, consts),
    each (U, G*P, L), to per-group losses (U, P); acceptance is per group
    (all ``group`` component tapes share the decision). Returns
    gen(ops, args, consts) -> (final consts, fitness)."""
    opt = Adam(lr)

    @torch.no_grad()
    def gen(ops, args, c0):
        if steps <= 0:
            return c0, loss_fn(ops, args, c0)
        c, state = c0, opt.init(c0)
        for _ in range(steps):
            c, state = opt.step(c, const_grad(loss_fn, ops, args, c), state)
        f_old = loss_fn(ops, args, c0)
        f_new = loss_fn(ops, args, c)
        take = torch.repeat_interleave(f_new < f_old, group, dim=-1)
        return torch.where(take[..., None], c, c0), torch.minimum(f_new, f_old)

    return gen


def symbolic_regression(X: np.ndarray, y: np.ndarray, spec: TapeSpec, cfg: GPConfig,
                        device_loss=None, verbose: bool = False, device=None):
    """Evolve expressions fitting y = h(X) on ``device``. Returns (best
    individual, history). device_loss optionally overrides the per-tape loss
    (ops, args, consts), each (1, P, L), -> (1, P); the parsimony term is
    added here."""
    from .. import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    Xt = torch.as_tensor(np.asarray(X, np.float32), device=device)[None]
    yt = torch.as_tensor(np.asarray(y, np.float32), device=device)[None]
    if device_loss is None:
        device_loss = make_fitness_fn(spec, Xt, yt)
    population = random_population(rng, spec, cfg.pop_size)
    gen_step = make_gen_step(device_loss, cfg.const_opt_steps, cfg.const_opt_lr)
    best, best_fit, history = None, np.inf, []
    for gen in range(cfg.n_generations):
        ops, args, consts = (torch.as_tensor(a, device=device)[None] for a in population)
        c_final, base = gen_step(ops, args, consts)
        population = (population[0], population[1], c_final[0].cpu().numpy())
        fit = base[0].cpu().numpy() + cfg.parsimony * tape_length(population[0])
        i = int(np.argmin(fit))
        if fit[i] < best_fit:
            best_fit = float(fit[i])
            best = tuple(a[i].copy() for a in population)
        history.append(best_fit)
        if verbose and gen % 10 == 0:
            from .tape import tape_to_string

            print(f"gen {gen}: best {best_fit:.6f}  {tape_to_string(*best)}")
        population = breed(population, fit, rng, spec, cfg)
    return best, history
