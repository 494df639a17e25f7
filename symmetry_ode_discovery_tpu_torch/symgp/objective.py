"""Symmetry-regularised GP objective (EquivGP-r) for two-component systems.

The port's counterpart of symmetry_ode_discovery_tpu/symgp/objective.py. A
candidate system h = (h1, h2) is two interleaved tapes (ops[2k] is h1 of
individual k, ops[2k + 1] its h2), scored by

    loss = MSE(h(x), dx) + w_sym_reg * sum_i mean || J_gi(x) h(x) - h(g_i x) ||^2

with g_i(x) and J_gi(x) precomputed through the frozen LaLiGAN
(training/symmreg.py make_precompute_symmreg_r). The math is the sweep's
per-unit loss (sweep._system_unit_loss) with one unit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .evolve import GPConfig, NATIVE, _mutate, _splice, call_native_breed, make_gen_step
from .tape import TapeSpec, random_population, tape_length


def make_symmreg_fitness(spec: TapeSpec, X: torch.Tensor, dX: torch.Tensor, gx_list,
                         Jgx_list, w_sym_reg: float, parsimony: float,
                         reference_bug_compat: bool = False):
    """Fitness of two-component populations on one problem: X, dX (N, 2);
    gx_list of (N, 2); Jgx_list of (N, 2, 2), all tensors on one device.
    Returns (full(population) -> numpy (P,) with the parsimony term,
    device_loss(ops, args, consts) -> (1, P) for constant optimisation,
    each of ops, args, consts (1, 2P, L))."""
    from .sweep import _system_unit_loss

    N, d = X.shape
    if d != 2:
        raise ValueError(f"the system objective takes two components, got {d}")
    n_g = len(gx_list)
    unit = _system_unit_loss(spec, w_sym_reg, n_g, reference_bug_compat)
    gx = torch.stack(list(gx_list))[None] if n_g else X.new_zeros((1, 0, N, d))
    Jg = torch.stack(list(Jgx_list))[None] if n_g else X.new_zeros((1, 0, N, d, d))

    def device_loss(ops, args, consts):
        return unit(ops, args, consts, X[None], dX[None], gx, Jg)

    def full(population):
        ops, args, consts = (torch.as_tensor(a, device=X.device)[None] for a in population)
        with torch.no_grad():
            base = device_loss(ops, args, consts)[0].cpu().numpy()
        lens = tape_length(population[0]).reshape(-1, 2).sum(axis=1)
        return base + parsimony * lens

    return full, device_loss


def paired_population(rng, spec: TapeSpec, pop_size: int):
    """Interleaved two-component population: 2 * pop_size tapes."""
    return random_population(rng, spec, 2 * pop_size)


def paired_breed(population, fitness_P, rng, spec: TapeSpec, cfg: GPConfig):
    """Breed pair-coherent groups in the C++ core (breed_grouped): selection
    and crossover partners are whole (h1, h2) systems; variation applies
    per component."""
    ops = population[0]
    return call_native_breed(NATIVE.lib().breed_grouped, population, fitness_P,
                             (ops.shape[0] // 2, 2, ops.shape[1]), rng, spec, cfg)


def paired_breed_numpy(population, fitness_P, rng, spec: TapeSpec, cfg: GPConfig):
    """``paired_breed`` in numpy (the JAX package's numpy branch of
    ``paired_breed``): the elite groups first, then per group one
    tournament winner, a crossover partner drawn with probability
    p_crossover and a mutation decided with p_mutate, both applied to each
    component."""
    ops, args, consts = population
    n_groups = ops.shape[0] // 2
    order = np.argsort(fitness_P)
    new = []

    def tournament():
        idx = rng.integers(n_groups, size=cfg.tournament_size)
        return idx[np.argmin(fitness_P[idx])]

    for g in order[:cfg.elitism]:
        new.append([(ops[2 * g + c].copy(), args[2 * g + c].copy(),
                     consts[2 * g + c].copy()) for c in range(2)])
    while len(new) < n_groups:
        a = tournament()
        do_cx = rng.random() < cfg.p_crossover
        b = tournament() if do_cx else -1
        do_mut = rng.random() < cfg.p_mutate
        pair = []
        for c in range(2):
            ind = (ops[2 * a + c], args[2 * a + c], consts[2 * a + c])
            if do_cx:
                ind = _splice(ind, (ops[2 * b + c], args[2 * b + c],
                                    consts[2 * b + c]), rng, spec)
            if do_mut:
                ind = _mutate(ind, rng, spec)
            pair.append(ind)
        new.append(pair)
    out_ops = np.stack([p[c][0] for p in new for c in range(2)])
    out_args = np.stack([p[c][1] for p in new for c in range(2)])
    out_consts = np.stack([p[c][2] for p in new for c in range(2)])
    return out_ops, out_args, out_consts


def symbolic_regression_system(X: np.ndarray, dX: np.ndarray, spec: TapeSpec, cfg: GPConfig,
                               gx_list=None, Jgx_list=None, w_sym_reg: float = 0.0,
                               verbose: bool = False, device=None):
    """Evolve a two-component system dx = h(x), optionally
    symmetry-regularised, on ``device``. The reported best is the raw
    loss's (PySR 'accuracy', the reference's setting for this mode);
    breeding uses the penalised fitness. Returns (best pair, history)."""
    device = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    _, device_loss = make_symmreg_fitness(
        spec, t(X), t(dX), [t(g) for g in gx_list or []], [t(J) for J in Jgx_list or []],
        w_sym_reg, cfg.parsimony)
    rng = np.random.default_rng(cfg.seed)
    population = paired_population(rng, spec, cfg.pop_size)
    gen_step = make_gen_step(device_loss, cfg.const_opt_steps, cfg.const_opt_lr, group=2)
    best, best_fit, history = None, np.inf, []
    for gen in range(cfg.n_generations):
        ops, args, consts = (torch.as_tensor(a, device=device)[None] for a in population)
        c_final, base = gen_step(ops, args, consts)
        base = base[0].cpu().numpy()
        population = (population[0], population[1], c_final[0].cpu().numpy())
        lens = tape_length(population[0]).reshape(-1, 2).sum(axis=1)
        fit = base + cfg.parsimony * lens
        i = int(np.argmin(base))
        if base[i] < best_fit:
            best_fit = float(base[i])
            best = tuple((population[j][2 * i].copy(), population[j][2 * i + 1].copy())
                         for j in range(3))
        history.append(best_fit)
        if verbose and gen % 10 == 0:
            from .tape import tape_to_string

            h1 = tape_to_string(best[0][0], best[1][0], best[2][0])
            h2 = tape_to_string(best[0][1], best[1][1], best[2][1])
            print(f"gen {gen}: best {best_fit:.6f}  dx0={h1}  dx1={h2}")
        population = paired_breed(population, fit, rng, spec, cfg)
    return best, history
