"""Genetic-programming equation discovery (plain GP and EquivGP-r), driven by
the same run_configs/*.cfg files as the JAX package's cli/main_gp.py.

    python -m symmetry_ode_discovery_tpu_torch.cli.main_gp \
        --config lv/noise99_eq_gp_symm.cfg --n_seeds 50 --eval_root <dir>

- plain mode: independent per-dimension symbolic regression with MSE loss;
- --pysr_symmreg (EquivGP-r): a two-component system with the reversed
  symmetry penalty, g(x) and J_g(x) precomputed through the LaLiGAN read
  from ``ckpt_root``/<load_laligan>.

Each seed s subsamples ``pysr_subsample`` of the training rows with
np.random.default_rng(s).choice, as the JAX package does, so both packages
fit the same rows of the same data. With --n_seeds > 1 the seeds run as
sweeps of --seed_chunk seeds (symgp/sweep.py) on at most --gp_fitness_rows
rows each; every seed's equations go to
<eval_root>/<save_dir>/equation[s]_seed<N>.txt and its scores to
<eval_root>/<save_dir>/seed<N>.npz, and seeds that already have an npz are
skipped unless --overwrite_eval. A single seed runs the whole-population
engine (symgp/evolve.py, symgp/objective.py) on every subsampled row and
writes its equation file only. Nothing is written outside --eval_root.

Fitness runs K5 and the constant gradient K6 on the card whatever
--gp_eval_backend and --gp_grad_backend say: the JAX package's two backends
of each agree by design. --gp_eval_dtype bf16 runs the sweeps' full-batch
fitness evaluations in K5's bf16 mode (the Adam gradient stays f32), as the
JAX package's sweeps do; the single-seed engine ignores it there and here.
--mesh_devices N > 1 shards each sweep chunk's units over the first N CUDA
devices (symgp/sweep.py; ValueError when fewer exist), a chunk the mesh
does not divide padded with copies of its last unit; the single-seed
engine runs on one device.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..utils import watchdog


def _task_spec(task: str, n_vars: int):
    """Per-task GP search space (reference main_pysr.py:135-212)."""
    from ..symgp.tape import ADD, EXP, MUL, SUB, TapeSpec

    unary = (EXP,) if task == "lv" else ()
    maxsize = {"lv": 25, "selkov": 40}.get(task, 25)
    return TapeSpec(n_vars=n_vars, max_len=min(maxsize, 40),
                    binary_ops=(ADD, SUB, MUL), unary_ops=unary)


def _unported(args: dict):
    if args.get("mt_data") or args["task"].startswith("mt_"):
        raise NotImplementedError("the GP engine takes the ODE systems only (ROADMAP item 9)")


def make_gx_fn(args: dict, device, ckpt_root: str = "saved_models"):
    """precompute(x) -> (gx_list, Jgx_list) of EquivGP-r from the LaLiGAN
    checkpoint ``ckpt_root``/<load_laligan>; args["input_dim"] must be set."""
    from ..convert import laligan_from_npz
    from ..training.symmreg import make_precompute_symmreg_r
    from .main import build_models

    if not args.get("load_laligan"):
        raise ValueError(
            "--pysr_symmreg needs a trained LaLiGAN checkpoint: pass --load_laligan "
            "<run_name> (the symmetry-regularized GP objective needs learned g(x), J_g(x))")
    ae, gspec = build_models(args)
    sd, g_state = laligan_from_npz(os.path.join(ckpt_root, args["load_laligan"]), device)
    ae.load_state_dict(sd)
    ae = ae.to(device).eval().requires_grad_(False)
    return make_precompute_symmreg_r(ae, gspec, g_state)


def _tables(gx_fn, x: np.ndarray, device):
    """(gx (n_g, N, d), Jg (n_g, N, d, d)) numpy for the rows x."""
    gx_list, Jgx_list = gx_fn(torch.as_tensor(x, device=device))
    return (np.stack([g.cpu().numpy() for g in gx_list]),
            np.stack([J.cpu().numpy() for J in Jgx_list]))


def gp_config(args: dict, seed: int):
    from ..symgp.evolve import GPConfig

    return GPConfig(pop_size=args.get("pysr_bs", 1000),
                    n_generations=args.get("gp_generations", 40), seed=seed)


def seed_rows(x_all, dx_all, subsample_size: int, seed: int, cap=None):
    """Seed ``seed``'s rows as numpy: the first ``cap`` of
    np.random.default_rng(seed).choice(N, subsample_size, replace=False)."""
    idx = np.random.default_rng(seed).choice(x_all.shape[0], subsample_size,
                                             replace=False)[:cap]
    it = torch.as_tensor(idx, device=x_all.device)
    return x_all[it].cpu().numpy(), dx_all[it].cpu().numpy()


def chunk_rows(args: dict, x_all, dx_all, seeds, gx_fn, device):
    """The rows one sweep chunk of ``seeds`` fits: X, dX (S, R, d), each
    seed's first --gp_fitness_rows rows of its subsample, and with
    --pysr_symmreg their g(x) and J_g(x), gx (S, n_g, R, d) and
    Jg (S, n_g, R, d, d) (else None)."""
    subsample_size = int(x_all.shape[0] * args["pysr_subsample"])
    # cap on the rows each generation evaluates; rng.choice is uniform, so
    # the first rows of a seed's subsample are a uniform subsample too
    cap = args.get("gp_fitness_rows", 2500) or subsample_size
    xs, dxs = zip(*(seed_rows(x_all, dx_all, subsample_size, s, min(subsample_size, cap))
                    for s in seeds))
    gx = Jg = None
    if args["pysr_symmreg"]:
        gx, Jg = (np.stack(t) for t in zip(*(_tables(gx_fn, x, device) for x in xs)))
    return np.stack(xs), np.stack(dxs), gx, Jg


def _write_eqs(out_dir: str, name: str, eqs):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("\n".join(eqs))


def run(args: dict, train_data=None, device=None, ckpt_root: str = "saved_models",
        mesh=None) -> dict:
    """Run GP discovery for the parsed flags ``args`` (a dict, as from
    ``vars(get_args(argv))``) on ``device``. ``train_data`` (x, dx), each
    (N, dim), replaces the cached or generated training split; the LaLiGAN
    checkpoint is read from ``ckpt_root``. Returns the equations per seed
    and, for sweeps, per chunk its seeds, wall seconds, per-generation
    device and host seconds, and each seed's correct_form. ``mesh``
    (parallel/mesh.Mesh, its devices may repeat) shards the sweeps in place
    of --mesh_devices."""
    from ..data.datasets import get_dataset
    from ..symgp.evolve import symbolic_regression
    from ..symgp.objective import symbolic_regression_system
    from ..symgp.tape import tape_to_string

    _unported(args)
    device = resolve_device(device)
    t_start = time.perf_counter()
    if train_data is None:
        train_ds, args = get_dataset(args, device)
        x_all, dx_all = train_ds.x, train_ds.dx
    else:
        x_all, dx_all = (torch.as_tensor(a, dtype=torch.float32, device=device)
                         for a in train_data)
        args["input_dim"] = x_all.shape[-1]
    n_rows = x_all.shape[0]
    subsample_size = int(n_rows * args["pysr_subsample"])
    spec = _task_spec(args["task"], x_all.shape[1])
    out_dir = os.path.join(args.get("eval_root", "eval_results"), args["save_dir"])

    gx_fn = None
    if args["pysr_symmreg"]:
        if args.get("gp_select", "penalized") != "penalized":
            print("note: --gp_select is ignored with --pysr_symmreg "
                  "(symm mode always selects by raw loss, PySR 'accuracy')")
        gx_fn = make_gx_fn(args, device, ckpt_root)

    n_seeds = args.get("n_seeds", 1)
    seed0 = args["seed"]
    if n_seeds > 1:
        return _run_sweep_mode(args, x_all, dx_all, spec, gx_fn, out_dir, seed0, n_seeds,
                               device, t_start, mesh)
    results = []
    for seed in range(seed0, seed0 + n_seeds):
        x, dx = seed_rows(x_all, dx_all, subsample_size, seed)
        cfg = gp_config(args, seed)
        if args["pysr_symmreg"]:
            gx, Jg = _tables(gx_fn, x, device)
            best, _ = symbolic_regression_system(
                x, dx, spec, cfg, gx_list=list(gx), Jgx_list=list(Jg),
                w_sym_reg=args["w_sym_reg"], verbose=args.get("print_eq", False),
                device=device)
            eqs = [tape_to_string(best[0][c], best[1][c], best[2][c]) for c in range(2)]
            _write_eqs(out_dir, f"equation_seed{seed}.txt", eqs)
        else:
            eqs = []
            for d in range(dx.shape[1]):
                best, _ = symbolic_regression(x, dx[:, d], spec, cfg, device=device)
                eqs.append(tape_to_string(*best))
            _write_eqs(out_dir, f"equations_seed{seed}.txt", eqs)
        print(f"seed {seed}:")
        for i, e in enumerate(eqs):
            print(f"  dx{i} = {e}")
        results.append(eqs)
    return {"equations": results}


def _run_sweep_mode(args, x_all, dx_all, spec, gx_fn, out_dir, seed0, n_seeds, device,
                    t_start, mesh=None):
    """Chunks of --seed_chunk seeds through symgp/sweep.py, scored by the
    sympy form projector (symgp/eval_gp.py), one eval npz per seed."""
    from ..evaluation.eval_eq import save_eval_results
    from ..parallel.mesh import make_mesh
    from ..symgp.eval_gp import eval_gp_equations
    from ..symgp.sweep import gp_sweep_plain, gp_sweep_system
    from ..symgp.tape import tape_to_string

    eval_root = args.get("eval_root", "eval_results")
    symm = bool(args["pysr_symmreg"])
    eq_name = "equation_seed{}.txt" if symm else "equations_seed{}.txt"
    done_seeds = set()
    if not args.get("overwrite_eval"):
        done_seeds = {s for s in range(seed0, seed0 + n_seeds)
                      if os.path.exists(os.path.join(out_dir, f"seed{s}.npz"))}
    if done_seeds:
        print(f"resume: skipping {len(done_seeds)} already-evaluated seeds")
    results = {}
    for s in done_seeds:
        path = os.path.join(out_dir, eq_name.format(s))
        if os.path.exists(path):
            with open(path) as f:
                results[s] = f.read().strip().splitlines()

    seeds = [s for s in range(seed0, seed0 + n_seeds) if s not in done_seeds]
    chunk = max(1, args.get("seed_chunk", 10))
    cfg = gp_config(args, seed0)
    eval_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.get("gp_eval_dtype", "f32")]
    if mesh is None and (args.get("mesh_devices") or 0) > 1:
        mesh = make_mesh(args["mesh_devices"])
    chunks, correct_form = [], {}
    for lo in range(0, len(seeds), chunk):
        sub_seeds = seeds[lo:lo + chunk]
        t0 = time.perf_counter()
        X, dX, gx, Jg = chunk_rows(args, x_all, dx_all, sub_seeds, gx_fn, device)
        if symm:
            per_seed, res = gp_sweep_system(
                X, dX, spec, cfg, sub_seeds, gx_all=gx, Jgx_all=Jg,
                w_sym_reg=args["w_sym_reg"], verbose=args.get("print_eq", False), device=device,
                eval_dtype=eval_dtype, mesh=mesh)
        else:
            per_seed, res = gp_sweep_plain(
                X, dX, spec, cfg, sub_seeds, verbose=args.get("print_eq", False),
                select=args.get("gp_select", "penalized"), device=device, eval_dtype=eval_dtype,
                mesh=mesh)
        watchdog.beat()
        for seed, best in zip(sub_seeds, per_seed):
            eqs = [tape_to_string(*b) for b in best]
            _write_eqs(out_dir, eq_name.format(seed), eqs)
            # terms at or below the threshold are dropped; keep the cut under
            # the smallest true coefficient (0.1 in dosc and growth)
            ev = eval_gp_equations(eqs, args["task"], threshold=min(args["threshold"], 0.05))
            save_eval_results(ev, args["save_dir"], seed, eval_root)
            results[seed] = eqs
            correct_form[seed] = ev["correct_form"].tolist()
            print(f"seed {seed}: correct_form={ev['correct_form']}  "
                  + "  ".join(f"dx{i}={e}" for i, e in enumerate(eqs)), flush=True)
        chunks.append({"seeds": sub_seeds, "wall_s": time.perf_counter() - t0,
                       "device_s": res.device_s.tolist(), "host_s": res.host_s.tolist(),
                       "best_fit": res.best_fit.tolist()})
    print(f"Swept {len(seeds)} GP seeds ({len(done_seeds)} resumed) in "
          f"{time.perf_counter() - t_start:.1f} s -> {out_dir}")
    return {"equations": [results.get(s) for s in range(seed0, seed0 + n_seeds)],
            "chunks": chunks, "correct_form": correct_form}


def main(argv=None):
    from ..utils import watchdog
    from ..utils.config import get_args

    args = vars(get_args(argv))
    # the first dispatch watched, then a heartbeat fed once a chunk; a stall
    # relaunches once (chunks resume from their eval files), then exits 42
    watchdog.probe_first_dispatch()
    if torch.cuda.is_available():
        watchdog.start_heartbeat(timeout_s=900.0)
    try:
        return run(args)
    finally:
        watchdog.stop_heartbeat()  # no watchdog outlives the run


if __name__ == "__main__":
    main()
