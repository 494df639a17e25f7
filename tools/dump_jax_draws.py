"""Per-seed draws of the JAX package's CLI, written for the PyTorch port.

    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py \\
        --config lv/noise99_eq_isymreg.cfg --seeds 0-49 \\
        --out build/jax_draws/symreg2-noise99-lv.npz
    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py \\
        --config dosc/noise20_sindy.cfg --seeds 0-49 \\
        --perms eval_results/ref-sindy-noise20-dosc-perms.npz \\
        --out build/jax_draws/sindy-noise20-dosc-refperms.npz

Runs on the CPU. Reads (or, on a miss, generates and caches) the config's
training split with the JAX package's data/datasets.py::load_or_generate
under $SODT_DATA_PATH, then writes one npz keyed by seed in the format of
eval_results/ref-*-perms.npz (``seeds`` (S,) int32, ``idx`` (S, k) int32)
plus ``theta0`` (float32), each seed's initial parameters in the JAX
package's layout, and ``branch``. The port's CLI takes the file as
--subsample_perms on either of its branches, with the cache directory as
$SODT_TORCH_DATA_PATH.

The branch is the JAX CLI's (cli/main.py):
- stepped (a symmetry penalty, or a sweep without a ground truth;
  cli/main.py:273-275 and 359-363): kperm, kfit = split(fold_in(PRNGKey(0),
  s), 3)[:2], idx = permutation(kperm, n)[:k]; theta0 = init_params(kfit) of
  training/siged.py::_make_param_fns: Xi (d, p), or [beta, const] under a
  constraint;
- sweep (plain or constrained, with a ground truth): theta0 (n_params,) and,
  without --perms, idx as training/sweep.py::_prep_normal_eq draws them; with
  --perms, idx is that file's and only theta0 is drawn (what the tracked
  *-refperms records ran). The sweep's rows are checked against
  _prep_normal_eq's own reduction (S, B and q equal);
- wsindy (a *_wsindy.cfg, the JAX WSINDy CLI's default draws,
  training/sweep.py::sweep_wsindy): per seed k1, k2, _ = split(fold_in(
  PRNGKey(0), s), 3), start = randint(k1, (), 0, n_steps - w), traj =
  randint(k2, (), 0, n_ics), w = int(0.8 n_steps); written as ``start``
  and ``traj`` (no idx, no theta0), which the port's cli/main_wsindy.py
  takes as --subsample_perms. The windows are checked against the JAX
  sweep itself: solved on them, they give its Xi and masks.

    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py \\
        --config lv/noise99_eq_wsindy.cfg --seeds 0-49 \\
        --out build/jax_draws/wsindy-noise99-lv.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # `python tools/<me>.py` puts tools/ first instead
    sys.path.insert(0, REPO)


def parse_seeds(text: str) -> list:
    """'0-49' or '0,3,7' -> a list of seeds."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def fit_setup(args: dict):
    """(cfg, Q) of the JAX CLI for the parsed flags ``args`` (input_dim
    set), built as cli/main.py::run builds them: the generator from
    --load_laligan or from PRNGKey(seed), the constraint's generators cut to
    one component."""
    import jax

    from symmetry_ode_discovery_tpu.cli.main import build_models, truncated_L_list
    from symmetry_ode_discovery_tpu.models import lie_generator as lg
    from symmetry_ode_discovery_tpu.models.sindy import make_config
    from symmetry_ode_discovery_tpu.utils import checkpoint as ckpt

    ae_def, spec, _ = build_models(args)
    key = jax.random.PRNGKey(args["seed"])
    k_init, key = jax.random.split(key)
    ae_params, ae_bstats = ae_def.init(k_init)
    k_g, key = jax.random.split(key)
    g_state = lg.init_generator(k_g, spec)
    if args["load_laligan"] is not None:
        bundle = {"ae": ae_params, "d": {}, "g": g_state}
        bundle, _ = ckpt.load_laligan(args["load_laligan"], bundle, ae_bstats)
        g_state = bundle["g"]
    L_list = truncated_L_list(spec, g_state, args["n_comps"]) if args["eq_constraint"] else []
    return make_config(
        args["latent_dim"], poly_order=args["poly_order"], include_sine=args["include_sine"],
        include_exp=args["include_exp"], L_list=L_list,
        constrain_constant=args["constrain_constant"], threshold=args["threshold"],
        dangling_const=args.get("compat_dangling_const", False))


def stepped_draws(cfg, Q, n: int, k: int, seeds) -> tuple:
    """(idx (S, k), theta0 (S, d, p) or (S, n_params)) of the JAX CLI's
    host-stepped fit (cli/main.py:359-363, training/siged.py:96-113)."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.training.siged import _make_param_fns

    init_params = _make_param_fns(cfg, jnp.asarray(Q) if Q is not None else None)[0]
    idx, theta0 = [], []
    for s in seeds:
        kk = jax.random.fold_in(jax.random.PRNGKey(0), s)
        kperm, kfit, _ = jax.random.split(kk, 3)
        idx.append(np.asarray(jax.random.permutation(kperm, n)[:k]))
        p0 = init_params(kfit)
        theta0.append(np.asarray(p0["Xi"]) if "Xi" in p0 else np.concatenate(
            [np.asarray(p0["beta"])] + ([np.asarray(p0["const"]).reshape(-1)]
                                        if "const" in p0 else [])))
    return np.stack(idx), np.stack(theta0)


def sweep_draws(cfg, Q, x, dx, k: int, seeds, perms=None) -> tuple:
    """(idx (S, k), theta0 (S, n_params)) of the JAX CLI's plain or
    constrained sweep (training/sweep.py::_prep_normal_eq); ``perms`` (S,
    k) replaces its subsample. Raises if the rows do not give
    _prep_normal_eq's own reduction."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.training.siged import LBFGSHParams
    from symmetry_ode_discovery_tpu.training.sweep import _pallas_setup, _prep_normal_eq

    n = x.shape[0]
    n_params = _pallas_setup(cfg, Q, LBFGSHParams())[2]
    if perms is None:
        perms = np.stack([np.asarray(jax.random.permutation(
            jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), s))[0], n)[:k])
            for s in seeds])
        S, B, q, _, _ = _prep_normal_eq(cfg, k, n_params, x, dx, jnp.asarray(seeds))
        S2, B2, q2, _, _ = _prep_normal_eq(cfg, k, n_params, x, dx, jnp.asarray(seeds),
                                           jnp.asarray(perms))
        for a, b in ((S, S2), (B, B2), (q, q2)):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise RuntimeError("the subsample rows differ from _prep_normal_eq's draw")
    theta0 = _prep_normal_eq(cfg, k, n_params, x, dx, jnp.asarray(seeds),
                             jnp.asarray(perms))[4]
    return np.asarray(perms, np.int32), np.asarray(theta0)


def wsindy_draws(n_ics: int, n_steps: int, seeds) -> tuple:
    """(start (S,), traj (S,)) of the JAX WSINDy sweep's default windows
    (training/sweep.py::sweep_wsindy, subsample_rng "jax")."""
    import jax

    w = int(0.8 * n_steps)
    start, traj = [], []
    for s in seeds:
        k1, k2, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), s), 3)
        start.append(int(jax.random.randint(k1, (), 0, n_steps - w)))
        traj.append(int(jax.random.randint(k2, (), 0, n_ics)))
    return np.asarray(start, np.int32), np.asarray(traj, np.int32)


def check_wsindy_draws(args: dict, x_trajs, seeds, start, traj) -> None:
    """Raise unless the JAX WSINDy sweep's Xi and masks (its own draws)
    equal those of the same solves on the windows (start, traj)."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.data.datasets import ode_dt_dict
    from symmetry_ode_discovery_tpu.evaluation.eval_eq import sindy_truth
    from symmetry_ode_discovery_tpu.models.sindy import get_Xi, init_sindy, make_config
    from symmetry_ode_discovery_tpu.models.wsindy import make_wsindy_matrices, solve_wsindy
    from symmetry_ode_discovery_tpu.training.sweep import sweep_wsindy

    cfg, _ = make_config(args["input_dim"], poly_order=args["poly_order"],
                         include_sine=args["include_sine"], include_exp=args["include_exp"],
                         threshold=args["threshold"])
    dt = ode_dt_dict[args["task"]]
    x_trajs = jnp.asarray(x_trajs)
    ref = sweep_wsindy(cfg, x_trajs, dt, sindy_truth[args["task"]], np.asarray(seeds),
                       w_sindy_reg=args["w_sindy_reg"], threshold=args["threshold"],
                       num_epochs=args["num_epochs"], n_mesh_devices=1)
    w = int(0.8 * x_trajs.shape[1])
    mats = make_wsindy_matrices(jnp.arange(w) * dt, float(w * dt))

    def on_window(seed, s0, tr):
        k3 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), seed), 3)[2]
        window = jax.lax.dynamic_slice_in_dim(x_trajs[tr], s0, w, axis=0)
        st, _ = solve_wsindy(cfg, init_sindy(k3, cfg), mats, window, args["w_sindy_reg"],
                             args["threshold"], args["num_epochs"])
        return get_Xi(cfg, st), st.mask

    Xi, mask = jax.jit(jax.vmap(on_window))(jnp.asarray(seeds), jnp.asarray(start),
                                             jnp.asarray(traj))
    if not (np.array_equal(np.asarray(mask), np.asarray(ref.mask))
            and np.allclose(np.asarray(Xi), np.asarray(ref.Xi), rtol=0, atol=1e-6)):
        raise RuntimeError("the windows do not give the JAX WSINDy sweep's own result")


def dump(config: str, seeds, out: str, perms: str = None, extra=()) -> dict:
    """Write the draws of ``seeds`` for ``config`` (a run_configs path,
    ``extra`` further CLI flags) to ``out``; returns what was written."""
    from symmetry_ode_discovery_tpu.data.datasets import load_or_generate
    from symmetry_ode_discovery_tpu.evaluation.eval_eq import sindy_truth
    from symmetry_ode_discovery_tpu.utils.config import get_args

    args = vars(get_args(["--config", config] + list(extra)))
    x, dx = load_or_generate(args["task"], "train", args["noise"], args["smoothing"])
    if config.endswith("_wsindy.cfg"):
        if perms:
            raise ValueError("--perms applies to the L-BFGS sweep branch only")
        args["input_dim"] = int(x.shape[-1])
        start, traj = wsindy_draws(int(x.shape[0]), int(x.shape[1]), seeds)
        check_wsindy_draws(args, np.asarray(x), seeds, start, traj)
        rec = dict(seeds=np.asarray(seeds, np.int32), start=start, traj=traj,
                   branch=np.asarray("wsindy"))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez(out, **rec)
        print(f"{config}: wsindy branch, {x.shape[0]} trajectories of {x.shape[1]} steps "
              f"-> {out}")
        return rec
    x, dx = x.reshape(-1, x.shape[-1]), dx.reshape(-1, dx.shape[-1])
    args["input_dim"] = int(x.shape[-1])
    cfg, Q = fit_setup(args)
    n = int(x.shape[0])
    k = int(n * args["lbfgs_subsample"])
    stepped = args["w_sym_reg"] > 0.0 or sindy_truth.get(args["task"]) is None
    if stepped:
        if perms:
            raise ValueError("--perms applies to the sweep branch only, as in the JAX CLI")
        idx, theta0 = stepped_draws(cfg, Q, n, k, seeds)
    else:
        rows = None
        if perms:
            with np.load(perms) as z:
                dump_seeds = list(np.asarray(z["seeds"]))
                rows = np.asarray(z["idx"])[[dump_seeds.index(s) for s in seeds]]
        idx, theta0 = sweep_draws(cfg, Q, x, dx, k, seeds, rows)
    rec = dict(seeds=np.asarray(seeds, np.int32), idx=idx.astype(np.int32),
               theta0=theta0.astype(np.float32), branch=np.asarray("stepped" if stepped
                                                                  else "sweep"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **rec)
    print(f"{config}: {rec['branch']} branch, n {n}, k {k}, theta0 {theta0.shape[1:]} "
          f"-> {out}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="a run_configs/ path, e.g. lv/noise99_sym.cfg")
    ap.add_argument("--seeds", default="0-49")
    ap.add_argument("--perms", default=None,
                    help="a ref-*-perms.npz whose idx the sweep keeps (only theta0 is drawn)")
    ap.add_argument("--out", required=True)
    a, extra = ap.parse_known_args(argv)
    dump(a.config, parse_seeds(a.seeds), a.out, a.perms, extra)


if __name__ == "__main__":
    main()
