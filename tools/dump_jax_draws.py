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

--lassi (a LaLiGAN config, e.g. lv/noise99_sym.cfg) writes a reduced replay
of the JAX trainer (training/lassi.py) at the config's full width: the first
--lassi_batches x batch_size windows of the train split (``x``; all of them
with --lassi_batches 0, and their derivatives ``dx`` for a joint SINDy
config, whose init/ and final/ also hold the SINDy state), the trainer's
init (LassiTrainer.init on the key train_lassi splits from PRNGKey(seed),
under ``init/``), each epoch's batch permutation (``perm`` (E, B, bs)) and
each batch's coefficient draws (``coef`` (E, B, G, bs, ch): the standard
normal, uniform or integer draws of each group index before sigma), rebuilt
from the key chain of train_lassi and _epoch_impl (per epoch key, sub =
split(key); kperm, kscan = split(sub); per batch kscan, sub = split(kscan);
per group index sub, k = split(sub)), then the per-batch metrics
(``batch/<name>`` (E, B)), per-epoch means (``epoch/<name>``) and final
parameters (under ``final/``) of --lassi_epochs epochs; for a joint SINDy
config also the JAX trainer's float64 run on the same draws
(``batch64/``, ``epoch64/``, ``mask64``). The draws are checked
against the trainer itself: fed back in place of its PRNG, each epoch
reproduces trainer.epoch bit for bit (``bit_equal``).

    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py --lassi \\
        --config lv/noise99_sym.cfg --out build/jax_draws/lassi-noise99-lv.npz
    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py --lassi \\
        --config rd/sym_eq.cfg --lassi_batches 0 --lassi_epochs 5 \\
        --out build/jax_draws/lassi-sindy-rd.npz

A config run with --use_latent (flags after the known ones go to the JAX
parser) gives the latent branch (cli/main.py:275-290): per seed kperm,
kfit, kdst = split(fold_in(PRNGKey(0), s), 3), idx = permutation(kperm,
n)[:k], ``theta0`` = init_params(kfit) of the latent fit and ``theta0_dst``
= the distillation's Xi (D, p) from kdst; the port's CLI takes it as
--subsample_perms.

    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py \\
        --config selkov/noise20_eq_symreg.cfg --seeds 0-49 \\
        --out build/jax_draws/latent-noise20-selkov.npz \\
        --w_sym_reg 0 --use_latent --distill_latent

--adam writes a replay of the Adam trainer (training/siged_adam.py) as the
JAX CLI builds it for the config with --sindy_optimizer adam (the composed
make_sym_reg_fn in place of the fast penalty): the first --adam_rows rows
of the train split (``x``, ``dx``; all with 0), seed --seeds' draws from
train_siged_adam's key chain (``theta0`` (1, n_params) in the JAX layout,
``perm`` (1, E, n_batches * bs): per epoch key, sub = split(key),
permutation(sub, n) cut), then after each of --adam_epochs epochs the
parameters (``params`` (E, n_params)), the mask and the epoch's mean loss
components (``epoch/<name>``), in float32 and (``params64``, ``mask64``,
``epoch64/``) under jax.enable_x64 on the same permutations. The fed
permutations are checked against trainer.epoch (``bit_equal``). The port's
cli/replay_adam.py replays it.

    SODT_DATA_PATH=build/jax_data python tools/dump_jax_draws.py --adam \\
        --config selkov/noise20_eq_symreg.cfg --seeds 0 --adam_epochs 3 \\
        --out build/jax_draws/adam-noise20-selkov.npz

--val_cache writes the config's clean validation split (noise 0, no
smoothing; what cli/eval_ltp_sweep.py rolls out against) into
$SODT_DATA_PATH and nothing else (--out is not written).
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


def _flat_params(p) -> np.ndarray:
    """A parameter dict of _make_param_fns flattened in the JAX layout: Xi
    as it is (d, p), or [beta, const] (n_params,)."""
    if "Xi" in p:
        return np.asarray(p["Xi"])
    return np.concatenate([np.asarray(p["beta"])] + (
        [np.asarray(p["const"]).reshape(-1)] if "const" in p else []))


def latent_draws(args: dict, cfg, Q, n: int, k: int, seeds) -> tuple:
    """(idx (S, k), theta0, theta0_dst (S, D, p_dst)) of the JAX CLI's
    latent branch (cli/main.py:275-290): kperm, kfit, kdst = split(fold_in(
    PRNGKey(0), s), 3)."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.models.sindy import make_config
    from symmetry_ode_discovery_tpu.training.siged import _make_param_fns

    init = _make_param_fns(cfg, jnp.asarray(Q) if Q is not None else None)[0]
    cfg_dst, _ = make_config(args["input_dim"], poly_order=args["poly_order"],
                             include_sine=args["include_sine"], include_exp=args["include_exp"],
                             threshold=args["threshold"])
    init_dst = _make_param_fns(cfg_dst, None)[0]
    idx, theta0, theta0_dst = [], [], []
    for s in seeds:
        kperm, kfit, kdst = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), s), 3)
        idx.append(np.asarray(jax.random.permutation(kperm, n)[:k]))
        theta0.append(_flat_params(init(kfit)))
        theta0_dst.append(np.asarray(init_dst(kdst)["Xi"]))
    return np.stack(idx), np.stack(theta0), np.stack(theta0_dst)


def adam_trainer(args: dict, dtype=None):
    """The JAX CLI's Adam trainer for the parsed flags (input_dim set), its
    frozen models and generator cast to ``dtype`` (float64 under
    jax.enable_x64): cli/main.py:221-259 with the composed make_sym_reg_fn
    hook."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.cli.main import build_models, truncated_L_list
    from symmetry_ode_discovery_tpu.models import lie_generator as lg
    from symmetry_ode_discovery_tpu.models.sindy import make_config
    from symmetry_ode_discovery_tpu.training.siged import make_sym_reg_fn
    from symmetry_ode_discovery_tpu.training.siged_adam import AdamHParams, SIGEDAdamTrainer
    from symmetry_ode_discovery_tpu.utils import checkpoint as ckpt

    ae_def, spec, _ = build_models(args)
    key = jax.random.PRNGKey(args["seed"])
    k_init, key = jax.random.split(key)
    ae_params, ae_bstats = ae_def.init(k_init)
    k_g, key = jax.random.split(key)
    g_state = lg.init_generator(k_g, spec)
    if args["load_laligan"] is not None:
        bundle = {"ae": ae_params, "d": {}, "g": g_state}
        bundle, ae_bstats = ckpt.load_laligan(args["load_laligan"], bundle, ae_bstats)
        ae_params, g_state = bundle["ae"], bundle["g"]
    if dtype is not None:
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype) if jnp.issubdtype(jnp.asarray(a).dtype,
                                                               jnp.floating) else a, t)
        ae_params, ae_bstats, g_state = cast(ae_params), cast(ae_bstats), cast(g_state)
    L_list = truncated_L_list(spec, g_state, args["n_comps"]) if args["eq_constraint"] else []
    cfg, Q = make_config(
        args["latent_dim"], poly_order=args["poly_order"], include_sine=args["include_sine"],
        include_exp=args["include_exp"], L_list=L_list,
        constrain_constant=args["constrain_constant"], threshold=args["threshold"],
        dangling_const=args.get("compat_dangling_const", False))
    sym_reg_fn = latent_fns = basis_list = None
    if args["w_sym_reg"] > 0.0 and not args["use_latent"]:
        sym_reg_fn = make_sym_reg_fn(ae_def, ae_params, ae_bstats, spec, g_state,
                                     args["sym_reg_type"], args["int_t"], args["int_dt"])
    if args["use_latent"]:
        latent_fns = {
            "encode": lambda x: ae_def.encode(ae_params, ae_bstats, x, train=False)[0],
            "compute_dz": lambda x, dx: ae_def.compute_dz(ae_params, ae_bstats, x, dx),
            "compute_dx": lambda z, dz: ae_def.compute_dx(ae_params, z, dz)}
        basis_list = lg.get_full_basis_list(spec, g_state)
    ahp = AdamHParams(
        num_epochs=args["num_epochs"], batch_size=args["batch_size"], lr_sindy=args["lr_sindy"],
        w_sindy_z=args["w_sindy_z"], w_sindy_x=args["w_sindy_x"],
        w_sindy_reg=args["w_sindy_reg"], sindy_reg_type=args["sindy_reg_type"],
        w_sym_reg=args["w_sym_reg"], st_freq=args["st_freq"], threshold=args["threshold"],
        use_latent=args["use_latent"])
    Qj = None if Q is None else jnp.asarray(Q, dtype or jnp.float32)
    return SIGEDAdamTrainer(cfg, Qj, ahp, sym_reg_fn=sym_reg_fn, latent_fns=latent_fns,
                            basis_list=basis_list)


def adam_epoch_fed(trainer):
    """trainer.epoch with the epoch's batches fed: (params, mask, opt_state,
    x, dx, perm (n_batches * bs,)) -> (params, opt_state, mean metrics)."""
    import jax
    import optax

    @jax.jit
    def epoch(params, mask, opt_state, x, dx, perm):
        bs = min(trainer.hp.batch_size, x.shape[0])

        def step(carry, idx):
            params, opt_state = carry
            (_, metrics), grads = jax.value_and_grad(trainer.loss_fn, has_aux=True)(
                params, mask, x[idx], dx[idx])
            upd, opt_state = trainer.tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, upd), opt_state), metrics

        (params, opt_state), metrics = jax.lax.scan(step, (params, opt_state),
                                                    perm.reshape(-1, bs))
        return params, opt_state, jax.tree_util.tree_map(lambda a: a.mean(), metrics)

    return epoch


def dump_adam(config: str, out: str, seed: int, epochs: int, rows: int, extra=()) -> dict:
    """Write the Adam replay of ``config`` (module docstring) to ``out``."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.data.datasets import load_or_generate
    from symmetry_ode_discovery_tpu.utils.config import get_args

    flags = ["--config", config, "--sindy_optimizer", "adam", "--seed", str(seed)] + list(extra)
    args = vars(get_args(flags))
    x, dx = load_or_generate(args["task"], "train", args["noise"], args["smoothing"])
    x = np.asarray(x).reshape(-1, x.shape[-1])
    dx = np.asarray(dx).reshape(-1, dx.shape[-1])
    if rows:
        x, dx = x[:rows], dx[:rows]
    args["input_dim"] = int(x.shape[-1])
    n = x.shape[0]
    bs = min(args["batch_size"], n)
    tr = adam_trainer(args)
    key = jax.random.PRNGKey(seed)
    key, kinit = jax.random.split(key)
    params0, mask0, opt0 = tr.init(kinit)
    perms = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, n)[: (n // bs) * bs]))
    rec = dict(seeds=np.asarray([seed], np.int32), theta0=_flat_params(params0)[None],
               perm=np.stack(perms)[None].astype(np.int32), x=x.astype(np.float32),
               dx=dx.astype(np.float32), config=np.asarray(config),
               extra=np.asarray(list(extra), dtype=str))

    def run(trainer, params, opt_state, mask, xs, dxs, check=False):
        epoch = adam_epoch_fed(trainer)
        hist, bit_equal = [], []
        key = jax.random.split(jax.random.PRNGKey(seed))[0]
        for e in range(epochs):
            key, sub = jax.random.split(key)
            if check:
                ref = trainer.epoch(params, mask, opt_state, xs, dxs, sub)
            params, opt_state, metrics = epoch(params, mask, opt_state, xs, dxs,
                                               jnp.asarray(perms[e]))
            if check:
                bit_equal.append(all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                                     zip(jax.tree_util.tree_leaves(ref[0]),
                                         jax.tree_util.tree_leaves(params))))
            if trainer.hp.st_freq > 0 and (e + 1) % trainer.hp.st_freq == 0:
                Xi = trainer.xi_of(params)
                mask = jnp.logical_and(jnp.abs(Xi) > trainer.hp.threshold,
                                       mask > 0).astype(mask.dtype)
            hist.append((_flat_params(params).reshape(-1), np.asarray(mask),
                         {k: float(v) for k, v in metrics.items()}))
        return hist, bit_equal

    hist, bit_equal = run(tr, params0, opt0, mask0, jnp.asarray(x), jnp.asarray(dx), check=True)
    with jax.enable_x64(True):
        tr64 = adam_trainer(args, jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params0)
        hist64, _ = run(tr64, p64, tr64.tx.init(p64), jnp.asarray(mask0, jnp.float64),
                        jnp.asarray(x, jnp.float64), jnp.asarray(dx, jnp.float64))
    for tag, h in (("", hist), ("64", hist64)):
        rec[f"params{tag}"] = np.stack([np.asarray(p, np.float64) for p, _, _ in h])
        rec[f"mask{tag}"] = np.stack([m for _, m, _ in h]).astype(np.float32)
        for name in h[0][2]:
            rec[f"epoch{tag}/{name}"] = np.asarray([m[name] for _, _, m in h])
    rec["bit_equal"] = np.asarray(bit_equal)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **rec)
    print(f"{config}: adam replay, seed {seed}, {n} rows, {epochs} epochs, bit-equal "
          f"{bit_equal} -> {out}")
    return rec


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
    if args["use_latent"]:
        if perms:
            raise ValueError("--perms applies to the sweep branch only, as in the JAX CLI")
        idx, theta0, theta0_dst = latent_draws(args, cfg, Q, n, k, seeds)
        rec = dict(seeds=np.asarray(seeds, np.int32), idx=idx.astype(np.int32),
                   theta0=theta0.astype(np.float32), theta0_dst=theta0_dst.astype(np.float32),
                   branch=np.asarray("latent"))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez(out, **rec)
        print(f"{config}: latent branch, n {n}, k {k}, theta0 {theta0.shape[1:]}, "
              f"theta0_dst {theta0_dst.shape[1:]} -> {out}")
        return rec
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


def lassi_coef_draws(spec, key, batch: int) -> list:
    """Each group index's raw coefficient draw of
    lie_generator.sample_group_element on ``key`` (the batch's key), in
    spec.group_ids order: the standard normal, the uniform u or the integers
    of sample_coefficient, before sigma."""
    import jax
    import jax.numpy as jnp

    out = []
    for gi in spec.group_ids:
        key, sub = jax.random.split(key)
        i = next(j for j, b in enumerate(spec.blocks) if b.group_idx == gi)
        shape = (batch, spec.blocks[i].n_channels)
        if spec.coef_dist == "normal":
            d = jax.random.normal(sub, shape)
        elif spec.coef_dist == "uniform":
            d = jax.random.uniform(sub, shape)
        elif spec.coef_dist == "uniform_int_grid":
            return None  # the bound reads sigma; use lassi_coef_draws_from_state
        else:
            raise ValueError(f"Unknown coef_dist: {spec.coef_dist}")
        out.append(np.asarray(d))
    return out


def lassi_coef_draws_from_state(spec, g_state, key, batch: int) -> list:
    """lassi_coef_draws, the integer grid's bound floor(|sigma[0, 0]|) read
    from ``g_state``."""
    import jax

    if spec.coef_dist != "uniform_int_grid":
        return lassi_coef_draws(spec, key, batch)
    out = []
    for gi in spec.group_ids:
        key, sub = jax.random.split(key)
        i = next(j for j, b in enumerate(spec.blocks) if b.group_idx == gi)
        bound = int(np.floor(abs(float(np.asarray(g_state.sigma[i]).reshape(-1)[0]))))
        out.append(np.asarray(jax.random.randint(sub, (batch, spec.blocks[i].n_channels),
                                                 -bound, bound)))
    return out


def lassi_epoch_draws(trainer, g_state, key, n: int) -> tuple:
    """(perm (B, bs), coef (B, G, bs, ch)) of one trainer.epoch on ``key``
    over n windows, as _epoch_impl and sample_group_element split it."""
    import jax

    bs = min(trainer.hp.batch_size, n)
    nb = n // bs
    kperm, kscan = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(kperm, n))[: nb * bs].reshape(nb, bs)
    coef = []
    for _ in range(nb):
        kscan, sub = jax.random.split(kscan)
        coef.append(np.stack(lassi_coef_draws_from_state(trainer.spec, g_state, sub, bs)))
    return perm, np.stack(coef)


class fed_coefficients:
    """Inside the block, the JAX package's sample_coefficient returns the
    draws of ``draws[0]`` (a list, one array per group index, set by the
    caller before each trace) in place of its PRNG's, with its own
    arithmetic on them (sigma, the one-hot channel)."""

    def __init__(self, draws: list):
        self.draws = draws

    def __enter__(self):
        import jax.numpy as jnp

        from symmetry_ode_discovery_tpu.models import lie_generator as jlg

        self.mod, self.orig = jlg, jlg.sample_coefficient
        calls = []

        def fed(spec, key, batch_size, n_channels, sigma, activated_channel=None):
            d = self.draws[0][len(calls) % len(self.draws[0])]
            calls.append(1)
            if spec.coef_dist == "normal":
                z = d @ sigma
            elif spec.coef_dist == "uniform":
                z = d * 2 * sigma - sigma
            else:
                z = d.astype(jnp.float32)
            if activated_channel is not None:
                z = z * jnp.zeros((n_channels,)).at[activated_channel].set(1.0)[None, :]
            return z

        jlg.sample_coefficient = fed
        return self

    def __exit__(self, *exc):
        self.mod.sample_coefficient = self.orig


def lassi_replay_epoch(trainer, bundle, bstats, opt_state, x, perm, coef, sc=None, dx=None,
                       dtype=None):
    """One epoch of the JAX trainer with the draws (perm, coef) fed in place
    of its PRNG: the scan of _epoch_impl over (perm, coef), the joint SINDy
    carry ``sc`` threaded through and each batch's dx from ``dx`` (x's in
    its place when None), the last batch flagged is_last. With ``dtype``
    (float64 under jax.enable_x64) the state and inputs are cast first.
    Returns (bundle, batch_stats, opt_state, per-batch metrics, sindy
    carry)."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import optax

    draws = [None]
    nb = perm.shape[0]
    dx = x if dx is None else dx
    sc = {} if sc is None else sc
    if dtype is not None:
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
            else a, t)
        bundle, bstats, opt_state, sc, x, dx, coef = (cast(t) for t in (
            bundle, bstats, opt_state, sc, x, dx, coef))

    def body(carry, inp):
        b, bs, os_, s = carry
        i, idx, c = inp
        draws[0] = [c[g] for g in range(c.shape[0])]
        (_, (new_bs, new_s, m)), grads = jax.value_and_grad(trainer.loss_fn, has_aux=True)(
            b, bs, x[idx], dx[idx], s, jax.random.PRNGKey(0), is_last=(i == nb - 1))
        updates, os_ = trainer.tx.update(grads, os_, b)
        return (optax.apply_updates(b, updates), new_bs, os_, new_s), m

    # the JAX epoch's precision context (none on the least-squares branch)
    prec = (contextlib.nullcontext() if trainer.sindy_lstsq
            else jax.default_matmul_precision(trainer.hp.matmul_precision))
    with fed_coefficients(draws), prec:
        (bundle, bstats, opt_state, sc), metrics = jax.jit(
            lambda carry, xs: jax.lax.scan(body, carry, xs))(
                (bundle, bstats, opt_state, sc), (jnp.arange(nb), perm, coef))
    return bundle, bstats, opt_state, metrics, sc


def lassi_tree(bundle, bstats, sc=None) -> dict:
    """The trainer's state as plain nested dicts of numpy arrays (the
    generator's fields as tuples), the layout convert.lassi_from_jax reads;
    with the joint SINDy state, also "sindy" (the Adam branch's bundle
    entry) and "sindy_carry"."""
    import jax

    g = bundle["g"]
    tree = {"ae": bundle["ae"], "batch_stats": bstats, "d": bundle["d"],
            "g": {f: tuple(getattr(g, f)) for f in ("Li", "sigma", "struct_const", "masks")}}
    if "sindy" in bundle:
        tree["sindy"] = bundle["sindy"]
    if sc:
        tree["sindy_carry"] = sc
    return jax.tree_util.tree_map(np.asarray, tree)


def lassi_hparams(args: dict, epochs: int):
    """The JAX CLI's LassiHParams of the parsed flags, ``epochs`` epochs."""
    from symmetry_ode_discovery_tpu.training.lassi import LassiHParams

    return LassiHParams(
        num_epochs=epochs, batch_size=args["batch_size"], lr_ae=args["lr_ae"],
        lr_d=args["lr_d"], lr_g=args["lr_g"], w_recon=args["w_recon"], w_gan=args["w_gan"],
        w_reg_norm=args["w_reg_norm"], w_reg_sim=args["w_reg_sim"],
        w_reg_ortho=args["w_reg_ortho"], w_reg_closure=args["w_reg_closure"],
        use_original_x=args["use_original_x"], gan_st_freq=args["gan_st_freq"],
        gan_st_thres=args["gan_st_thres"], include_sindy=args["include_sindy"],
        eq_constraint=args["eq_constraint"], poly_order=args["poly_order"],
        w_sindy_z=args["w_sindy_z"], w_sindy_x=args["w_sindy_x"],
        w_sindy_reg=args["w_sindy_reg"], sindy_reg_type=args["sindy_reg_type"],
        lr_sindy=args["lr_sindy"], st_freq=args["st_freq"], threshold=args["threshold"])


def lassi_record(args: dict, xw: np.ndarray, n_batches: int = 16, epochs: int = 2,
                 flags=(), dxw: np.ndarray = None, f64: bool = False) -> dict:
    """The reduced replay (module docstring) of the JAX trainer for the
    parsed flags ``args`` on the windows ``xw`` (its first n_batches x
    batch_size, or all of them with n_batches 0) and their derivatives
    ``dxw`` (the joint SINDy terms'; recorded as ``dx``), as a dict of
    arrays; ``flags`` are recorded for the port's replay to parse with the
    config. With ``f64``, also the JAX trainer's float64 run on the same
    draws from the same init (its exact arithmetic, under
    jax.enable_x64): ``batch64/<name>``, ``epoch64/<name>`` and, with the
    joint state, its final ``mask64``."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.cli.main import build_models
    from symmetry_ode_discovery_tpu.training.lassi import LassiTrainer
    from symmetry_ode_discovery_tpu_torch.utils.checkpoint import flatten

    n = n_batches * args["batch_size"] if n_batches else len(xw)
    x = jnp.asarray(np.asarray(xw)[:n])
    dx = x if dxw is None else jnp.asarray(np.asarray(dxw)[:n])
    ae_def, spec, disc = build_models(args)
    hp = lassi_hparams(args, epochs)
    trainer = LassiTrainer(ae_def, spec, disc, hp,
                           steps_per_epoch=n // min(args["batch_size"], n))
    key = jax.random.PRNGKey(args["seed"])
    key, kinit = jax.random.split(key)  # train_lassi's chain (no eval split: x_val None)
    bundle, bstats, opt_state, sc = trainer.init(kinit, x)
    rec = {"x": np.asarray(x, np.float32), "seed": np.asarray(args["seed"]),
           "config": np.asarray(args["config"]), "flags": np.asarray(list(flags), dtype=str)}
    if dxw is not None:
        rec["dx"] = np.asarray(dx, np.float32)
    rec.update({f"init/{k}": v for k, v in flatten(lassi_tree(bundle, bstats, sc)).items()})
    perms, coefs, bit_equal, batch_m, batch64 = [], [], [], [], []
    st64 = (bundle, bstats, opt_state, sc)
    for e in range(epochs):
        key, sub = jax.random.split(key)
        perm, coef = lassi_epoch_draws(trainer, bundle["g"], sub, n)
        ref = trainer.epoch(bundle, bstats, opt_state, sc, x, dx, sub)
        rep = lassi_replay_epoch(trainer, bundle, bstats, opt_state, x, jnp.asarray(perm),
                                 jnp.asarray(coef), sc, dx)
        same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(ref[:4]),
            jax.tree_util.tree_leaves(rep[:3] + (rep[4],))))
        bit_equal.append(bool(same))
        print(f"epoch {e}: replay with the fed draws bit-equal to trainer.epoch: {same}",
              flush=True)
        bundle, bstats, opt_state, sc = _lassi_after_epoch(trainer, e, *ref[:4])
        if f64:
            with jax.enable_x64(True):
                b, bs, o, m64, s = lassi_replay_epoch(
                    trainer, *st64[:3], x, jnp.asarray(perm), jnp.asarray(coef), st64[3], dx,
                    dtype=jnp.float64)
                st64 = _lassi_after_epoch(trainer, e, b, bs, o, s)
                batch64.append({k: np.asarray(v, np.float64) for k, v in m64.items()})
        perms.append(perm.astype(np.int32))
        coefs.append(coef.astype(np.float32))
        batch_m.append({k: np.asarray(v) for k, v in rep[3].items()})
        for k, v in ref[4].items():
            rec.setdefault(f"epoch/{k}", []).append(float(v))
    rec.update(perm=np.stack(perms), coef=np.stack(coefs), bit_equal=np.asarray(bit_equal))
    for k in batch_m[0]:
        rec[f"batch/{k}"] = np.stack([m[k] for m in batch_m]).astype(np.float64)
        rec[f"epoch/{k}"] = np.asarray(rec[f"epoch/{k}"])
    rec.update({f"final/{k}": v for k, v in flatten(lassi_tree(bundle, bstats, sc)).items()})
    for k in (batch64[0] if batch64 else ()):
        rec[f"batch64/{k}"] = np.stack([m[k] for m in batch64])
        rec[f"epoch64/{k}"] = rec[f"batch64/{k}"].mean(axis=1)
    if batch64 and "mask" in st64[3]:
        rec["mask64"] = np.asarray(st64[3]["mask"], np.float32)
    return rec


def _lassi_after_epoch(trainer, e: int, bundle, bstats, opt_state, sc):
    """train_lassi's work between epochs: the generator's thresholding every
    gan_st_freq epochs and the Adam branch's Xi thresholding every st_freq."""
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.models import lie_generator as jlg

    hp = trainer.hp
    if hp.gan_st_freq > 0 and (e + 1) % hp.gan_st_freq == 0:
        bundle = dict(bundle, g=jlg.set_threshold(trainer.spec, bundle["g"], hp.gan_st_thres))
    if trainer.sindy_adam and hp.st_freq > 0 and (e + 1) % hp.st_freq == 0:
        sc = dict(sc, mask=jnp.logical_and(jnp.abs(bundle["sindy"]["Xi"]) > hp.threshold,
                                           sc["mask"] > 0).astype(sc["mask"].dtype))
    return bundle, bstats, opt_state, sc


def dump_lassi(config: str, out: str, n_batches: int = 16, epochs: int = 2,
               extra=()) -> dict:
    """Write the reduced replay of ``config``'s LaLiGAN training (module
    docstring) on the JAX package's train windows to ``out``."""
    from symmetry_ode_discovery_tpu.data.datasets import get_dataset
    from symmetry_ode_discovery_tpu.utils.config import get_args

    args = vars(get_args(["--config", config] + list(extra)))
    train_ds, _, args = get_dataset(args)
    xw, dxw = (np.asarray(a) for a in train_ds.materialize())
    rec = lassi_record(args, xw, n_batches, epochs, extra,
                       dxw if args["include_sindy"] else None, f64=args["include_sindy"])
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **rec)
    print(f"{config}: lassi replay, {rec['x'].shape[0]} windows, {epochs} epochs, bit-equal "
          f"{rec['bit_equal'].tolist()} -> {out}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="a run_configs/ path, e.g. lv/noise99_sym.cfg")
    ap.add_argument("--seeds", default="0-49")
    ap.add_argument("--perms", default=None,
                    help="a ref-*-perms.npz whose idx the sweep keeps (only theta0 is drawn)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--lassi", action="store_true",
                    help="a LaLiGAN config: write the reduced replay of its training")
    ap.add_argument("--lassi_batches", type=int, default=16,
                    help="windows: this many batches' (0: all of the train split)")
    ap.add_argument("--lassi_epochs", type=int, default=2)
    ap.add_argument("--adam", action="store_true",
                    help="write the Adam trainer's replay (seed: the first of --seeds)")
    ap.add_argument("--adam_epochs", type=int, default=3)
    ap.add_argument("--adam_rows", type=int, default=0,
                    help="the first this many train rows (0: all)")
    ap.add_argument("--val_cache", action="store_true",
                    help="write the config's clean validation cache only")
    a, extra = ap.parse_known_args(argv)
    if a.out is None and not a.val_cache:
        ap.error("--out is required")
    if a.val_cache:
        from symmetry_ode_discovery_tpu.data.datasets import DATA_PATH, load_or_generate
        from symmetry_ode_discovery_tpu.utils.config import get_args

        task = get_args(["--config", a.config] + list(extra)).task
        x, _ = load_or_generate(task, "val", 0.0, None)
        print(f"{task} clean val {tuple(x.shape)} in {DATA_PATH}")
    elif a.lassi:
        dump_lassi(a.config, a.out, a.lassi_batches, a.lassi_epochs, extra)
    elif a.adam:
        dump_adam(a.config, a.out, parse_seeds(a.seeds)[0], a.adam_epochs, a.adam_rows, extra)
    else:
        dump(a.config, parse_seeds(a.seeds), a.out, a.perms, extra)


if __name__ == "__main__":
    main()
