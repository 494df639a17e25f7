"""Entry point of the port for symmetry discovery and equation discovery,
driven by the same run_configs/*.cfg files as the JAX package's cli/main.py.

    python -m symmetry_ode_discovery_tpu_torch.cli.main --config lv/noise99_sym.cfg
    python -m symmetry_ode_discovery_tpu_torch.cli.main \
        --config lv/noise99_eq_isymreg.cfg --symmpen_pallas --ae_dtype f32 --n_seeds 50

Symmetry discovery (--mt_data, an mt_<system> task or mt_rd): LaLiGAN
training (training/lassi.py) on the system's two-step windows (mt_rd: the
reaction-diffusion snapshots, data/rd_solver.py), the per-epoch loss
components, the held-out line and Li printed as the JAX CLI prints them, the
metrics under <save_root>/runs/<wandb_name>, snapshots every
--save_interval epochs and the artifacts (autoencoder.npz, discriminator.npz,
generator.npz, generator_mask.npz, the JAX package's layout, and with
--include_sindy the joint regression's regressor.npz: Xi and mask) under
<save_root>/<save_dir>; --save_root defaults to $SODT_TORCH_SAVE_PATH, else
~/.cache/symmetry_ode_discovery_tpu_torch/saved_models. Pass that directory
(an absolute path) as --load_laligan to run equation discovery on it.

Equation-discovery branches (each the JAX CLI's):
- plain and constrained sweeps (--n_seeds > 1, no symmetry penalty, a
  ground truth for the task): one launch of the fused L-BFGS kernel over all
  seeds (training.sweep.sweep_sindy_lbfgs);
- EquivSINDy-r (--w_sym_reg > 0, a frozen LaLiGAN from --load_laligan):
  host-stepped L-BFGS epochs over chunks of --seed_chunk seeds (the tail
  chunk padded with its last seed), stopping early once every lane is done,
  one eval npz per seed written as each chunk ends, and seeds that already
  have an npz skipped unless --overwrite_eval. The penalty: sym_reg_type i
  on the fused rollout (its autoencoder in --ae_dtype f32 or bf16, through
  the K2/K3 kernels with --symmpen_pallas), on the closure form with
  --no_fused_rollout (also the fall-back, with a warning, for a basis that
  is not block-diagonal), the composed symmreg_i with --symmreg_slow;
  --sym_reg_type f or r the composed finite or reversed penalty;
- a sweep without a ground truth and a single seed without --n_seeds go
  through the same host-stepped fit (a sweep without a ground truth writes
  no eval npz, as the JAX CLI's);
- --use_latent: the L-BFGS fit in the frozen autoencoder's latent space
  (z = encode(x), dz = J_enc dx; loss w_sindy_z mse(dz) + w_sindy_x
  mse(J_dec dz_pred, dx)), chunks of --seed_chunk seeds; --distill_latent
  re-fits an unconstrained data-space regressor to the derivatives the
  latent equation gives (distill without --use_latent is a ValueError);
- --sindy_optimizer adam: the Adam trainer (training/siged_adam.py) on all
  training rows, seeds in sequence, the composed penalty of
  training.siged.make_sym_reg_fn in place of the fast one; each seed's
  regressor.npz (Xi, mask) under --save_root/<save_dir>, as the JAX CLI
  writes it under saved_models/.

Each seed s draws its subsample with torch.Generator(device).manual_seed(2s)
and its initial parameters with manual_seed(2s + 1) (training/sweep.py;
the distillation's with 2^32 + s; the Adam
trainer its epoch permutations from 2s), so per-seed draws differ from the
JAX package's. --subsample_perms replaces them on every branch with a file
of draws keyed by seed (``seeds``, ``idx`` and optionally ``theta0``, in the
JAX package's layout: Xi (d, p), or [beta, const] under a constraint; the
latent branch also ``theta0_dst``, the distillation's Xi; the Adam branch
``theta0`` and optionally ``perm`` (seeds, epochs, rows), no ``idx``): the
tracked eval_results/ref-*-perms.npz hold subsample rows only,
tools/dump_jax_draws.py writes the JAX CLI's own draws with theta0. Eval
npz files go under --eval_root (default eval_results/).

Several devices (parallel/): --mesh_devices N > 1 shards the seed axis of
the sweep (one K1 launch a device) and of the EquivSINDy-r stepper (each
chunk rounded up to a multiple of N, the tail padded with its last seed)
over the first N CUDA devices; --dp_devices N > 1 trains LaLiGAN data
parallel, one process a device (parallel/dp.py; rank 0 logs and writes the
artifacts). Both raise ValueError when fewer CUDA devices exist; each
seed's, and each batch's, draws do not depend on either.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..utils import watchdog


def build_models(args: dict):
    """(AutoEncoder, GeneratorSpec) from the flags (build_discriminator
    adds LaLiGAN training's third model)."""
    from ..models import lie_generator as lg
    from ..models.autoencoder import AutoEncoder, AutoEncoderConfig

    ae = AutoEncoder(AutoEncoderConfig(
        ae_arch=args["ae_arch"], input_dim=args["input_dim"], hidden_dim=args["hidden_dim"],
        latent_dim=args["latent_dim"], n_layers=args["n_layers"], n_comps=args["n_comps"],
        activation=args["activation"], activation_args=tuple(args["activation_args"]),
        batch_norm=args["batch_norm"], ortho_ae=args["ortho_ae"]))
    spec = lg.parse_repr(
        args["repr"], args["group_idx"], coef_dist=args["coef_dist"],
        uniform_max=args["uniform_max"], sigma_init=args["sigma_init"],
        keep_center=args["keep_center"], int_param=args["int_param"],
        int_param_max=args["int_param_max"], int_param_noise=args["int_param_noise"],
        gan_st_thres=args["gan_st_thres"])
    return ae, spec


def build_discriminator(args: dict):
    """The discriminator from the flags: the autoencoder's width, depth and
    activation, on the flattened latent of all components (and the
    flattened x with --use_original_x)."""
    from ..models.discriminator import Discriminator

    return Discriminator(
        z_dim=args["n_comps"] * args["latent_dim"], hidden_dim=args["hidden_dim"],
        n_layers=args["n_layers"], activation=args["activation"],
        activation_args=tuple(args["activation_args"]), embed_y=args["embed_y"],
        y_classes=args["y_classes"], y_embed_dim=args["y_embed_dim"],
        x_dim=args["n_comps"] * args["input_dim"] if args["use_original_x"] else 0)


def build_trainer(args: dict, device=None, steps_per_epoch: int = None, dp=None):
    """LaLiGAN's trainer (training.lassi.LassiTrainer) from the flags: the
    autoencoder, generator spec and discriminator of build_models and
    build_discriminator, the hyper-parameters of the JAX CLI's
    LassiHParams, the joint SINDy ones included; args["input_dim"] must be
    set. ``steps_per_epoch`` (batches an epoch) times the joint Adam
    branch's learning-rate schedule; ``dp``: a rank of a data-parallel
    run."""
    from ..training.lassi import LassiHParams, LassiTrainer

    ae, spec = build_models(args)
    hp = LassiHParams(
        num_epochs=args["num_epochs"], batch_size=args["batch_size"], lr_ae=args["lr_ae"],
        lr_d=args["lr_d"], lr_g=args["lr_g"], w_recon=args["w_recon"], w_gan=args["w_gan"],
        w_reg_norm=args["w_reg_norm"], w_reg_sim=args["w_reg_sim"],
        w_reg_ortho=args["w_reg_ortho"], w_reg_closure=args["w_reg_closure"],
        use_original_x=args["use_original_x"], ae_ema=args.get("ae_ema", 0.0),
        gan_st_freq=args["gan_st_freq"], gan_st_thres=args["gan_st_thres"],
        include_sindy=args["include_sindy"], eq_constraint=args["eq_constraint"],
        poly_order=args["poly_order"], w_sindy_z=args["w_sindy_z"],
        w_sindy_x=args["w_sindy_x"], w_sindy_reg=args["w_sindy_reg"],
        sindy_reg_type=args["sindy_reg_type"], lr_sindy=args["lr_sindy"],
        st_freq=args["st_freq"], threshold=args["threshold"])
    return LassiTrainer(ae, spec, build_discriminator(args), hp, device=device,
                        steps_per_epoch=steps_per_epoch, dp=dp)


def truncated_L_list(spec, g_state, n_comps: int):
    """The equivariance constraint's generators: each full basis element cut
    to its per-component block."""
    from ..models import lie_generator as lg

    L_list = lg.get_full_basis_list(spec, g_state)
    repr_dim = int(L_list[0].shape[-1]) // n_comps
    return [L[:repr_dim, :repr_dim].detach().cpu().numpy() for L in L_list]


def _is_lassi(args: dict) -> bool:
    return bool(args.get("mt_data")) or args["task"].startswith("mt_")


def _check_flags(args: dict):
    if _is_lassi(args):
        return
    if args["distill_latent"] and not args["use_latent"]:
        raise ValueError("Cannot distill without first learning latent space "
                         "equation (--use_latent)")
    needs_ae = (args["w_sym_reg"] > 0.0 and not args["use_latent"]) or (
        args["use_latent"] and args["ae_arch"] != "none")
    if needs_ae and args["load_laligan"] is None:
        raise ValueError("the symmetry penalty and the latent space need a frozen LaLiGAN "
                         "(--load_laligan)")


def build_fit(args: dict, train_data=None, device=None, ckpt_root: str = "saved_models"):
    """Everything a fit needs from the flags: a dict with the training data
    (x, dx: (N, dim) on ``device``), the SINDy config and Q, the L-BFGS
    hyper-parameters, the frozen autoencoder, generator spec and state, and
    the symmetry penalty (sym_reg_fn, sym_reg_prep; None without
    --w_sym_reg or with --use_latent). ``train_data`` replaces the cached or
    generated training split; the LaLiGAN checkpoint is read from
    ``ckpt_root``/<load_laligan>. Sets args["input_dim"]."""
    from ..convert import laligan_from_npz
    from ..data.datasets import get_dataset
    from ..models import lie_generator as lg
    from ..models.sindy import make_config
    from ..training.siged import LBFGSHParams

    _check_flags(args)
    device = resolve_device(device)
    if train_data is None:
        train_ds, args = get_dataset(args, device)
        x_all, dx_all = train_ds.x, train_ds.dx
    else:
        x_all, dx_all = (torch.as_tensor(a, dtype=torch.float32, device=device)
                         for a in train_data)
        args["input_dim"] = x_all.shape[-1]

    ae, spec = build_models(args)
    if args["load_laligan"] is not None:
        sd, g_state = laligan_from_npz(os.path.join(ckpt_root, args["load_laligan"]), device)
        if args["ae_arch"] != "none":
            ae.load_state_dict(sd)
    else:
        g_state = lg.init_generator(spec, torch.Generator().manual_seed(args["seed"]), device)
    ae = ae.to(device).eval().requires_grad_(False)

    L_list = truncated_L_list(spec, g_state, args["n_comps"]) if args["eq_constraint"] else []
    cfg, Q = make_config(
        args["latent_dim"], poly_order=args["poly_order"], include_sine=args["include_sine"],
        include_exp=args["include_exp"], L_list=L_list,
        constrain_constant=args["constrain_constant"], threshold=args["threshold"],
        dangling_const=args.get("compat_dangling_const", False))
    hp = LBFGSHParams(
        num_epochs=args["num_epochs"], lr_sindy=args["lr_sindy"], w_sindy_x=args["w_sindy_x"],
        w_sindy_reg=args["w_sindy_reg"], sindy_reg_type=args["sindy_reg_type"],
        w_sym_reg=args["w_sym_reg"], st_freq=args["st_freq"], threshold=args["threshold"],
        dir_backend=args.get("lbfgs_dir_backend", "xla"))
    sym_reg_fn, sym_reg_prep = build_penalty(args, cfg, ae, spec, g_state)
    return dict(x=x_all, dx=dx_all, cfg=cfg, Q=Q, hp=hp, sym_reg_fn=sym_reg_fn,
                sym_reg_prep=sym_reg_prep, device=device, ae=ae, spec=spec, g_state=g_state)


def build_penalty(args: dict, cfg, ae, spec, g_state):
    """(sym_reg_fn, sym_reg_prep) of the flags for the frozen ``ae`` and
    generator state, on their device; (None, None) without --w_sym_reg or
    with --use_latent."""
    if not (args["w_sym_reg"] > 0.0 and not args["use_latent"]):
        return None, None
    from ..training.siged import make_sym_reg_fn

    if args["sym_reg_type"] == "i" and not args.get("symreg_slow"):
        from ..training.symmreg import make_symmreg_i_fast

        kw = dict(ae_dtype={"f32": torch.float32,
                            "bf16": torch.bfloat16}[args.get("ae_dtype", "f32")],
                  pallas=bool(args.get("symmpen_pallas")))
        fused_lib = None if args.get("no_fused_rollout") else cfg.library
        try:
            prep, fn = make_symmreg_i_fast(ae, spec, g_state, args["int_t"], args["int_dt"],
                                           fused_rollout_lib=fused_lib, **kw)
        except ValueError:
            if fused_lib is None:
                raise
            print("warning: basis not block-diagonal; fused rollout off")
            prep, fn = make_symmreg_i_fast(ae, spec, g_state, args["int_t"], args["int_dt"],
                                           **kw)
        return fn, prep
    if args.get("symmpen_pallas"):
        print("warning: --symmpen_pallas only applies to the "
              "sym_reg_type=i fast path; ignored here")
    return make_sym_reg_fn(ae, spec, g_state, args["sym_reg_type"], args["int_t"],
                           args["int_dt"]), None


def penalty_on(args: dict, fit: dict, device):
    """``build_penalty`` for a ``build_fit`` result on ``device``: the fit's
    own on its device, else on copies of its autoencoder and generator state
    moved there."""
    import copy

    from ..models import lie_generator as lg
    from ..parallel.mesh import indexed

    device = indexed(device)
    if device == indexed(fit["device"]):
        return fit["sym_reg_fn"], fit["sym_reg_prep"]
    g = fit["g_state"]
    g_state = lg.GeneratorState(*(tuple(t.to(device) for t in field)
                                  for field in (g.Li, g.sigma, g.struct_const, g.masks)))
    return build_penalty(args, fit["cfg"], copy.deepcopy(fit["ae"]).to(device), fit["spec"],
                         g_state)


def run(args: dict, train_data=None, device=None, ckpt_root: str = "saved_models",
        epoch_hook=None, mesh=None) -> dict:
    """Run symmetry discovery (run_lassi, with ``epoch_hook``) or equation
    discovery for the parsed flags ``args`` (a dict, as from
    ``vars(get_args(argv))``); ``train_data``, ``device`` and ``ckpt_root``
    as for ``build_fit``. Equation discovery returns Xi, mask, per-seed stop
    epochs and the epochs each chunk ran (the single-seed run returns its
    evaluation dict with those keys added). ``mesh`` (parallel/mesh.Mesh,
    its devices may repeat) shards the sweep and the stepped chunks in place
    of --mesh_devices."""
    from ..evaluation.eval_eq import eval_sindy_coefficients, save_eval_results, sindy_truth
    from ..models.sindy import make_config

    if _is_lassi(args):
        return run_lassi(args, train_data, device, epoch_hook=epoch_hook)
    t_start = time.perf_counter()
    fit = build_fit(args, train_data, device, ckpt_root)
    if args["sindy_optimizer"] != "lbfgs":
        return run_adam(args, fit)
    if args["use_latent"]:
        return run_latent(args, fit, t_start)
    x_all, dx_all, cfg, Q, hp = fit["x"], fit["dx"], fit["cfg"], fit["Q"], fit["hp"]
    sym_reg_fn, sym_reg_prep, device = fit["sym_reg_fn"], fit["sym_reg_prep"], fit["device"]
    seed, n_seeds = args["seed"], args.get("n_seeds", 1)

    truth = sindy_truth.get(args["task"])
    eval_root = args.get("eval_root", "eval_results")
    save_dir = args["save_dir"]
    n = x_all.shape[0]
    k_batch = int(n * args["lbfgs_subsample"])
    seeds = list(range(seed, seed + n_seeds))

    if n_seeds > 1 and sym_reg_fn is None and truth is not None:
        from ..training.sweep import sweep_sindy_lbfgs

        sub_idx = theta0 = None
        if args.get("subsample_perms"):
            sub_idx, theta0 = load_draws(args["subsample_perms"], seeds)
        res = sweep_sindy_lbfgs(cfg, Q, x_all, dx_all, truth, hp, seeds,
                                lbfgs_subsample=args["lbfgs_subsample"],
                                subsample_idx=sub_idx, theta0=theta0, device=device,
                                n_mesh_devices=args.get("mesh_devices", 0), mesh=mesh)
        for r, s in zip(res.results_list(), seeds):
            save_eval_results(r, save_dir, s, eval_root)
        print(f"Swept {n_seeds} seeds in {time.perf_counter() - t_start:.1f} s "
              f"-> {eval_root}/{save_dir}")
        return {"Xi": res.Xi, "mask": res.mask}

    out = _run_stepped(args, cfg, Q, hp, sym_reg_fn, sym_reg_prep, x_all, dx_all, k_batch,
                       seeds, truth, eval_root, device, resume=n_seeds > 1,
                       penalty_for=lambda dev: penalty_on(args, fit, dev), mesh=mesh)
    if n_seeds > 1:
        print(f"Swept {n_seeds} seeds in {time.perf_counter() - t_start:.1f} s "
              f"-> {eval_root}/{save_dir}")
        return out
    Xi, mask = out["Xi"][0], out["mask"][0]
    if args["print_eq"]:
        from ..models.sindy import SINDyState, equation_strings

        dst_cfg, _ = make_config(cfg.latent_dim, poly_order=args["poly_order"],
                                 include_sine=cfg.include_sine and not cfg.constraint,
                                 include_exp=cfg.include_exp and not cfg.constraint)
        st = SINDyState(Xi=torch.as_tensor(Xi), mask=torch.as_tensor(mask),
                        beta=torch.zeros(0), const=torch.zeros((Xi.shape[0], 1)),
                        Q=torch.zeros((1, 0)))
        for eq in equation_strings(dst_cfg, st):
            print(eq)
    if truth is None:
        return out
    results = eval_sindy_coefficients(Xi, mask, truth)
    print(f"Correct form: {results['correct_form']}")
    print(f"MSE: {np.where(results['correct_form'], results['mse'], 0.0)}")
    print(f"MSE (any): {results['mse']}")
    save_eval_results(results, save_dir, seed, eval_root)
    return dict(results, **out)


def run_lassi(args: dict, train_data=None, device=None, val_data=None,
              epoch_hook=None, dtype: torch.dtype = torch.float32, batch_hook=None) -> dict:
    """LaLiGAN training for the parsed flags: the task's train and val
    windows (and their derivatives) from the cache (or generated; mt_rd
    from reaction_diffusion.mat), or, given ``train_data`` (and
    ``val_data``), (x, dx) trajectories (n_ics, n_steps, dim) windowed in
    memory. Writes the artifacts, and with --include_sindy regressor.npz
    (Xi: the Adam branch's parameter or the least-squares branch's last
    solution; mask). Returns the metric history, the trainer and the
    artifacts' directory; ``epoch_hook(epoch, seconds)`` and
    ``batch_hook(epoch, per_batch)`` as for train_lassi. With --dp_devices
    N > 1: ``run_lassi_dp`` on the first N CUDA devices (ValueError when
    fewer exist), which returns the trainer's state in its place. ``dtype``
    float64 trains the same init and draws without float32's rounding (the
    data and the state widened)."""
    n_dp = args.get("dp_devices") or 0
    if n_dp > 1:
        from ..parallel.mesh import make_mesh

        return run_lassi_dp(args, make_mesh(n_dp, axis="batch").devices, train_data=train_data,
                            val_data=val_data, dtype=dtype)
    return _run_lassi(args, train_data, device, val_data, epoch_hook, dtype=dtype,
                      batch_hook=batch_hook)


def run_lassi_dp(args: dict, devices, backend: str = None, train_data=None,
                 val_data=None, dtype: torch.dtype = torch.float32) -> dict:
    """Data-parallel LaLiGAN training (training/lassi.py, parallel/dp.py):
    one process a device of ``devices`` (a device may repeat; then the
    backend is gloo, else nccl unless ``backend`` says), each rank a slice
    of every batch, rank 0 logging and writing the artifacts as
    ``run_lassi`` does. ``train_data``, ``val_data`` and ``dtype`` as for
    run_lassi.
    Returns rank 0's history, its autoencoder's state and joint SINDy state
    (numpy), the artifacts' directory, the epochs' walls, each epoch's
    per-batch metrics (``batches``) and the all-reduces it made."""
    from ..parallel.dp import launch

    as_np = lambda d: None if d is None else tuple(
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in d)
    return launch(_lassi_rank, devices, backend,
                  (dict(args), as_np(train_data), as_np(val_data), dtype))


def _lassi_rank(dp, device, args, train_data, val_data, dtype) -> dict:
    walls, batches = [], []

    def epoch_hook(epoch, seconds):
        walls.append(seconds)
        dp.report_progress()  # the launching process's heartbeat

    out = _run_lassi(args, train_data, device, val_data, epoch_hook=epoch_hook, dp=dp,
                     dtype=dtype, batch_hook=lambda epoch, per_batch: batches.append(per_batch))
    state = out.pop("trainer").state()
    return dict(out, state={"ae": state["ae"], "sindy": state.get("sindy")}, walls=walls,
                batches=batches, all_reduces=dp.all_reduces)


def _run_lassi(args: dict, train_data, device, val_data, epoch_hook=None, dp=None,
               dtype: torch.dtype = torch.float32, batch_hook=None) -> dict:
    from ..data.datasets import MTODEDataset, get_dataset
    from ..training.lassi import train_lassi
    from ..utils import checkpoint as ckpt
    from ..utils.metrics import MetricsLogger
    from .main_sindy import save_root

    _check_flags(args)
    device = resolve_device(device)
    lead = dp is None or dp.rank == 0
    if not lead:
        dp.barrier()  # rank 0 fills the data cache first
    if train_data is None:
        train_ds, val_ds, args = get_dataset(args, device, with_val=True)
        (x_train, dx_train), (x_val, dx_val) = train_ds.materialize(), val_ds.materialize()
    else:
        interval = 50 if args["task"] == "mt_selkov" else 10
        window = lambda d: MTODEDataset(*(torch.as_tensor(a, dtype=torch.float32, device=device)
                                          for a in d), interval=interval).materialize()
        x_train, dx_train = window(train_data)
        x_val, dx_val = (None, None) if val_data is None else window(val_data)
        args["input_dim"] = x_train.shape[-1]
        args["mt_data"] = True
    watchdog.beat()  # the training split is on the device
    if dp is not None and lead:
        dp.barrier()
    trainer = build_trainer(args, device,
                            steps_per_epoch=max(1, x_train.shape[0] // args["batch_size"]),
                            dp=dp)
    if dtype != torch.float32:
        trainer.init(args["seed"], dtype)
        x_train, dx_train, x_val, dx_val = (None if t is None else t.to(dtype)
                                            for t in (x_train, dx_train, x_val, dx_val))
    root = save_root(args)
    logger = (MetricsLogger(args["wandb_name"], config=args, root=os.path.join(root, "runs"))
              if lead else None)
    try:
        history = train_lassi(
            trainer, x_train, x_val, args["seed"], log_interval=args["log_interval"],
            print_li=args["print_li"], logger=logger, save_interval=args["save_interval"],
            save_dir=args["save_dir"], resume=args.get("resume", False), root=root,
            epoch_hook=epoch_hook, dx_train=dx_train, dx_val=dx_val, batch_hook=batch_hook)
    finally:
        if logger is not None:
            logger.finish()
    out_dir = None
    if lead:
        out_dir = ckpt.save_laligan(args["save_dir"], trainer, root)
        if args["include_sindy"]:
            ckpt.save_regressor(out_dir, trainer.sindy["Xi"], trainer.sindy["mask"])
        print(f"Saved LaLiGAN artifacts to {out_dir}")
    return {"history": history, "trainer": trainer, "save_dir": out_dir}


def draws_of(path: str, seeds, key: str):
    """The rows of ``seeds`` (repeats allowed) of array ``key`` in a draws
    file keyed by seed, or None when the file has no such array."""
    with np.load(path) as z:
        if key not in z.files:
            return None
        dump_seeds = [int(s) for s in z["seeds"]]
        return np.asarray(z[key])[[dump_seeds.index(s) for s in seeds]]


def build_adam_trainer(args: dict, fit: dict):
    """The Adam trainer (training.siged_adam.SIGEDAdamTrainer) for the flags
    and a ``build_fit`` result (its autoencoder and generator state as they
    are): the composed make_sym_reg_fn hook in place of any fast penalty
    (the fast penalties are the L-BFGS stepper's, on lanes with a prep
    context; the composed hook is the same loss on one batch), and on the
    latent path the frozen autoencoder's maps and the Lie basis."""
    from ..models import lie_generator as lg
    from ..training.siged import make_sym_reg_fn
    from ..training.siged_adam import AdamHParams, SIGEDAdamTrainer

    ae, spec, g_state = fit["ae"], fit["spec"], fit["g_state"]
    sym_reg_fn = None
    if fit["sym_reg_fn"] is not None:
        sym_reg_fn = make_sym_reg_fn(ae, spec, g_state, args["sym_reg_type"], args["int_t"],
                                     args["int_dt"])
    ahp = AdamHParams(
        num_epochs=args["num_epochs"], batch_size=args["batch_size"], lr_sindy=args["lr_sindy"],
        w_sindy_z=args["w_sindy_z"], w_sindy_x=args["w_sindy_x"],
        w_sindy_reg=args["w_sindy_reg"], sindy_reg_type=args["sindy_reg_type"],
        w_sym_reg=args["w_sym_reg"], st_freq=args["st_freq"], threshold=args["threshold"],
        use_latent=args["use_latent"])
    latent_fns = basis_list = None
    if args["use_latent"]:
        latent_fns = {"encode": ae.encode, "compute_dz": ae.compute_dz,
                      "compute_dx": ae.compute_dx}
        basis_list = [v.detach() for v in lg.get_full_basis_list(spec, g_state)]
    return SIGEDAdamTrainer(fit["cfg"], fit["Q"], ahp, sym_reg_fn=sym_reg_fn,
                            latent_fns=latent_fns, basis_list=basis_list)


def run_adam(args: dict, fit: dict) -> dict:
    """The Adam branch: seeds in sequence on all training rows; per seed
    regressor.npz under --save_root/<save_dir> and, with a ground truth,
    its eval npz. Returns the last seed's evaluation dict (or Xi and mask)
    with 'seconds' (each seed's wall) and 'history' (its per-epoch
    metrics)."""
    from ..evaluation.eval_eq import eval_sindy_coefficients, save_eval_results, sindy_truth
    from ..training.siged_adam import train_siged_adam
    from ..utils import checkpoint as ckpt
    from .main_sindy import save_root

    tr = build_adam_trainer(args, fit)
    truth = sindy_truth.get(args["task"])
    save_dir, eval_root = args["save_dir"], args.get("eval_root", "eval_results")
    seeds = list(range(args["seed"], args["seed"] + args.get("n_seeds", 1)))
    theta0 = perm = None
    if args.get("subsample_perms"):
        theta0 = draws_of(args["subsample_perms"], seeds, "theta0")
        perm = draws_of(args["subsample_perms"], seeds, "perm")
    out, seconds = None, []
    for i, s in enumerate(seeds):
        t0 = time.perf_counter()
        Xi, mask, history = train_siged_adam(
            tr, fit["x"], fit["dx"], s, verbose=args["print_eq"],
            log_interval=args["log_interval"],
            theta0=None if theta0 is None else theta0[i].reshape(-1),
            perms=None if perm is None else perm[i])
        Xi, mask = Xi.cpu().numpy(), mask.cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        ckpt.save_regressor(os.path.join(save_root(args), save_dir), Xi, mask)
        if truth is not None:
            out = eval_sindy_coefficients(Xi, mask, truth)
            save_eval_results(out, save_dir, s, eval_root)
            print(f"seed {s} correct form: {out['correct_form']} ({seconds[-1]:.1f} s)")
        else:
            out = {"Xi": Xi, "mask": mask}
    return dict(out, seconds=seconds, history=history)


def distill_config(args: dict):
    """The distillation's unconstrained data-space SINDy config."""
    from ..models.sindy import make_config

    return make_config(args["input_dim"], poly_order=args["poly_order"],
                       include_sine=args["include_sine"], include_exp=args["include_exp"],
                       threshold=args["threshold"])[0]


def fit_latent_chunk(args: dict, fit: dict, idx, th0, th0_dst=None, dtype=None):
    """One chunk of the --use_latent branch for a ``build_fit`` result: the
    rows ``idx`` (S, k) encoded (z, dz = J_enc dx), the latent L-BFGS fit
    from ``th0`` (S, n_params) and, with --distill_latent, the data-space
    distillation from ``th0_dst`` to the derivatives the latent equation
    gives. ``dtype`` (e.g. float64) runs it on a copy of the autoencoder and
    the rows cast to it. Returns (latent result, distilled result or
    None)."""
    import copy

    from ..training.siged import LatentCtx, distill_to_data_space, train_sindy_lbfgs

    ae, cfg, hp = fit["ae"], fit["cfg"], fit["hp"]
    x, dx = fit["x"][idx], fit["dx"][idx]
    if dtype is not None:
        ae = copy.deepcopy(ae).to(dtype)
        x, dx, th0 = x.to(dtype), dx.to(dtype), th0.to(dtype)
        th0_dst = None if th0_dst is None else th0_dst.to(dtype)
    with torch.no_grad():
        z, dz = ae.encode(x), ae.compute_dz(x, dx)
    res = train_sindy_lbfgs(
        cfg, fit["Q"], z, dz, hp, th0,
        latent=LatentCtx(decode_jvp=ae.compute_dx, w_sindy_z=args["w_sindy_z"]), dx_data=dx,
        epochs_per_call=max(1, min(args.get("epochs_per_call", 10), hp.num_epochs)))
    if not args["distill_latent"]:
        return res, None
    with torch.no_grad():
        dx_synth = ae.compute_dx(z, cfg.library(z) @ (res.Xi * res.mask).mT)
    return res, distill_to_data_space(distill_config(args), x, dx_synth, hp, th0_dst)


def run_latent(args: dict, fit: dict, t_start: float) -> dict:
    """The --use_latent branch: ``fit_latent_chunk`` per chunk of
    --seed_chunk seeds; eval npz per seed with a ground truth. Returns Xi
    and mask (seeds, d, p), with --distill_latent also the latent fit's as
    latent_Xi and latent_mask (a single seed: its evaluation dict with
    them)."""
    from ..evaluation.eval_eq import eval_sindy_coefficients, save_eval_results, sindy_truth
    from ..training.siged import _make_param_fns
    from ..training.sweep import _finalize, _init_theta, _subsample_idx

    device, n = fit["device"], fit["x"].shape[0]
    seeds = list(range(args["seed"], args["seed"] + args.get("n_seeds", 1)))
    k_batch = int(n * args["lbfgs_subsample"])
    distill = args["distill_latent"]
    n_params = _make_param_fns(fit["cfg"], fit["Q"])[0]
    n_dst = _make_param_fns(distill_config(args), None)[0]
    chunk = max(1, min(len(seeds), args.get("seed_chunk", 10)))
    draws = args.get("subsample_perms")
    Xis, masks, lat = [], [], []
    for lo in range(0, len(seeds), chunk):
        sub = seeds[lo:lo + chunk]
        t0 = time.perf_counter()
        if draws:
            idx = torch.as_tensor(draws_of(draws, sub, "idx"), dtype=torch.long, device=device)
            th0 = torch.as_tensor(draws_of(draws, sub, "theta0").reshape(len(sub), -1),
                                  device=device)
            th0_dst = draws_of(draws, sub, "theta0_dst")
            th0_dst = None if th0_dst is None else torch.as_tensor(
                th0_dst.reshape(len(sub), -1), device=device)
        else:
            idx = _subsample_idx(sub, n, k_batch, device)
            th0 = _init_theta(sub, n_params, device)
            th0_dst = None
        if distill and th0_dst is None:
            th0_dst = torch.stack([torch.randn(
                n_dst, generator=torch.Generator(device=device).manual_seed((1 << 32) + s),
                device=device) for s in sub])
        res, dst = fit_latent_chunk(args, fit, idx, th0, th0_dst)
        if distill:
            lat.append((res.Xi.cpu().numpy(), res.mask.cpu().numpy()))
            res = dst
        Xis.append(res.Xi.cpu().numpy())
        masks.append(res.mask.cpu().numpy())
        print(f"seeds {sub[0]}-{sub[-1]}: stop epochs {res.stop_epoch.tolist()}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    Xi, mask = np.concatenate(Xis), np.concatenate(masks)
    truth = sindy_truth.get(args["task"])
    save_dir, eval_root = args["save_dir"], args.get("eval_root", "eval_results")
    out = {"Xi": Xi, "mask": mask}
    if distill:  # the latent equation the distillation started from
        out.update(latent_Xi=np.concatenate([a for a, _ in lat]),
                   latent_mask=np.concatenate([m for _, m in lat]))
    if len(seeds) > 1:
        if truth is not None:
            d, p = Xi.shape[1:]
            res = _finalize(torch.as_tensor(Xi).reshape(len(seeds), d * p),
                            torch.as_tensor(mask), None, d, p, truth)
            for r, s in zip(res.results_list(), seeds):
                save_eval_results(r, save_dir, s, eval_root)
        print(f"Swept {len(seeds)} seeds in {time.perf_counter() - t_start:.1f} s "
              f"-> {eval_root}/{save_dir}")
        return out
    if truth is None:
        return out
    results = eval_sindy_coefficients(Xi[0], mask[0], truth)
    print(f"Correct form: {results['correct_form']}")
    print(f"MSE (any): {results['mse']}")
    save_eval_results(results, save_dir, seeds[0], eval_root)
    return dict(results, **out)


def load_draws(path: str, seeds) -> tuple:
    """(idx (S, k), theta0 (S, n_params) or None) of ``seeds`` (repeats
    allowed) from a draws file keyed by seed: ``seeds``, ``idx`` and
    optionally ``theta0`` in the JAX package's layout (Xi (d, p), or [beta,
    const]), flattened row-major to the port's lanes."""
    theta0 = draws_of(path, seeds, "theta0")
    if theta0 is not None:
        theta0 = theta0.astype(np.float32).reshape(len(seeds), -1)
    return draws_of(path, seeds, "idx"), theta0


def _run_stepped(args, cfg, Q, hp, sym_reg_fn, sym_reg_prep, x_all, dx_all, k_batch, seeds,
                 truth, eval_root, device, resume: bool, penalty_for=None, mesh=None) -> dict:
    """Host-stepped fits over chunks of seeds; per-seed npz written per chunk
    when the task has a ground truth. --subsample_perms replaces the torch
    draws of idx and, where the file has it, theta0. With --mesh_devices N >
    1 (or an explicit ``mesh``) each chunk's lanes are sharded over the
    mesh, the chunk rounded up to a multiple of its size (one device is a
    mesh of one shard); ``penalty_for(device)`` gives the penalty on each of
    the mesh's devices, (sym_reg_fn, sym_reg_prep) on every one when None."""
    from ..evaluation.eval_eq import save_eval_results
    from ..parallel.mesh import Mesh, make_mesh, shard_stepper
    from ..training.siged import _make_param_fns, make_lbfgs_stepper
    from ..training.sweep import _finalize, _init_theta, _subsample_idx

    save_dir, device = args["save_dir"], torch.device(device)
    epc = max(1, min(args.get("epochs_per_call", 10), hp.num_epochs))
    n_params = _make_param_fns(cfg, Q)[0]
    d, p = cfg.latent_dim, cfg.n_terms
    n = x_all.shape[0]
    steppers, data = {}, {}
    penalty_for = penalty_for or (lambda dev: (sym_reg_fn, sym_reg_prep))

    def stepper(dev):
        if dev not in steppers:
            steppers[dev] = make_lbfgs_stepper(cfg, Q, hp, *penalty_for(dev),
                                               epochs_per_call=epc)
        return steppers[dev]

    def prep(lanes, dev):
        """(x, dx, theta0) of ``lanes`` on ``dev``: the seeds' draws."""
        if dev not in data:
            data[dev] = (x_all.to(dev), dx_all.to(dev))
        theta0 = None
        if args.get("subsample_perms"):
            idx, theta0 = load_draws(args["subsample_perms"], lanes)
            if idx.shape[1] != k_batch or (theta0 is not None and theta0.shape[1] != n_params):
                raise ValueError(f"{args['subsample_perms']}: idx {idx.shape} and theta0 "
                                 f"{None if theta0 is None else theta0.shape} do not fit "
                                 f"{k_batch} rows and {n_params} parameters a seed")
            idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
        else:
            idx = _subsample_idx(lanes, n, k_batch, dev)
        if theta0 is None:
            theta0 = _init_theta(lanes, n_params, dev)
        x, dx = data[dev]
        return x[idx], dx[idx], torch.as_tensor(theta0, device=dev)

    chunk = max(1, min(len(seeds), args.get("seed_chunk", 10)))
    if mesh is None:
        mesh_n = args.get("mesh_devices", 0) or 0
        mesh = make_mesh(mesh_n) if mesh_n > 1 else Mesh((device,))
    chunk = mesh.size * max(1, -(-chunk // mesh.size))
    prep_c, init_c, step, extract = shard_stepper(
        prep, lambda x, dx, th: stepper(x.device)[0](x, dx, th),
        lambda c, e: stepper(c["done"].device)[1](c, e),
        lambda c: stepper(c["done"].device)[2](c), mesh)

    done_xi = {}
    if resume and truth is not None and not args.get("overwrite_eval"):
        for s in seeds:
            path = os.path.join(eval_root, save_dir, f"seed{s}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    done_xi[s] = np.asarray(z["coefficients"])
        if done_xi:
            print(f"resume: skipping {len(done_xi)} already-evaluated seeds")
    todo = [s for s in seeds if s not in done_xi]
    ran, stop_epoch, epochs_run = {}, {}, []
    for lo in range(0, len(todo), chunk):
        sub = todo[lo:lo + chunk]
        keep = len(sub)
        lanes = sub + [sub[-1]] * (chunk - keep)
        t0 = time.perf_counter()
        carry = init_c(prep_c(lanes))
        epochs = 0
        for e in range(0, hp.num_epochs, epc):
            carry = step(carry, e)
            epochs = min(e + epc, hp.num_epochs)
            done_all = bool(carry["done"].all())
            watchdog.beat()  # after the blocking read: the device moved on
            if done_all:
                break
        Xi, mask = extract(carry)
        Xi, mask = Xi[:keep].detach(), mask[:keep]
        if truth is not None:
            res = _finalize(Xi.reshape(keep, d * p), mask, None, d, p, truth).results_list()
            for r, s in zip(res, sub):
                save_eval_results(r, save_dir, s, eval_root)
        stops = carry["stop_epoch"][:keep].tolist()
        for i, s in enumerate(sub):
            ran[s] = (Xi[i].cpu().numpy(), mask[i].cpu().numpy())
            stop_epoch[s] = stops[i]
        epochs_run.append(epochs)
        print(f"seeds {sub[0]}-{sub[-1]}: {epochs} epochs, stop epochs {stops}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    Xi = np.stack([done_xi[s] if s in done_xi else ran[s][0] for s in seeds])
    mask = np.stack([(done_xi[s] != 0).astype(np.float32) if s in done_xi else ran[s][1]
                     for s in seeds])
    return {"Xi": Xi, "mask": mask, "stop_epoch": [stop_epoch.get(s) for s in seeds],
            "epochs_run": epochs_run, "seeds_run": todo}


def main(argv=None):
    from ..utils import watchdog
    from ..utils.config import get_args

    args = vars(get_args(argv))
    # a stalled CUDA dispatch relaunches the command once (the sweeps resume
    # from their per-seed files, LaLiGAN training with --resume), then exits
    # 42: the first dispatch is watched, then a heartbeat for the whole run
    watchdog.probe_first_dispatch()
    if torch.cuda.is_available():
        watchdog.start_heartbeat(timeout_s=900.0, extra_argv=["--resume"])
    try:
        return run(args)
    finally:
        watchdog.stop_heartbeat()  # no watchdog outlives the run


if __name__ == "__main__":
    main()
