"""Config / flag system: argparse + .cfg file loader with CLI-overrides-config
merge semantics.

The port's own copy of symmetry_ode_discovery_tpu/utils/config.py, with the
same flags, so run_configs/*.cfg and the JAX package's command lines parse
unchanged; it adds two flags, --eval_root and --save_root. Semantics:
- .cfg files are whitespace-separated flag strings, resolved relative to
  RUN_CONFIG_DIR when the path does not exist as given;
- flags given on the command line beat config-file values (a flag counts as
  given when its value differs from the parser default);
- the namespace becomes a dict that get_dataset extends (input_dim).

Flags that name TPU machinery (--mesh_devices, --dp_devices, Pallas
backends) keep their names; the port reads --lbfgs_dir_backend and
--symmpen_pallas as the switches of its Hopper kernels.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

# $SODT_RUN_CONFIG_DIR, else the repository's run_configs/ (the same files
# the JAX package reads)
RUN_CONFIG_DIR = os.environ.get(
    "SODT_RUN_CONFIG_DIR", str(Path(__file__).resolve().parents[2] / "run_configs"))


def build_parser() -> argparse.ArgumentParser:
    """All flags of reference get_args (parser_utils.py:7-94)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", help="Path to a configuration file")
    # Dataset
    parser.add_argument("--task", type=str, default="rd")
    parser.add_argument("--mt_data", action="store_true")
    parser.add_argument("--noise", type=float, default=0.0)
    parser.add_argument("--smoothing", type=str, default=None)
    # Hyperparameters
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--num_epochs", type=int, default=1000)
    parser.add_argument("--lr_ae", type=float, default=1e-3)
    parser.add_argument("--lr_d", type=float, default=1e-3)
    parser.add_argument("--lr_g", type=float, default=1e-3)
    parser.add_argument("--lr_sindy", type=float, default=1e-3)
    parser.add_argument("--w_recon", type=float, default=1)
    parser.add_argument("--w_gan", type=float, default=1)
    parser.add_argument("--w_reg_norm", type=float, default=1e-2)
    parser.add_argument("--w_reg_sim", type=float, default=1e-2)
    parser.add_argument("--w_reg_ortho", type=float, default=0.0)
    parser.add_argument("--w_reg_closure", type=float, default=0.0)
    # AE parameter EMA decay for volatile adversarial runs (the RD GAN's
    # val-recon band, training/lassi.py LassiHParams.ae_ema); 0 = off
    parser.add_argument("--ae_ema", type=float, default=0.0)
    parser.add_argument("--w_sindy_z", type=float, default=1e-3)
    parser.add_argument("--w_sindy_x", type=float, default=1e-1)
    parser.add_argument("--sindy_reg_type", type=str, default="l1")
    parser.add_argument("--w_sindy_reg", type=float, default=1e-1)
    parser.add_argument("--sym_reg_type", type=str, default="i")
    parser.add_argument("--w_sym_reg", type=float, default=0.0)
    # General model configuration
    parser.add_argument("--latent_dim", type=int, default=2)
    parser.add_argument("--hidden_dim", type=int, default=512)
    parser.add_argument("--n_layers", type=int, default=5)
    parser.add_argument("--n_comps", type=int, default=1)
    parser.add_argument("--activation", type=str, default="ReLU")
    parser.add_argument("--activation_args", nargs="+", type=float, default=[])
    parser.add_argument("--load_laligan", type=str, default=None)
    parser.add_argument("--fix_laligan", action="store_true")
    # Autoencoder configuration
    parser.add_argument("--ae_arch", type=str, default="mlp")
    parser.add_argument("--ortho_ae", action="store_true")
    parser.add_argument("--batch_norm", action="store_true")
    # Generator configuration
    parser.add_argument("--repr", type=str, default="(1,so2)")
    parser.add_argument("--group_idx", type=str, default="0")
    parser.add_argument("--coef_dist", type=str, default="normal")
    parser.add_argument("--g_init", type=str, default="random")
    parser.add_argument("--sigma_init", type=float, default=1)
    parser.add_argument("--uniform_max", type=float, default=1)
    parser.add_argument("--int_param", action="store_true")
    parser.add_argument("--int_param_max", type=int, default=2)
    parser.add_argument("--int_param_noise", type=float, default=0.1)
    parser.add_argument("--gan_st_freq", type=int, default=5)
    parser.add_argument("--gan_st_thres", type=float, default=0.3)
    parser.add_argument("--keep_center", action="store_true")
    # Discriminator configuration
    parser.add_argument("--use_original_x", action="store_true")
    parser.add_argument("--use_invariant_y", action="store_true")
    parser.add_argument("--embed_y", action="store_true")
    parser.add_argument("--y_dim", type=int, default=1)
    parser.add_argument("--y_classes", type=int, default=2)
    parser.add_argument("--y_embed_dim", type=int, default=16)
    # SINDy configuration
    parser.add_argument("--include_sindy", action="store_true")
    parser.add_argument("--poly_order", type=int, default=2)
    parser.add_argument("--include_sine", action="store_true")
    parser.add_argument("--include_exp", action="store_true")
    parser.add_argument("--st_freq", type=int, default=100)
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument("--use_latent", action="store_true")
    parser.add_argument("--distill_latent", action="store_true")
    parser.add_argument("--eq_constraint", action="store_true")
    parser.add_argument("--constrain_constant", action="store_true")
    # bug-compat: keep the reference's dangling const Parameter under
    # --constrain_constant (feeds L1 + convergence norm; sindy.py:59)
    parser.add_argument("--compat_dangling_const", action="store_true")
    parser.add_argument("--int_t", type=float, default=0.1)
    parser.add_argument("--int_dt", type=float, default=0.01)
    parser.add_argument("--sindy_optimizer", type=str, default="adam")
    parser.add_argument("--lbfgs_subsample", type=float, default=1.0)
    # Genetic-programming configuration (reference: PySR; here: symgp engine)
    parser.add_argument("--pysr_subsample", type=float, default=1.0)
    parser.add_argument("--pysr_bs", type=int, default=1000)
    # Cap on rows used for GP fitness evaluation in sweep mode (the
    # analog of PySR's batching=True/batch_size: reference main_pysr.py:144
    # ships --pysr_bs for exactly this purpose but leaves it commented out).
    # 0 = no cap. Constant-optimization gradients use a further 512-row
    # subsample (symgp/sweep.py).
    parser.add_argument("--gp_fitness_rows", type=int, default=2500)
    # Generations per GP run (reference 'niterations', main_pysr.py:139).
    parser.add_argument("--gp_generations", type=int, default=40)
    # Dtype of the GP sweeps' full-batch fitness tape evaluations: bf16 runs
    # K5's bf16 mode (bf16 rows, constants, stack and predictions, each step
    # rounded to bf16); predictions are cast back to f32 for the loss
    # reductions and constant-optimization gradients stay f32
    # (symgp/sweep.py).
    parser.add_argument("--gp_eval_dtype", type=str, default="f32",
                        choices=["f32", "bf16"])
    # Evaluator for those fitness passes in the JAX package ('xla' or
    # 'pallas'). The port evaluates with K5 (csrc/tape_eval.cu) on the card
    # and its plain version on the CPU either way; the flag is parsed so the
    # same config files run.
    parser.add_argument("--gp_eval_backend", type=str, default="xla",
                        choices=["xla", "pallas"])
    # Evaluator for the const-opt gradient loss in the JAX package ('xla' or
    # 'pallas'). The port takes the gradient with K6 on the card and
    # autograd of the plain interpreter on the CPU either way.
    parser.add_argument("--gp_grad_backend", type=str, default="xla",
                        choices=["xla", "pallas"])
    # Which score picks the REPORTED equation in plain GP sweep mode:
    # 'penalized' = loss + parsimony*length (PySR's default
    # model_selection='best' elbow behavior — the reference's plain-mode
    # config omits the key so PySR's default applies; the symm configs set
    # 'accuracy' explicitly at main_pysr.py:137,151)
    # or 'raw' = pure loss (PySR 'accuracy'). Breeding always uses the
    # penalized fitness. Used by the selection-rule sensitivity study
    # (RESULTS.md): the dosc/growth small-damping terms die at the Pareto
    # elbow, not in the search.
    parser.add_argument("--gp_select", type=str, default="penalized",
                        choices=["penalized", "raw"])
    # Redo seeds that already have eval npz files (GP sweep resume skips
    # them by default so crashed sweeps restart where they left off).
    parser.add_argument("--overwrite_eval", action="store_true")
    parser.add_argument("--pysr_symmreg", action="store_true")
    # Run settings
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("--log_interval", type=int, default=1)
    parser.add_argument("--save_interval", type=int, default=100)
    parser.add_argument("--resume", action="store_true",
                        help="resume LaLiGAN training from the newest "
                             "train_state_ep*.npz under saved_models/<save_dir> "
                             "(periodic snapshots every save_interval epochs)")
    parser.add_argument("--print_li", action="store_true")
    parser.add_argument("--print_eq", action="store_true")
    parser.add_argument("--wandb_name", type=str, default="test")
    parser.add_argument("--save_dir", type=str, default="test")
    parser.add_argument("--seed", type=int, default=42)
    # Extensions of the JAX package (multi-seed sweeps and their engines)
    parser.add_argument("--n_seeds", type=int, default=1,
                        help="run a vmapped multi-seed sweep (seeds seed..seed+n_seeds-1)")
    parser.add_argument("--seed_chunk", type=int, default=10,
                        help="max seeds vmapped at once for memory-heavy (symreg/latent) sweeps")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="shard the seed sweep over this many devices (0 = all)")
    parser.add_argument("--dp_devices", type=int, default=0,
                        help="data-parallel LaLiGAN training: shard each batch over "
                             "this many devices (pjit batch sharding; 0/1 = off)")
    parser.add_argument("--subsample_perms", type=str, default=None,
                        help="npz of externally-supplied per-seed subsample "
                             "indices (keys: seeds, idx) — e.g. the reference "
                             "DataLoader's actual torch-RNG draws dumped by "
                             "tools/refrun_dump_subsample.py; plain/constrained "
                             "L-BFGS sweeps only")
    parser.add_argument("--symreg_slow", action="store_true",
                        help="disable the precomputed fast path for sym_reg_type=i")
    parser.add_argument("--ae_dtype", type=str, default="f32", choices=["f32", "bf16"],
                        help="compute dtype of the frozen autoencoder inside the "
                             "symreg penalty: bf16 rounds inputs, weights and "
                             "activations to bf16 and accumulates in f32 (with "
                             "--symmpen_pallas, the bf16 mode of the K2/K3 kernels)")
    parser.add_argument("--epochs_per_call", type=int, default=10,
                        help="epochs fused per device call in host-stepped sweeps")
    parser.add_argument("--rd_eval_split", type=str, default="val",
                        choices=["val", "traintail"],
                        help="cli.eval_rd_ltp rollout window: held-out val "
                             "snapshots or the last 20 train snapshots "
                             "(in-distribution control)")
    parser.add_argument("--subsample_rng", type=str, default="jax",
                        choices=["jax", "ref"],
                        help="WSINDy window draws: 'ref' reproduces the "
                             "reference's np.random stream exactly "
                             "(main_wsindy.py:27,36-37) for per-seed "
                             "cross-checks")
    parser.add_argument("--lbfgs_dir_backend", type=str, default="xla",
                        choices=["xla", "pallas"],
                        help="two-loop L-BFGS direction engine for host-"
                             "stepped (symreg/latent) fits: 'pallas' runs the "
                             "100-pair recursion as one launch of the K4 "
                             "kernel (csrc/lbfgs_dir.cu), 'xla' as its plain "
                             "PyTorch version")
    parser.add_argument("--symmpen_pallas", action="store_true",
                        help="run the frozen-AE chains of the symreg-i penalty "
                             "through the K2/K3 kernels (csrc/symmpen.cu: the "
                             "encoder, the decoder JVP and their backwards, one "
                             "launch each per closure); requires ae_arch=mlp + "
                             "ReLU")
    parser.add_argument("--no_fused_rollout", action="store_true",
                        help="disable the fused rollout+tangent scan of the "
                             "symreg-i fast path (ops/integrators.make_euler_pair) "
                             "and use the composed odeint + jvp(odeint) closure")
    # the port's own flags: where the per-seed eval npz files and the
    # regressors of main_sindy/main_wsindy go
    parser.add_argument("--eval_root", type=str, default="eval_results",
                        help="root directory of eval_results/<save_dir>/seed<N>.npz")
    parser.add_argument("--save_root", type=str, default=None,
                        help="root directory of <save_dir>/regressor.npz (default "
                             "$SODT_TORCH_SAVE_PATH, else "
                             "~/.cache/symmetry_ode_discovery_tpu_torch/saved_models)")
    return parser


def parse_config(file_path: str):
    """Whitespace-split a .cfg file (reference parser_utils.py:183-186)."""
    with open(file_path, "r") as f:
        return [item.strip() for item in f.read().split() if item.strip()]


def get_args(argv=None) -> argparse.Namespace:
    """Parse CLI args with config-file merge: explicit CLI flags beat config
    values (reference parser_utils.py:99-120)."""
    parser = build_parser()

    default_args = argparse.Namespace()
    for action in parser._actions:
        if action.dest != "help":
            setattr(default_args, action.dest, action.default)

    args, _ = parser.parse_known_args(argv)
    provided = {k: v for k, v in vars(args).items() if v != getattr(default_args, k)}

    if args.config:
        cfg_path = args.config if os.path.exists(args.config) else os.path.join(RUN_CONFIG_DIR, args.config)
        config_args = parser.parse_args(parse_config(cfg_path))
        for key, value in vars(config_args).items():
            if key not in provided:
                setattr(args, key, value)
    else:
        args = parser.parse_args(argv)
    return args
