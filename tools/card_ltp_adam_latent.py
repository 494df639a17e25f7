"""Card runs of the LTP evaluation, the Adam trainer and the latent fit,
on inputs staged under build/chip_data/ (the JAX package's clean validation
caches and selkov cache, the tracked sweeps' seed npz under eval/, the
laligan-sindy-rd-2 checkpoint under ckpt/, adam.cfg (selkov/
noise20_eq_symreg.cfg with --sindy_optimizer adam), and the draws of
tools/dump_jax_draws.py --adam and --use_latent):

    python3 tools/card_ltp_adam_latent.py [phases] [a] [b] [c_replay] [d] [c_cli] [gates] [profile] [fault12] [fault12b] [fault12c]

phases: the rd_ltp, ltp, adam and latent smoke phases (smoke_setup.py) on
the staged inputs; a: cli/eval_ltp_sweep.py on the nine tracked sweeps;
b: cli/eval_rd_ltp.py on laligan-sindy-rd-2, val and traintail, on the JAX
package's rd data and on the port's (simulated on the card); c_replay:
cli/replay_adam.py in float32 and float64; d: cli/main.py --use_latent
[--distill_latent] --lbfgs_subsample 0.005, 50 seeds on the JAX draws;
c_cli: four seeds of the Adam branch, 200 epochs, as four processes;
gates: the ltp and latent phases again; profile: cli/profile_paths.py on
the LTP rollout (LV and dosc), 20 Adam batches and a 10-seed latent chunk;
fault12: the latent fit (cli/main.py::fit_latent_chunk, no distillation)
of 8 draws on the smoke's selkov rows after 1, 10 and 200 epochs, float32
and float64, card and CPU (ROADMAP fault 12's bisect); fault12b: the same
draws' float32 fits at 200 epochs, each also from its initial parameters
moved one ulp, card and CPU (the protocol's sensitivity); fault12c: the
same draws' float32 latent fits after 1, 10 and 200 epochs on the 2x2 grid
of encoder (encode and compute_dz) on the card or the CPU crossed with the
L-BFGS (its loss, the decoder's JVP included) on the card or the CPU, each
cell against the CPU's float64 fit.
Default: all but gates, profile and the fault12 phases. Records go to
chiprun_out/card_ltp_adam_latent/records.jsonl, one JSON line each.
"""
import json, os, subprocess, sys, tempfile, time, types
sys.path.insert(0, os.getcwd())
import numpy as np
import torch

OUT = "chiprun_out/card_ltp_adam_latent"
os.makedirs(OUT, exist_ok=True)
DATA = os.path.abspath("build/chip_data")
os.environ["SODT_TORCH_DATA_PATH"] = DATA
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(smi, torch.__version__, torch.version.cuda, flush=True)
log = open(f"{OUT}/records.jsonl", "a")


def emit(rec):
    line = json.dumps(rec, default=float)
    log.write(line + "\n"); log.flush()
    print(line[:3000], flush=True)


which = sys.argv[1:] or ["phases", "a", "b", "c_replay", "d", "c_cli"]
from symmetry_ode_discovery_tpu_torch import smoke_setup as S
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

if "phases" in which:
    d = f"{DATA}/eval/sindy2-noise99-lv"
    co = np.stack([np.load(f"{d}/seed{s}.npz")["coefficients"] for s in range(50)])
    cf = np.stack([np.load(f"{d}/seed{s}.npz")["correct_form"] for s in range(50)])
    res = types.SimpleNamespace(Xi=co, mask=(co != 0).astype(np.float32), correct_form=cf)
    for name, fn in (
            ("rd_ltp", lambda: S.rd_ltp_phase(dev, {"save_dir": f"{DATA}/ckpt/laligan-sindy-rd-2"},
                                              DATA, emit)),
            ("ltp", lambda: S.ltp_phase(dev, [None] * 10 + [res], emit))):
        t = time.time(); fn(); print(name, time.time() - t, flush=True)
    os.environ["SODT_TORCH_DATA_PATH"] = DATA
    t = time.time(); x, dx = S.selkov_data(dev); torch.cuda.synchronize()
    print("selkov data", time.time() - t, flush=True)
    t = time.time(); S.adam_phase(dev, x, dx, emit); print("adam", time.time() - t, flush=True)
    t = time.time(); S.latent_phase(dev, x, dx, emit); print("latent", time.time() - t, flush=True)

if "a" in which:
    from symmetry_ode_discovery_tpu_torch.cli import eval_ltp_sweep
    RUNS = {"sindy2-noise99-lv": "lv/noise99_eq_sindy_2.cfg", "symreg2-noise99-lv": "lv/noise99_eq_isymreg.cfg",
            "wsindy-noise99-lv": "lv/noise99_eq_wsindy.cfg", "sindy-noise20-dosc": "dosc/noise20_sindy.cfg",
            "esindy-noise20-dosc": "dosc/noise20_esindy.cfg", "sindy-noise05-growth": "growth/noise05_sindy.cfg",
            "esindy-noise05-growth": "growth/noise05_esindy.cfg",
            "sindy-noise20-selkov": "selkov/noise20_eq_sindy.cfg", "symreg-noise20-selkov": "selkov/noise20_eq_symreg.cfg"}
    for run, cfg in RUNS.items():
        args = vars(get_args(["--config", cfg, "--save_dir", run, "--eval_root", f"{DATA}/eval"]))
        t = time.time()
        r = eval_ltp_sweep.run(args, device=dev)
        emit({"phase": "a", "run": run, "wall_s": time.time() - t, "rollout_s": r["seconds"],
              **{k: {kk: (vv.tolist() if hasattr(vv, "tolist") else vv) for kk, vv in v.items()}
                 for k, v in r.items() if k != "seconds"}})

if "b" in which:
    from symmetry_ode_discovery_tpu_torch.cli import eval_rd_ltp
    port_data = tempfile.mkdtemp()
    for label, path in (("jax_data", DATA), ("port_data", port_data)):
        os.environ["SODT_TORCH_DATA_PATH"] = path
        for split in ("val", "traintail"):
            args = vars(get_args(["--config", "rd/sym_eq.cfg", "--load_laligan",
                                  f"{DATA}/ckpt/laligan-sindy-rd-2", "--rd_eval_split", split,
                                  "--eval_root", f"{OUT}/rd-{label}"]))
            t = time.time()
            r = eval_rd_ltp.run(args, device=dev)
            emit({"phase": "b", "data": label, "split": split, "wall_s": time.time() - t,
                  "eval_s": r["seconds"],
                  "means": {k: float(np.mean(r[k])) for k in ("rel_rollout", "rel_latent", "rel_recon",
                                                               "pow_rollout", "pow_recon")}})
    os.environ["SODT_TORCH_DATA_PATH"] = DATA

if "c_replay" in which:
    from symmetry_ode_discovery_tpu_torch.cli.replay_adam import replay
    for f64 in (False, True):
        emit(dict(replay(f"{DATA}/adam-noise20-selkov.npz", float64=f64, device=dev), phase="c_replay"))

if "d" in which:
    from symmetry_ode_discovery_tpu_torch.cli.main import run
    for name, extra in (("latent-noise20-selkov", ["--use_latent"]),
                        ("distill-noise20-selkov", ["--use_latent", "--distill_latent"])):
        args = vars(get_args(["--config", "selkov/noise20_eq_symreg.cfg", "--lbfgs_subsample", "0.005",
                              "--n_seeds", "50", "--seed", "0", "--save_dir", name,
                              "--subsample_perms", f"{DATA}/latent-noise20-selkov.npz",
                              "--eval_root", f"{OUT}/eval"] + extra))
        torch.cuda.synchronize(); t = time.time()
        run(args, device=dev)
        torch.cuda.synchronize()
        emit({"phase": "d", "run": name, "wall_s": time.time() - t})

if "c_cli" in which:
    procs = []
    t = time.time()
    for s in range(4):
        cmd = [sys.executable, "-m", "symmetry_ode_discovery_tpu_torch.cli.main", "--config",
               f"{DATA}/adam.cfg", "--seed", str(s), "--eval_root", f"{OUT}/eval",
               "--save_root", f"{OUT}/saved", "--save_dir", "adam-noise20-selkov"]
        procs.append(subprocess.Popen(cmd, stdout=open(f"{OUT}/adam_seed{s}.log", "w"),
                                      stderr=subprocess.STDOUT))
    rcs = [p.wait() for p in procs]
    emit({"phase": "c_cli", "seeds": 4, "parallel_processes": 4, "wall_s": time.time() - t,
          "rcs": rcs})

if "gates" in which:
    d = f"{DATA}/eval/sindy2-noise99-lv"
    co = np.stack([np.load(f"{d}/seed{s}.npz")["coefficients"] for s in range(50)])
    cf = np.stack([np.load(f"{d}/seed{s}.npz")["correct_form"] for s in range(50)])
    res = types.SimpleNamespace(Xi=co, mask=(co != 0).astype(np.float32), correct_form=cf)
    t = time.time(); S.ltp_phase(dev, [None] * 10 + [res], emit); print("ltp", time.time() - t, flush=True)
    x, dx = S.selkov_data(dev)
    t = time.time(); S.latent_phase(dev, x, dx, emit); print("latent", time.time() - t, flush=True)
    del x, dx

if "profile" in which:
    from symmetry_ode_discovery_tpu_torch.cli.profile_paths import profile
    for path, argv in (
            ("ltp", ["--config", "lv/noise99_eq_sindy_2.cfg", "--eval_root", f"{DATA}/eval"]),
            ("ltp", ["--config", "dosc/noise20_sindy.cfg", "--eval_root", f"{DATA}/eval"]),
            ("adam", ["--config", f"{DATA}/adam.cfg"]),
            ("latent", ["--config", "selkov/noise20_eq_symreg.cfg", "--use_latent",
                        "--lbfgs_subsample", "0.005", "--n_seeds", "10", "--seed", "0",
                        "--subsample_perms", f"{DATA}/latent-noise20-selkov.npz"])):
        emit(profile(path, argv))
if "fault12" in which:
    import contextlib, dataclasses
    from symmetry_ode_discovery_tpu_torch.cli.main import build_fit, fit_latent_chunk
    x, dx = S.selkov_data(dev)
    args = vars(get_args(["--config", S.SELKOV_CONFIG, "--use_latent", "--seed", "0"]))
    sides = {"card": dev, "cpu": torch.device("cpu")}
    fits = {}
    for side, where in sides.items():
        a = dict(args)
        fits[side] = (a, build_fit(a, train_data=(x, dx), device=where, ckpt_root=str(S.CKPT_ROOT)))
    n = x.shape[0]
    k = int(n * S.LATENT_SUBSAMPLE)
    for draw in range(8):  # draw 0 is the smoke's latent phase's
        gen = torch.Generator().manual_seed(draw)
        idx = torch.randperm(n, generator=gen)[:k]
        th0 = torch.randn((1, 20), generator=gen)
        for epochs in (1, 10, 200):
            got, walls = {}, {}
            for side, where in sides.items():
                a, fit = fits[side]
                fit = dict(fit, hp=dataclasses.replace(fit["hp"], num_epochs=epochs))
                for tag, dt in (("f32", None), ("f64", torch.float64)):
                    t = time.time()
                    with S.cpu_threads() if side == "cpu" else contextlib.nullcontext():
                        res, _ = fit_latent_chunk(a, fit, idx[None].to(where), th0.to(where), dtype=dt)
                    got[(side, tag)] = (res.Xi * res.mask).cpu().double().numpy()
                    walls[f"{side}_{tag}_s"] = time.time() - t
            rel = lambda p, q: S._rel_max(got[p], got[q])
            emit({"phase": "fault12", "draw": draw, "epochs": epochs,
                  "card_f32_vs_cpu_f32": rel(("card", "f32"), ("cpu", "f32")),
                  "card_f32_vs_card_f64": rel(("card", "f32"), ("card", "f64")),
                  "cpu_f32_vs_cpu_f64": rel(("cpu", "f32"), ("cpu", "f64")),
                  "card_f64_vs_cpu_f64": rel(("card", "f64"), ("cpu", "f64")), **walls})

if "fault12b" in which:
    import contextlib
    from symmetry_ode_discovery_tpu_torch.cli.main import build_fit, fit_latent_chunk
    x, dx = S.selkov_data(dev)
    args = vars(get_args(["--config", S.SELKOV_CONFIG, "--use_latent", "--seed", "0"]))
    sides = {"card": dev, "cpu": torch.device("cpu")}
    fits = {}
    for side, where in sides.items():
        a = dict(args)
        fits[side] = (a, build_fit(a, train_data=(x, dx), device=where, ckpt_root=str(S.CKPT_ROOT)))
    n = x.shape[0]
    k = int(n * S.LATENT_SUBSAMPLE)
    for draw in range(8):  # the draws of fault12, at the config's 200 epochs
        gen = torch.Generator().manual_seed(draw)
        idx = torch.randperm(n, generator=gen)[:k]
        th0 = torch.randn((1, 20), generator=gen)
        nudged = torch.nextafter(th0, torch.full_like(th0, float("inf")))  # one ulp up
        got = {}
        for side, where in sides.items():
            a, fit = fits[side]
            for tag, t0 in (("th0", th0), ("nudged", nudged)):
                with S.cpu_threads() if side == "cpu" else contextlib.nullcontext():
                    res, _ = fit_latent_chunk(a, fit, idx[None].to(where), t0.to(where))
                got[(side, tag)] = (res.Xi * res.mask).cpu().double().numpy()
        rel = lambda p, q: S._rel_max(got[p], got[q])
        emit({"phase": "fault12b", "draw": draw, "epochs": args["num_epochs"],
              "card_f32_vs_cpu_f32": rel(("card", "th0"), ("cpu", "th0")),
              "card_nudged_vs_card": rel(("card", "nudged"), ("card", "th0")),
              "cpu_nudged_vs_cpu": rel(("cpu", "nudged"), ("cpu", "th0"))})

if "fault12c" in which:
    import contextlib, dataclasses
    from symmetry_ode_discovery_tpu_torch.cli.main import build_fit, fit_latent_chunk
    from symmetry_ode_discovery_tpu_torch.training.siged import LatentCtx, train_sindy_lbfgs
    x, dx = S.selkov_data(dev)
    args = vars(get_args(["--config", S.SELKOV_CONFIG, "--use_latent", "--seed", "0"]))
    sides = {"card": dev, "cpu": torch.device("cpu")}
    fits = {side: build_fit(dict(args), train_data=(x, dx), device=where,
                            ckpt_root=str(S.CKPT_ROOT)) for side, where in sides.items()}
    on = lambda side: S.cpu_threads() if side == "cpu" else contextlib.nullcontext()
    n = x.shape[0]
    k = int(n * S.LATENT_SUBSAMPLE)
    for draw in range(8):  # the draws of fault12
        gen = torch.Generator().manual_seed(draw)
        idx = torch.randperm(n, generator=gen)[:k]
        th0 = torch.randn((1, 20), generator=gen)
        enc = {}
        for side, where in sides.items():
            ae = fits[side]["ae"]
            xs, dxs = fits[side]["x"][idx.to(where)][None], fits[side]["dx"][idx.to(where)][None]
            with on(side), torch.no_grad():
                enc[side] = (ae.encode(xs).cpu(), ae.compute_dz(xs, dxs).cpu(), dxs.cpu())
        for epochs in (1, 10, 200):
            cpu_fit = dict(fits["cpu"], hp=dataclasses.replace(fits["cpu"]["hp"], num_epochs=epochs))
            with on("cpu"):
                ref, _ = fit_latent_chunk(args, cpu_fit, idx[None], th0, dtype=torch.float64)
            ref = (ref.Xi * ref.mask).double().numpy()
            rec = {"phase": "fault12c", "draw": draw, "epochs": epochs}
            for e_side in sides:
                for o_side, where in sides.items():
                    fit = fits[o_side]
                    hp = dataclasses.replace(fit["hp"], num_epochs=epochs)
                    z, dz, dxs = (t.to(where) for t in enc[e_side])
                    with on(o_side):
                        res = train_sindy_lbfgs(
                            fit["cfg"], fit["Q"], z, dz, hp, th0.to(where),
                            latent=LatentCtx(decode_jvp=fit["ae"].compute_dx,
                                             w_sindy_z=args["w_sindy_z"]),
                            dx_data=dxs, epochs_per_call=max(1, min(args["epochs_per_call"], epochs)))
                    got = (res.Xi * res.mask).cpu().double().numpy()
                    rec[f"enc_{e_side}_lbfgs_{o_side}_vs_f64"] = S._rel_max(got, ref)
            rec["z_card_vs_cpu"] = S._rel_max(enc["card"][0].double().numpy(),
                                              enc["cpu"][0].double().numpy())
            rec["dz_card_vs_cpu"] = S._rel_max(enc["card"][1].double().numpy(),
                                               enc["cpu"][1].double().numpy())
            emit(rec)

print(smi, flush=True)
