"""Where a path's time goes on the card: a LaLiGAN training epoch, the LTP
rollout, the Adam trainer or the latent-space fit.

    python -m symmetry_ode_discovery_tpu_torch.cli.profile_paths --path lassi \
        --config lv/noise99_sym.cfg [--warm 1]
    python -m symmetry_ode_discovery_tpu_torch.cli.profile_paths --path ltp \
        --config lv/noise99_eq_sindy_2.cfg --eval_root build/chip_data/eval
    python -m symmetry_ode_discovery_tpu_torch.cli.profile_paths --path adam \
        --config build/chip_data/adam.cfg [--batches 20]
    python -m symmetry_ode_discovery_tpu_torch.cli.profile_paths --path latent \
        --config selkov/noise20_eq_symreg.cfg --use_latent --lbfgs_subsample 0.005 \
        --n_seeds 10 --seed 0

Runs one pass of the path ``--warm`` times, then once under
torch.profiler, and prints one JSON line: the warm walls, the wall under
the profiler, the device's busy time (the union of its kernels' spans), the
idle share of the profiled wall, kernel launches (per batch for lassi and
adam), the device time by kernel name (top 12), and the card's name and
power limit. A pass: lassi, one epoch of the config's trainer at full width
from its seed on the config's train windows and their derivatives (cached
or generated; rd/sym_eq.cfg's joint SINDy terms read the derivatives);
ltp, cli/eval_ltp_sweep.py::run of the config's sweep under --eval_root
(clean validation data from $SODT_TORCH_DATA_PATH); adam, --batches batches
of the config's training split through the Adam trainer the CLI builds (one
epoch); latent, cli/main.py::run with the flags given (outputs under a
temporary directory). Flags this module does not take go to the CLI's
parser.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import tempfile
import time


def busy_us(kernels) -> float:
    """Microseconds covered by the union of the kernels' device spans."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def trace(fn, n_batches: int = 1, warm: int = 1) -> dict:
    """``warm`` timed calls of ``fn``, then one under torch.profiler: the
    walls, the device's busy time and idle share, kernel launches (and per
    batch, for ``n_batches`` batches a call), device time by kernel name and
    the card's name and power limit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cpu_names = {e.name for e in events if getattr(e, "device_type", None) == DeviceType.CPU}
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA
               and e.name not in cpu_names]
    if not kernels:
        raise RuntimeError("profile: the trace holds no device kernels")
    busy = busy_us(kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return {"warm_walls_s": walls, "wall_s_profiled": wall_us / 1e6,
            "device_busy_s": busy / 1e6, "idle_share": 1.0 - busy / wall_us,
            "kernel_launches": len(kernels), "batches": n_batches,
            "launches_per_batch": len(kernels) / n_batches,
            "top_kernels_ms": sorted(((k[:80], v / 1e3) for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:12],
            "nvidia_smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()}


def _path_fn(path: str, argv, dev, tmp: str, batches: int):
    """A callable running one pass of ``path`` for the parsed flags, and the
    batches one pass takes."""
    import torch

    from ..utils.config import get_args

    args = vars(get_args(argv))
    if path == "lassi":
        from ..data.datasets import get_dataset
        from .main import build_trainer

        train_ds, args = get_dataset(args, dev)
        x, dx = train_ds.materialize()
        tr = build_trainer(args, dev, steps_per_epoch=max(1, x.shape[0] // args["batch_size"]))
        tr.init(args["seed"])
        gen = torch.Generator(device=dev).manual_seed(args["seed"])
        n_batches = x.shape[0] // min(tr.hp.batch_size, x.shape[0])
        return (lambda: {k: float(v) for k, v in tr.epoch(x, gen, dx_data=dx).items()}), n_batches
    if path == "ltp":
        from .eval_ltp_sweep import run

        return (lambda: run(dict(args), device=dev)), 1
    if path == "latent":
        from .main import run

        args.update(eval_root=f"{tmp}/eval", save_root=f"{tmp}/saved")
        return (lambda: run(dict(args, overwrite_eval=True), device=dev)), 1
    if path == "adam":
        from ..training.siged_adam import train_siged_adam
        from .main import build_adam_trainer, build_fit

        fit = build_fit(args, device=dev)
        rows = batches * args["batch_size"]
        args["num_epochs"] = 1
        tr = build_adam_trainer(args, fit)
        x, dx = fit["x"][:rows], fit["dx"][:rows]
        perm = [torch.randperm(rows, generator=torch.Generator().manual_seed(0))]
        return (lambda: train_siged_adam(tr, x, dx, perms=perm)), batches
    raise ValueError(f"unknown path {path!r}")


def profile(path: str, argv, batches: int = 20, warm: int = 1) -> dict:
    from .. import resolve_device

    dev = resolve_device(None)
    with tempfile.TemporaryDirectory() as tmp:
        fn, n_batches = _path_fn(path, argv, dev, tmp, batches)
        return dict(trace(fn, n_batches, warm), phase=f"profile_{path}", argv=list(argv))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", required=True, choices=("lassi", "ltp", "adam", "latent"))
    ap.add_argument("--batches", type=int, default=20, help="adam: batches of one pass")
    ap.add_argument("--warm", type=int, default=1, help="passes before the profiled one")
    a, rest = ap.parse_known_args(argv)
    print(json.dumps(profile(a.path, rest, a.batches, a.warm)), flush=True)


if __name__ == "__main__":
    main()
