"""Where one LaLiGAN training epoch's time goes on the card.

    python -m symmetry_ode_discovery_tpu_torch.cli.profile_lassi \
        --config lv/noise99_sym.cfg [--epochs 2]

Builds the config's trainer at full width from its seed on the config's
train windows and their derivatives (cached or generated; rd/sym_eq.cfg's
joint SINDy terms read the derivatives), runs ``--epochs`` - 1 warm epochs,
then one epoch under torch.profiler, and prints one JSON line: the epoch's
wall time with and without the profiler, the device's busy time (the union
of its kernels' spans), the idle share of the wall, kernel launches per
batch, the device time by kernel name (top 12), and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
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


def profile(config: str, epochs: int = 2, extra=()) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from .. import resolve_device
    from ..data.datasets import get_dataset
    from ..utils.config import get_args
    from .main import build_trainer

    dev = resolve_device(None)
    args = vars(get_args(["--config", config] + list(extra)))
    train_ds, args = get_dataset(args, dev)
    x, dx = train_ds.materialize()
    tr = build_trainer(args, dev, steps_per_epoch=max(1, x.shape[0] // args["batch_size"]))
    hp = tr.hp
    tr.init(args["seed"])
    gen = torch.Generator(device=dev).manual_seed(args["seed"])
    walls = []
    for _ in range(max(epochs - 1, 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        {k: float(v) for k, v in tr.epoch(x, gen, dx_data=dx).items()}
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        {k: float(v) for k, v in tr.epoch(x, gen, dx_data=dx).items()}
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
    n_batches = x.shape[0] // min(hp.batch_size, x.shape[0])
    return {"phase": "profile_lassi", "config": config, "windows": int(x.shape[0]),
            "batches": n_batches, "warm_epoch_walls_s": walls,
            "epoch_wall_s_profiled": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1.0 - busy / wall_us, "kernel_launches": len(kernels),
            "launches_per_batch": len(kernels) / n_batches,
            "top_kernels_ms": sorted(((k, v / 1e3) for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:12],
            "nvidia_smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="lv/noise99_sym.cfg")
    ap.add_argument("--epochs", type=int, default=2,
                    help="epochs in all; the last one runs under the profiler")
    a, extra = ap.parse_known_args(argv)
    print(json.dumps(profile(a.config, a.epochs, extra)), flush=True)


if __name__ == "__main__":
    main()
