"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's CUDA devices. The
cell, its configuration, traffic, driver, limits and metrics are found by
name from BENCHMARK.json (benchmark/harness.py). ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
torch.profiler stretch of the window. Every run compares what its timed
path produced with the plain reference and prints each compared number
beside its limit, last on standard error and last in the result line.
Without the cell's CUDA devices it exits 2 and prints no result. Run as a
script, the process keeps to one CPU (``pin_to_one_cpu``).
"""

import time

T_START = time.perf_counter()  # the process's set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")


def pin_to_one_cpu():
    """Keep this process, and every thread and child it starts, on the last
    CPU it may use. The cells' steps are launched by one host thread; pinned,
    a LaLiGAN step's rate spread half as widely between runs (PERF.md)."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    opts = parse(argv)
    from benchmark import harness

    cell = harness.cell(opts.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{opts.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)  # the host only launches: one thread, no pool beside it
    driver = harness.load_module(cell["driver"])
    out = driver.run(cell, opts.seed, opts.seconds, bool(opts.trace), device, T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    if opts.trace:
        metrics = harness.read_per_layer(cell["per_layer"], out["ctx"])
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {n: {"value": v, "unit": units[n]} for n, v in out["e2e"].items() if n in units}
    device_rec = dict(harness.device_info(chips), memory_peak_bytes=out["memory_peak_bytes"])
    breakdown = None
    if opts.trace:
        device_rec.update(busy_s=out["busy_s"], window_s=out["window_s"])
        breakdown = out["breakdown"]
    checks = out["checks"]
    correct = harness.checks_ok(checks)
    print(harness.result_line(correct, out["attempted"], out["failed"], metrics, device_rec,
                              checks, breakdown))
    sys.stdout.flush()
    print("setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_phases"].items()),
          file=sys.stderr)
    print(harness.checks_text(checks), file=sys.stderr)
    return 0


if __name__ == "__main__":
    pin_to_one_cpu()
    sys.exit(main())
