"""What every cell shares: the benchmark's definition (BENCHMARK.json at the
root of the checkout), a cell's files found by name, the per-layer metric
readers, the device description and the result line.

A cell names a configuration and a traffic mix. Its files, all found by
name:
- configs/<config>.json: the configuration as it is run (the program's
  flags, its data, its checkpoint) and its source;
- traffic/<traffic>.json: the mix's parameters and the driver that reads
  them;
- drivers/<driver>.py: set-up, the timed window and the comparison with the
  plain reference, for every cell of its kind;
- cells/<cell>.json: the limits of the numbers the comparison holds the cell
  to;
- metrics/<metric>.py: one reader a per-layer metric, ``read(ctx)`` -> a
  number, or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run must not load: the JAX stack and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "symmetry_ode_discovery_tpu")


def spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file as a module (names may hold dots, as metric names do)."""
    name = "bench_" + path.stem.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, else every
    cell (an end-to-end metric) or every cell that reports the end-to-end
    metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = next(m for m in end_to_end if m["name"] == metric["moves"])
    return applies(moved, cell, end_to_end)


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, read from its files: the workload entry,
    the configuration, the traffic, the limits, and the metrics it reports
    (end-to-end and per-layer)."""
    s = spec(root)
    w = next((w for w in s["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in s["configs"] if c["name"] == w["config"])
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    return {
        "name": name,
        "workload": w,
        "config": read_json(root / conf["file"]),
        "traffic": traffic,
        "driver": HERE / "drivers" / f"{traffic['driver']}.py",
        "limits": read_json(HERE / "cells" / f"{name}.json")["limits"],
        "end_to_end": [m for m in s["end_to_end"] if applies(m, name, s["end_to_end"])],
        "per_layer": [m for m in s["per_layer"] if applies(m, name, s["end_to_end"])],
    }


def read_per_layer(metrics: list, ctx: dict) -> dict:
    """{name: {"value", "unit"}} of each per-layer metric whose reader finds
    something to read in ``ctx``."""
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that a run may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def device_info(count: int = 1) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def checks(got: dict, limits: dict) -> dict:
    """Each compared number beside its limit. A driver computes exactly the
    numbers its cell's limits name."""
    if set(got) != set(limits):
        raise KeyError(f"numbers {sorted(got)} against limits {sorted(limits)}")
    return {name: {"value": got[name], "limit": limit} for name, limit in limits.items()}


def checks_ok(checks: dict) -> bool:
    """Every compared number is finite and within its limit."""
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last: each compared number beside its limit
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"{name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items())
