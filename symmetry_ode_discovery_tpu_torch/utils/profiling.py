"""Tracing and timing: torch.profiler traces written as Chrome traces
(viewable in Perfetto or chrome://tracing), wall-clock timing that waits
for the card's queued work, and a summary of a trace by operation name.

The port's counterpart of symmetry_ode_discovery_tpu/utils/profiling.py.
``summarize_trace`` takes the place of ``summarize_xplane``: torch's
profiler writes a Chrome trace, not an XPlane, with the card's kernels,
copies and fills on one side ("device") and the host's operators and
``record_function`` labels on the other ("host").
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Iterator, Optional

import torch

# Chrome-trace categories of each side of a torch.profiler trace
PLANES = {"device": ("kernel", "gpu_memcpy", "gpu_memset"),
          "host": ("cpu_op", "user_annotation")}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler (CPU activity, and CUDA when a
    card is present) and write its Chrome trace under ``log_dir`` (default
    ``sodt-trace`` in the temporary directory): ``with trace(d) as prof:
    run()``, then ``summarize_trace(d)``. Yields the profiler, whose
    ``events()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "sodt-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}-"
                     f"{time.perf_counter_ns()}.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str = "", results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock a block, waiting for the card's queued work at both ends
    (when CUDA is initialised) so that the time covers exactly the
    enclosed work; stored under ``label`` in ``results`` and printed."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    if label:
        print(f"[timed] {label}: {dt:.3f}s")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def block_all(tree) -> None:
    """Wait for the work of every CUDA device that a tensor leaf of
    ``tree`` (tensors in dicts, lists and tuples) lives on."""
    for dev in {leaf.device for leaf in _leaves(tree) if leaf.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _load_trace(log_dir: str) -> dict:
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (.json) under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize_trace(log_dir: str, plane: str = "device", top: int = 25,
                    print_table: bool = True):
    """Total time by operation name on one side of the newest trace under
    ``log_dir`` (written by ``trace``): "device", the card's kernels,
    copies and fills; "host", the host's operators and labels (nested
    spans each count in full). Returns [(name, total seconds, count)], the
    ``top`` largest by total time; raises FileNotFoundError when the
    directory holds no trace."""
    if plane not in PLANES:
        raise ValueError(f"plane must be one of {sorted(PLANES)}, got {plane!r}")
    events = _load_trace(log_dir)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    total = collections.Counter()
    count = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in PLANES[plane]:
            total[e["name"]] += float(e.get("dur", 0.0))
            count[e["name"]] += 1
    rows = [(name, us / 1e6, count[name]) for name, us in total.most_common(top)]
    if print_table:
        print(f"{plane}: {sum(count.values())} events, "
              f"{sum(total.values()) / 1e3:.1f} ms total")
        for name, sec, c in rows:
            print(f"  {sec * 1e3:9.2f} ms {c:8d}  {name[:100]}")
    return rows
