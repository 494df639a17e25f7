"""Traced stretches of a window (``--trace 1``): torch.profiler over a few
steps, opened and closed after synchronising, the trace read back and
deleted.

Two kinds, because tracing the host's operators costs the host time that
the device then waits for: a "device" stretch traces CUDA activity alone
(kernels, copies and fills: the busy time, the launches and each kernel's
time, at the least cost to the host), timed by the host's clock; a "host"
stretch adds the host's operators and labels, inside a STRETCH annotation
(which kernels ran under a label, and what the host was doing in each idle
gap).
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from benchmark.counts.trace import STRETCH, Trace


class Stretch:
    def __init__(self, device, kind: str):
        if kind not in ("device", "host"):
            raise ValueError(f"kind must be device or host, got {kind!r}")
        self.device, self.kind = device, kind
        self.trace = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA]
        if self.kind == "host":
            acts.insert(0, ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.rf = None
        if self.kind == "host":
            self.rf = torch.profiler.record_function(STRETCH)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = Trace.load(path, window_s=window_s)
        finally:
            os.remove(path)
        return False
