"""Reading a torch.profiler Chrome trace: the device's busy time as the
union of its kernel, copy and fill intervals (the arithmetic of the port's
cli/profile_paths.py::busy_us, copied), the idle gaps between them labelled
by what the host was doing, device time by kernel name, and the device time
of the kernels launched under a ``record_function`` label.

A stretch opened and closed after synchronising holds every device interval
of its work. Where the trace has the host's side, its bounds are those of
one host annotation (``STRETCH``) opened and closed inside the
synchronises; a trace of the device alone takes its length from the host's
clock and starts at its first device interval.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "bench.stretch"
NO_OPERATOR = "host Python between operators"


def union_length(intervals) -> float:
    """Length covered by the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(intervals, t0: float, t1: float) -> list:
    """The (start, end) gaps of [t0, t1] that no interval covers."""
    gaps, cur = [], t0
    for a, b in merged(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


class Trace:
    """The events of one Chrome trace, split by side (times in seconds)."""

    def __init__(self, events: list, window_s: float = None):
        xs = [e for e in events if e.get("ph") == "X"]
        stretch = [e for e in xs if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
        s = stretch[0] if stretch else None
        if s is not None:
            self.t0 = float(s["ts"]) * 1e-6
            self.t1 = self.t0 + float(s["dur"]) * 1e-6
            inside = lambda e: self.t0 <= float(e["ts"]) * 1e-6 <= self.t1
        elif window_s is not None:
            starts = [float(e["ts"]) * 1e-6 for e in xs if e.get("cat") in DEVICE_CATS]
            self.t0 = min(starts) if starts else 0.0
            self.t1 = self.t0 + window_s
            inside = lambda e: True
        else:
            raise ValueError(f"the trace has no {STRETCH!r} annotation and no window was given")
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)]
        self.launches = {e["args"]["correlation"]: e for e in xs
                         if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.host = [e for e in xs if e.get("cat") in HOST_CATS and e is not s]
        self.labels = [e for e in xs if e.get("cat") == "user_annotation" and e is not s]

    @classmethod
    def load(cls, path: str, window_s: float = None) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data, window_s)

    @staticmethod
    def _span(e):
        a = float(e["ts"]) * 1e-6
        return a, a + float(e.get("dur", 0.0)) * 1e-6

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def kernels(self) -> list:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def busy_s(self) -> float:
        return union_length(self._span(e) for e in self.device)

    def device_s(self, match) -> float:
        """Summed device seconds of the kernels whose name ``match`` accepts."""
        return sum(self._span(e)[1] - self._span(e)[0] for e in self.kernels if match(e["name"]))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        tot = collections.Counter()
        for e in self.device:
            a, b = self._span(e)
            tot[e["name"]] += b - a
        return [[name, sec] for name, sec in tot.most_common(top)]

    def device_s_under(self, label_names) -> float:
        """Device seconds of the kernels, copies and fills whose launch lies
        inside a host annotation named in ``label_names``."""
        spans = merged(self._span(e) for e in self.labels if e["name"] in label_names)
        starts = [a for a, _ in spans]
        total = 0.0
        for e in self.device:
            launch = self.launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            t = self._span(launch)[0]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                a, b = self._span(e)
                total += b - a
        return total

    def gaps_by_host(self, top: int = 10) -> list:
        """[[label, seconds]]: the device's idle time inside the stretch,
        summed by the innermost host event that covers each gap's start
        (operators, annotations and CUDA API calls, on any thread), or
        NO_OPERATOR where none does; the ``top`` largest."""
        gaps = idle_gaps([self._span(e) for e in self.device], self.t0, self.t1)
        points = sorted((a, b - a) for a, b in gaps)
        host = sorted(self._span(e) + (e["name"],) for e in self.host)
        tot = collections.Counter()
        open_events, j = [], 0
        for p, length in points:
            while j < len(host) and host[j][0] <= p:
                open_events.append(host[j])
                j += 1
            open_events = [h for h in open_events if h[1] >= p]
            if open_events:
                inner = min(open_events, key=lambda h: h[1] - h[0])
                tot[inner[2]] += length
            else:
                tot[NO_OPERATOR] += length
        return [[name, sec] for name, sec in tot.most_common(top)]
