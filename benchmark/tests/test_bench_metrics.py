"""Each per-layer metric's reader: a number from a stretch that has what it
reads, nothing where it finds nothing, and never a share above 100%."""

import pytest

from benchmark import harness
from benchmark.counts import flops
from benchmark.counts.trace import STRETCH, Trace

US = 1e6


def _trace(with_host: bool, kernel="void symmpen_kernel<512, true, false, false>"):
    ev = [{"ph": "X", "cat": "kernel", "name": kernel, "ts": 0, "dur": 0.2 * US,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 0.3 * US, "dur": 0.1 * US,
           "args": {"correlation": 2}}]
    if with_host:
        ev += [{"ph": "X", "cat": "user_annotation", "name": STRETCH, "ts": -0.1 * US,
                "dur": 0.6 * US},
               {"ph": "X", "cat": "user_annotation", "name": "euler_pair", "ts": 0.25 * US,
                "dur": 0.01 * US},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.26 * US,
                "dur": 1, "args": {"correlation": 2}}]
        return Trace(ev)
    return Trace(ev, window_s=0.5)


def _sweep_ctx(rows=1000):
    w = flops.mlp_widths(2, 512, 5, 2)
    return {"setup_data_s": 3.0, "enc_widths": w, "dec_widths": w,
            "device": {"trace": _trace(False), "closures": 2, "chain_rows": rows},
            "host": {"trace": _trace(True), "closures": 2}}


def _lassi_ctx():
    return {"setup_data_s": 3.0, "step_flops": 1e9, "step_ms_p95": 21.5, "step_ms_median": 100.0,
            "device": {"trace": _trace(False, "sgemm"), "steps": 4},
            "host": {"trace": _trace(True, "sgemm"), "steps": 2}}


def _read(name, ctx):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(ctx)


SWEEP = [m["name"] for m in harness.spec()["per_layer"]
         if "eqsindy_r.lv99.chunk50" in m["workloads"]]
LASSI = [m["name"] for m in harness.spec()["per_layer"]
         if "laligan.lv99.b8192" in m["workloads"]]


@pytest.mark.parametrize("name", SWEEP)
def test_sweep_readers(name):
    value = _read(name, _sweep_ctx())
    assert isinstance(value, float) and value > 0
    if name.endswith("_pct"):
        assert value <= 100
    if name != "setup_data_s":
        assert _read(name, {"setup_data_s": 1.0}) is None
        assert _read(name, _lassi_ctx()) is None


@pytest.mark.parametrize("name", LASSI)
def test_lassi_readers(name):
    value = _read(name, _lassi_ctx())
    assert isinstance(value, float) and value > 0
    if name != "setup_data_s":
        assert _read(name, {"setup_data_s": 1.0}) is None
        assert _read(name, _sweep_ctx()) is None


def test_reader_values_by_hand():
    ctx = _sweep_ctx()
    assert _read("launches_per_closure", ctx) == pytest.approx(1.0)
    assert _read("idle_pct.sweep", ctx) == pytest.approx(100 * (1 - 0.3 / 0.5))
    assert _read("euler_pair_ms_per_closure", ctx) == pytest.approx(100.0 / 2)
    f, b = flops.k23_work(1000, ctx["enc_widths"], ctx["dec_widths"])
    assert _read("k23_roofline_pct", ctx) == pytest.approx(100 * flops.bound_s(b, f)[0] / 0.2)
    assert _read("eqsindy_mfu_pct", ctx) == pytest.approx(100 * f / (0.5 * 67e12))
    assert _read("k23_roofline_pct", dict(ctx, device=dict(
        ctx["device"], trace=_trace(False, "other")))) is None
    lctx = _lassi_ctx()
    assert _read("launches_per_batch.laligan", lctx) == pytest.approx(0.5)
    # a step's busy time 0.3 s / 4 steps against the untraced median step of 0.1 s
    assert _read("idle_pct.laligan", lctx) == pytest.approx(100 * (1 - 0.075 / 0.1))
    assert _read("laligan_mfu_pct", lctx) == pytest.approx(100 * 1e9 / (0.1 * 67e12))
    assert _read("idle_pct.laligan", dict(lctx, step_ms_median=None)) is None
