"""The yardstick's arithmetic against hand counts: chain operations and
bytes, the MLP training counts, and the trace reductions (busy union, idle
gaps by host event, device time by name and under a label)."""

import json

import pytest

from benchmark.counts import flops
from benchmark.counts.trace import NO_OPERATOR, STRETCH, Trace, idle_gaps, union_length


def test_chain_flops_by_hand():
    w = [2, 4, 4, 3]  # 2x4, 4x4, 4x3
    assert flops.chain_flops(w) == 2 * (8 + 16 + 12)
    assert flops.chain_flops(w, hidden_only=True) == 2 * (8 + 16)
    assert flops.mlp_widths(2, 512, 5, 2) == [2, 512, 512, 512, 512, 512, 2]


def test_k23_work_by_hand():
    enc = dec = [2, 4, 4, 2]
    rows = 10
    f, b = flops.k23_work(rows, enc, dec)
    per_row = 2 * (8 + 16 + 8)
    assert f == rows * 5 * per_row  # K2 fwd, K2 bwd, K3 fwd (two chains), K3 bwd
    weights = 4 * ((8 + 4) + (16 + 4) + (8 + 2))
    masks = rows * 8 // 8  # two hidden layers of 4 bits a row
    io = 4 * rows * 2
    assert b == (2 * (weights + masks + 2 * io)  # K2: x and z, then cz and cx
                 + weights + masks + 3 * io       # K3 fwd: z, u in; v out
                 + weights + masks + 2 * io)      # K3 bwd: cv in, cu out


def test_bound_picks_the_larger():
    t, by = flops.bound_s(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = flops.bound_s(1.0, 67e12)
    assert by == "operations" and t == pytest.approx(1.0)


def test_mlp_train_flops_by_hand():
    # forward + weight gradient everywhere; input gradient but at the first layer
    assert flops.mlp_train_flops(5, [3, 4, 2], input_grad=False) == 5 * 2 * (2 * 12 + 3 * 8)
    assert flops.mlp_train_flops(5, [3, 4, 2], input_grad=True) == 5 * 2 * (3 * 12 + 3 * 8)


def test_lassi_step_flops_by_hand():
    b, nc, d, lat, h, n = 8, 2, 2, 2, 4, 1
    enc = 2 * (2 * d * h + 3 * h * lat) * b * nc   # [2, 4, 2], no input gradient at x
    dec = 2 * (3 * lat * h + 3 * h * d) * b * nc   # [2, 4, 2]
    disc_g = 2 * (3 * 4 * h + 3 * h * 1) * b       # [4, 4, 1] on zt, with its input gradient
    disc_d = 2 * (2 * 4 * h + 3 * h * 1) * b       # on detached latents
    assert flops.lassi_step_flops(b, nc, d, lat, h, n) == enc + dec + disc_g + 2 * disc_d


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 9.0)]
    assert union_length(iv) == pytest.approx(5.0)
    assert union_length([]) == 0.0
    assert idle_gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 8.0), (9.0, 10.0)]


def _trace(tmp_path):
    us = 1e6
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": STRETCH, "ts": 0, "dur": 10 * us, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "euler_pair", "ts": 1 * us,
         "dur": 2 * us, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 4 * us, "dur": 2 * us, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.5 * us, "dur": 1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 3.5 * us, "dur": 1,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void symmpen_kernel<512>", "ts": 2 * us,
         "dur": 2 * us, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 3 * us, "dur": 2 * us,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 8 * us, "dur": 1 * us},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace.load(str(path))


def test_trace_reductions(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s() == pytest.approx(4.0)  # [2, 5] and [8, 9]
    assert len(t.kernels) == 2
    assert t.device_s(lambda n: "symmpen_kernel" in n) == pytest.approx(2.0)
    assert t.device_s_under(("euler_pair",)) == pytest.approx(2.0)  # launched at 1.5 s
    assert t.device_ops()[0][1] == pytest.approx(2.0)
    gaps = dict(t.gaps_by_host())
    # [0, 2] and [9, 10] start where no host event runs; [5, 8] under aten::item
    assert gaps == pytest.approx({NO_OPERATOR: 3.0, "aten::item": 3.0})
