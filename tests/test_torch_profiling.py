"""The port's tracing and timing helpers (utils/profiling.py) on the CPU:
``timed`` records a time, a ``trace`` -> ``summarize_trace(plane="host")``
round trip finds the traced operators by name, and an empty directory
raises FileNotFoundError. The device side needs a card
(chip_smoke.py --profile)."""

import pytest
import torch

from symmetry_ode_discovery_tpu_torch.utils.profiling import (
    block_all, summarize_trace, timed, trace)


def test_timed_records_a_time(capsys):
    results = {}
    with timed("matmul", results):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert results["matmul"] > 0.0
    assert "[timed] matmul:" in capsys.readouterr().out


def test_trace_then_host_summary(tmp_path):
    a = torch.randn(128, 128)
    with trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("sodt_label"):
            for _ in range(3):
                a = torch.mm(a, a) / 128.0
    assert prof.events()
    rows = summarize_trace(str(tmp_path), plane="host", top=50, print_table=False)
    by_name = {name: (sec, n) for name, sec, n in rows}
    assert by_name["aten::mm"][1] == 3
    assert by_name["sodt_label"][1] == 1
    assert all(sec >= 0.0 for sec, _ in by_name.values())
    totals = [sec for _, sec, _ in rows]
    assert totals == sorted(totals, reverse=True)
    # the CPU trace has no device side
    assert summarize_trace(str(tmp_path), plane="device", print_table=False) == []


def test_summary_of_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path))


def test_block_all_on_cpu_tensors_is_a_no_op():
    block_all({"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(1),)]})
