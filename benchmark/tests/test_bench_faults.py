"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (benchmark/faults.py), and a sound run
correct: each cell at the CPU's size, the harness's look for a card
skipped, the rest of the run driven as on the card."""

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = [(name, fault) for name, driver in ((tiny.SWEEP, "eqsindy_sweep"),
                                            (tiny.LALIGAN, "lassi_train"))
         for fault in (None,) + faults.KINDS[driver]]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_fails_the_comparison(name, fault, tmp_path):
    import time

    cell = tiny.cell(name, tmp_path)
    driver = harness.load_module(cell["driver"])
    if fault is None:
        out = driver.run(cell, 2**31 + 3, 0.0, False, CPU, time.perf_counter())
        assert harness.checks_ok(out["checks"]), out["checks"]
        return
    with faults.plant(cell["traffic"]["driver"], fault):
        out = driver.run(cell, 2**31 + 3, 0.0, False, CPU, time.perf_counter())
    assert not harness.checks_ok(out["checks"]), out["checks"]


def test_sweep_window_crosses_chunks(tmp_path, monkeypatch):
    """A chunk that ends inside the window is scored and the next one drawn
    and started; progress counts each finished chunk whole. The window's
    clock is one that advances a second a reading, so the window makes four
    calls whatever the machine's speed."""
    import itertools
    import types

    cell = tiny.cell(tiny.SWEEP, tmp_path)
    cell["config"]["argv"] = cell["config"]["argv"] + ["--num_epochs", "2"]
    driver = harness.load_module(cell["driver"])
    sw = driver.Sweep(cell, 9, CPU)
    ticks = itertools.count()
    monkeypatch.setattr(driver, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))
    w = driver.window(sw, 4.0, False, 0.0)
    lanes = cell["traffic"]["seed_chunk"]
    assert w["calls"] == 4 and sw.chunk >= 1
    assert lanes * sw.chunk <= w["seeds"] <= lanes * (sw.chunk + 1)
