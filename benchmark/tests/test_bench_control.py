"""On the card: the control, the reference computed with TF32 products (the
nearest precision below the configurations' float32) in the program's
place, fails each cell's limits, and the program meets them, at the
published widths on short trajectories, few lanes and a small batch.
benchmark/control.py takes the same readings at the cells' own sizes.
Without a card these tests skip."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 and the kernels exist only there")
    return torch.device("cuda", 0)


def _small(name):
    import copy

    cell = copy.deepcopy(harness.cell(name))
    cell["config"]["data"].update(n_ics=20, num_steps=2000)
    if name == tiny.SWEEP:
        cell["traffic"]["seed_chunk"] = 4
    else:
        cell["traffic"]["batch_size"] = 1024
    return cell


@pytest.mark.parametrize("seed", [7, 2**31 + 9])
@pytest.mark.parametrize("name", (tiny.SWEEP, tiny.LALIGAN))
def test_control_fails_and_program_meets_limits(card, name, seed):
    cell = _small(name)
    driver = harness.load_module(cell["driver"])
    prog = driver.first_program(cell, seed, card)
    ref = driver.reference(cell, seed, prog, card)
    ctrl = driver.reference(cell, seed, prog, card, tf32=True)
    assert harness.checks_ok(harness.checks(driver.numbers(prog, ref), cell["limits"]))
    assert not harness.checks_ok(harness.checks(driver.numbers(ctrl, ref), cell["limits"]))
