"""What both drivers use: a synchronise, the set-up's phases, and the
program's flags of a configuration."""

from __future__ import annotations

import time

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Phases:
    """Seconds of each set-up phase, read after a synchronise."""

    def __init__(self, device):
        self.device, self.seconds, self.t = device, {}, time.perf_counter()

    def mark(self, name: str) -> float:
        sync(self.device)
        t = time.perf_counter()
        self.seconds[name] = t - self.t
        self.t = t
        return self.seconds[name]


def program_args(config: dict) -> dict:
    """The program's parsed flags (utils/config.py) of the configuration."""
    from symmetry_ode_discovery_tpu_torch.utils.config import get_args

    args = vars(get_args(list(config["argv"])))
    args["input_dim"] = config["data"]["dim"]
    return args
