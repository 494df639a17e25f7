"""Seed-axis sharding of the sweeps over several devices.

The port's counterpart of symmetry_ode_discovery_tpu/parallel/mesh.py. A
sweep's lanes are independent (one seed, or one (dataset, seed) pair, each),
so sharding needs no collective: shard i of a ``Mesh`` takes the contiguous
slice i of the seed axis, as a ``PartitionSpec(axis)`` does, runs on its own
device, and the results are gathered in seed order. One process drives
every shard, as JAX's single controller does: each shard's work is enqueued
on its device before any result is read, so shards on distinct devices
overlap wherever the work enqueues without waiting on the host.

The port's sweep functions are batched over lanes already (JAX's ``vmap``
is their leading dimension), so the functions sharded here take and return
lane-batched tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along one named axis. A device may repeat
    (several shards on one card, or on the CPU), which only an explicit list
    gives; ``make_mesh`` never does."""
    devices: Tuple[torch.device, ...]
    axis: str = "seed"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(indexed(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    def slices(self, n: int) -> list:
        """The contiguous slice of ``n`` lanes each shard takes; ``n`` must be
        a multiple of the mesh size (pad at the call site otherwise)."""
        if n % self.size:
            raise ValueError(f"{n} lanes do not divide over a {self.size}-device mesh")
        m = n // self.size
        return [slice(i * m, (i + 1) * m) for i in range(self.size)]


def indexed(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current CUDA device
    (the device a tensor made there reports)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int = None, axis: str = "seed") -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them when
    None or 0). Raises ValueError when fewer exist, or none: degrading to a
    smaller mesh, or to the CPU, would leave the caller believing the
    sharded path is active."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or count
    if count < max(n, 1):
        wanted = f"a {n}-device mesh" if n else "a mesh of every CUDA device"
        raise ValueError(f"requested {wanted} but only {count} CUDA devices exist")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def on_device(device: torch.device):
    """The context in which work for ``device`` is enqueued: that device
    current (a kernel wrapper launches on the current device's stream)."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def gather(parts: Sequence, device) -> object:
    """Shards' outputs (each a tensor, or a tuple or dict of them, with the
    lane axis leading) concatenated in shard order on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: gather([p[k] for p in parts], device) for k in first}
    return type(first)(gather([p[i] for p in parts], device) for i in range(len(first)))


def shard_sweep(run_shard: Callable, mesh: Mesh) -> Callable:
    """Lift a lane-batched sweep to a sharded one.

    ``run_shard(lanes, device)`` -> a tensor, or a tuple or dict of tensors,
    with the lane axis leading, for the lanes ``lanes`` (a slice of the
    caller's sequence) computed on ``device``. Returns ``f(lanes)``: shard i
    runs the slice i of ``lanes`` on ``mesh.devices[i]``, every shard
    enqueued before any result is read, and the results are gathered in lane
    order on the mesh's first device."""
    return lambda lanes: gather(_per_shard(run_shard, lanes, mesh), mesh.devices[0])


def _per_shard(fn, lanes, mesh: Mesh) -> list:
    """fn(lanes[slice i], device i) of every shard, each enqueued with its
    device current, in shard order."""
    out = []
    for dev, sl in zip(mesh.devices, mesh.slices(len(lanes))):
        with on_device(dev):
            out.append(fn(lanes[sl], dev))
    return out


class ShardedCarry:
    """A host-stepped carry split over a mesh: one carry per shard, each on
    its shard's device across steps. ``carry[key]`` gathers that leaf of
    every shard in lane order on the first shard's device."""

    def __init__(self, parts, devices):
        self.parts, self.devices = list(parts), devices

    def __getitem__(self, key):
        return gather([p[key] for p in self.parts], self.devices[0])


def shard_stepper(prep: Callable, init: Callable, step: Callable, extract: Callable,
                  mesh: Mesh):
    """Mesh-sharded versions of a host-stepped sweep's functions
    (EquivSINDy-r).

    ``prep(lanes, device)`` -> the arguments of ``init`` for those lanes on
    ``device``; ``init(*args)`` -> carry (a dict of lane-batched tensors);
    ``step(carry, epoch0)`` -> carry; ``extract(carry)`` -> lane-batched
    outputs. Each function runs on its inputs' device. Returns (prep_s,
    init_s, step_s, extract_s), drop-in replacements that pass a
    ``ShardedCarry`` between them: shard i holds the slice i of the lanes
    (their count a multiple of the mesh size: pad at the call site), every
    leaf of its carry on its device, each step enqueued on every shard
    before any is read, and ``extract_s`` gathers in lane order on the
    mesh's first device."""
    def each(fn, parts, *extra):
        out = []
        for dev, part in zip(mesh.devices, parts):
            with on_device(dev):
                out.append(fn(part, *extra))
        return out

    def prep_s(lanes):
        return _per_shard(prep, lanes, mesh)

    def init_s(prepped):
        return ShardedCarry(each(lambda args: init(*args), prepped), mesh.devices)

    def step_s(carry: ShardedCarry, epoch0: int):
        return ShardedCarry(each(step, carry.parts, epoch0), mesh.devices)

    def extract_s(carry: ShardedCarry):
        return gather(each(extract, carry.parts), mesh.devices[0])

    return prep_s, init_s, step_s, extract_s
