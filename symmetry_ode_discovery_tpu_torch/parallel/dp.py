"""Data-parallel training: one process a device, joined by a process group.

The port's counterpart of the JAX package's batch-axis sharding of LaLiGAN
training (``LassiTrainer(dp_mesh=...)``), where XLA inserts the collectives.
Here they are written out, with ``all_reduce`` alone (gloo supports only
``all_reduce`` and ``broadcast`` on CUDA tensors):

- every rank holds the whole dataset and the same parameters, draws the
  global batch's permutation and random coefficients from the same
  generator, and takes its own contiguous slice of the batch's rows;
- a mean over the batch is the all-reduced sum of the ranks' rows over the
  global count (``DataParallel.mean``), differentiable: the backward of the
  sum is the all-reduce of the gradients, so every rank's loss is the
  global batch's and the BatchNorm statistics are the global batch's;
- the gradients are all-reduced and divided by the world size, so every
  rank takes the same optimiser step.

``launch`` starts the processes (torch.multiprocessing, spawn), sets each
one's device, joins them in a process group initialised through a file in
a temporary directory (no TCP port to race for), and returns rank 0's
result.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """sum over the ranks, whose backward is the sum of the ranks'
    gradients (each rank's loss depends on every rank's inputs)."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return dp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.all_reduce(g.clone()), None


@dataclasses.dataclass
class DataParallel:
    """One rank's place in a data-parallel run: its process group, rank and
    the world size, and the count of all-reduces it made (each forward,
    backward and gradient one)."""
    group: object
    rank: int
    world: int
    all_reduces: int = 0
    progress: Callable = None  # rank 0's channel to the launching process

    def report_progress(self):
        """Tell the launching process that training moved on (rank 0 only;
        the launcher feeds its heartbeat watchdog with it)."""
        if self.progress is not None:
            self.progress()

    def __deepcopy__(self, memo):
        return self  # a handle on the process group: copies of a model share it

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (not differentiable)."""
        self.all_reduces += 1
        dist.all_reduce(t, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of ``t`` over the ranks."""
        return _AllReduceSum.apply(t, self)

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of a global batch of ``n`` rows."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not divide over {self.world} ranks")
        m = n // self.world
        return slice(self.rank * m, (self.rank + 1) * m)

    def mean(self, t: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
        """The global batch's mean of ``t`` (this rank's rows; over every
        element, or over ``dim``), differentiable; every rank's slice has
        as many rows."""
        if dim is None:
            return self.sum(t.sum()) / (t.numel() * self.world)
        s = t.sum(dim=dim, keepdim=keepdim)
        return self.sum(s) / (t.numel() // s.numel() * self.world)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of ``t`` (rank order), by one all-reduce
        of a zero-padded buffer (exact: every other entry adds 0)."""
        n = t.shape[0] * self.world
        buf = t.new_zeros((n,) + tuple(t.shape[1:]))
        buf[self.rows(n)] = t
        return self.all_reduce(buf)

    def average_grads(self, grads: Sequence[torch.Tensor]) -> list:
        """The gradients summed over the ranks and divided by the world size,
        in one all-reduce of their concatenation."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat)
        flat /= self.world
        out, k = [], 0
        for g in grads:
            out.append(flat[k:k + g.numel()].view_as(g))
            k += g.numel()
        return out

    def barrier(self):
        self.all_reduce(torch.zeros(1, device=_group_device(self)))


def _group_device(dp: DataParallel) -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(dp.group) == "nccl" else torch.device("cpu"))


def _numpy(tree):
    """``tree`` with every tensor a numpy array (results cross the process
    boundary by value)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _worker(rank: int, devices, backend: str, init: str, fn, args, queue):
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=len(devices), rank=rank)
        progress = (lambda: queue.put((rank, None, None))) if rank == 0 else None
        out = fn(DataParallel(dist.group.WORLD, rank, len(devices), progress=progress), dev,
                 *args)
        queue.put((rank, True, _numpy(out) if rank == 0 else None))
    except Exception:  # the parent raises it, with this traceback
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def backend_for(devices: Sequence) -> str:
    """nccl when every rank has a CUDA device of its own, else gloo (ranks
    sharing a card, or on the CPU)."""
    devices = [torch.device(d) for d in devices]
    distinct = len({str(d) for d in devices}) == len(devices)
    return "nccl" if distinct and all(d.type == "cuda" for d in devices) else "gloo"


def launch(fn: Callable, devices: Sequence, backend: str = None, args: tuple = ()):
    """Run ``fn(dp, device, *args)`` in one process a device of ``devices``
    (rank i on devices[i]; a device may repeat, with gloo) and return rank
    0's result, its tensors as numpy arrays. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function). The backend defaults to
    ``backend_for(devices)``. A rank that raises stops the others, and its
    traceback is raised here. Each ``report_progress()`` of rank 0 beats
    this process's heartbeat watchdog (utils/watchdog.py); the ranks arm
    none, and a watchdog firing here ends them and removes the rendezvous
    before it relaunches."""
    from ..utils import watchdog

    devices = [str(torch.device(d)) for d in devices]
    backend = backend or backend_for(devices)
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, args=(r, devices, backend, init, fn, args, queue),
                             daemon=True) for r in range(len(devices))]

        def end_ranks():
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
            shutil.rmtree(tmp, ignore_errors=True)

        unregister = watchdog.at_fire(end_ranks)
        for p in procs:
            p.start()
        results, failure = {}, None
        try:
            while len(results) < len(procs) and failure is None:
                if queue.empty():
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead and queue.empty():
                        failure = f"a rank exited with code {dead[0].exitcode}"
                    time.sleep(0.01)
                    continue
                rank, ok, out = queue.get()
                if ok is None:
                    watchdog.beat()
                elif ok:
                    results[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            unregister()
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return results[0]
