"""optax-order L-BFGS direction for the host-stepped (EquivSINDy-r) fits: the
memory update, the two-loop kernel (csrc/lbfgs_dir.cu) and its plain
PyTorch version, batched over lanes.

The port's counterpart of symmetry_ode_discovery_tpu/ops/pallas_lbfgs_dir.py
(``scale_by_lbfgs_pallas`` and ``_dir_kernel``), which reproduces
``optax.scale_by_lbfgs`` update for update:

- memory: s = params - prev params, y = g - prev g, weight rho = 1/(y.s)
  (0 where y.s == 0); all three zeroed on the first update after a reset;
  kept chronological (oldest first) and shifted by one slot per update, so
  empty slots sit in front with weight 0;
- gamma = (y.s)/(y.y) of the newest pair (1 where y.y == 0), and
  min(1, 1/|g|_2) on the first update;
- direction = the two-loop recursion over all m slots (``two_loop_direction``);
- updates = -lr * direction (``optax.scale_by_learning_rate``).

``two_loop_direction`` launches the kernel for CUDA tensors and runs
``two_loop_direction_plain`` for CPU tensors. The stepper's ``dir_backend``
flag picks between them on the card: 'pallas' (the JAX package's flag value)
is the kernel, 'xla' the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ._nvcc import CSRC, Kernel

SOURCE = CSRC / "lbfgs_dir.cu"
MAX_N = 128
# no FMA contraction: each update is the reference's multiply and subtract
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")
KERNEL = Kernel(SOURCE, NVCC_FLAGS, {
    "lbfgs_dir_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                         ctypes.c_int)})

# Kernel launches made through `two_loop_direction` (the plain path does not count).
launches = 0


def _check(name, x, shape, device):
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def two_loop_direction(g, s, y, rho, gamma):
    """H g per lane. g (lanes, n), s and y (lanes, m, n) oldest first,
    rho (lanes, m), gamma (lanes,); float32. Kernel on a CUDA device, the
    plain version on the CPU."""
    global launches
    lanes, n = g.shape
    m = s.shape[1]
    device = g.device
    for name, x, shape in (("g", g, (lanes, n)), ("s", s, (lanes, m, n)),
                           ("y", y, (lanes, m, n)), ("rho", rho, (lanes, m)),
                           ("gamma", gamma, (lanes,))):
        _check(name, x, shape, device)
    if device.type == "cpu":
        return two_loop_direction_plain(g, s, y, rho, gamma)
    if device.type != "cuda":
        raise ValueError(f"two_loop_direction runs on cuda or cpu, not {device}")
    if n > MAX_N:
        raise ValueError(f"the two-loop kernel takes at most {MAX_N} parameters, got {n}")
    lib = KERNEL.lib()
    out = torch.empty_like(g)
    with torch.cuda.device(device):
        # the stream's raw handle as PyTorch's generated code reads it: a few
        # microseconds a call cheaper than building a torch.cuda.Stream
        rc = lib.lbfgs_dir_launch(g.data_ptr(), s.data_ptr(), y.data_ptr(), rho.data_ptr(),
                                  gamma.data_ptr(), out.data_ptr(), lanes, m, n,
                                  torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"lbfgs_dir kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def two_loop_direction_plain(g, s, y, rho, gamma):
    """The same recursion as batched tensor operations, in optax's order."""
    m = s.shape[1]
    q = g
    alphas = [None] * m
    for k in range(m - 1, -1, -1):
        a = rho[:, k:k + 1] * (s[:, k] * q).sum(-1, keepdim=True)
        q = q - a * y[:, k]
        alphas[k] = a
    r = q * gamma[:, None]
    for k in range(m):
        b = rho[:, k:k + 1] * (y[:, k] * r).sum(-1, keepdim=True)
        r = r + s[:, k] * (alphas[k] - b)
    return r


def init_state(params: torch.Tensor, memory_size: int) -> dict:
    """Fresh optimizer state for params (lanes, n) (optax's init: zero
    memory, count 0)."""
    lanes, n = params.shape
    z = torch.zeros_like(params)
    return dict(count=torch.zeros(lanes, dtype=torch.int32, device=params.device),
                params=z, updates=z.clone(),
                s=params.new_zeros((lanes, memory_size, n)),
                y=params.new_zeros((lanes, memory_size, n)),
                w=params.new_zeros((lanes, memory_size)))


def update(state: dict, grad: torch.Tensor, params: torch.Tensor, lr: float,
           kernel: bool):
    """One ``optax.lbfgs(lr, linesearch=None)`` update per lane: returns
    (updates = -lr * direction, new state). ``kernel`` picks
    ``two_loop_direction`` (the kernel for CUDA tensors) over the plain
    version."""
    first = (state["count"] == 0)[:, None]
    dp = params - state["params"]
    du = grad - state["updates"]
    vdot = (du * dp).sum(-1)
    weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
    dp = torch.where(first, 0.0, dp)
    du = torch.where(first, 0.0, du)
    weight = torch.where(first[:, 0], 0.0, weight)
    s = torch.cat([state["s"][:, 1:], dp[:, None]], dim=1)
    y = torch.cat([state["y"][:, 1:], du[:, None]], dim=1)
    w = torch.cat([state["w"][:, 1:], weight[:, None]], dim=1)
    num = (du * dp).sum(-1)
    den = (du * du).sum(-1)
    gamma = torch.where(den > 0.0, num / den, 1.0)
    gnorm = torch.sqrt((grad * grad).sum(-1))
    gamma = torch.where(first[:, 0], torch.minimum(torch.ones_like(gnorm), 1.0 / gnorm), gamma)
    two_loop = two_loop_direction if kernel else two_loop_direction_plain
    direction = two_loop(grad.contiguous(), s, y, w, gamma.contiguous())
    new = dict(count=state["count"] + 1, params=params, updates=grad, s=s, y=y, w=w)
    return -lr * direction, new
