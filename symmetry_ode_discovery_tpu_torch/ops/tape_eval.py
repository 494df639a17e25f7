"""Tape evaluation of the GP engine: the CUDA kernels K5 (forward) and K6
(constant gradient) of csrc/tape_eval.cu, their plain PyTorch versions and
the autograd Function that joins them.

The port's counterpart of symmetry_ode_discovery_tpu/symgp/pallas_eval.py
(``eval_tapes_pallas``, ``eval_tapes_pallas_grad``, ``make_diff_eval_pallas``),
batched over a leading unit axis: one launch evaluates the populations of
all U units of a sweep, each on its own rows.

    ops, args (U, P, L) int32;  consts (U, P, L) float32;  X (U, N, n_vars)
    eval_tapes_kernel(...)            -> (U, P, N) predictions       (K5)
    eval_tapes_grad_kernel(..., gbar) -> (U, P, L) d sum(gbar * pred) / d consts,
                                         0 in non-CONST slots        (K6)

``eval_tapes`` is differentiable in ``consts`` only (X is data, ops and args
are integers), as ``make_diff_eval_pallas`` is: on CUDA tensors its forward
is K5 and its backward K6; on CPU tensors it runs ``eval_tapes_plain``
(symgp/tape.py) and autograd through it (``eval_tapes_grad_plain``).

K5 also runs in bfloat16, as ``eval_tapes_pallas`` does on bf16 X and
consts: bf16 rows and constants in, a bf16 stack, bf16 predictions out,
each step rounded to bf16 (on the card as bf16x2 pairs, 8 rows a lane and
256 rows a warp's pass, where f32 takes 4 and 128). That mode is
forward-only (the fitness evaluation); K6 takes float32 only.
"""

from __future__ import annotations

import ctypes

import torch

from ..symgp.tape import eval_tapes_plain, op_table_codes
from ._nvcc import CSRC, Kernel

SOURCE = CSRC / "tape_eval.cu"
# no FMA contraction, IEEE division and square root, no flush to zero: each
# step is the reference's own f32 operation
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-Xptxas", "-v")
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(SOURCE, NVCC_FLAGS, {
    "tape_eval_launch": ([_P] * 5 + [_I] * 6 + [ctypes.c_uint, _I, _P], _I),
    "tape_grad_launch": ([_P] * 6 + [_I] * 6 + [ctypes.c_uint, _P], _I),
    "tape_eval_geometry": ([_I] * 6 + [_P, _P], _I)})

# Kernel launches through eval_tapes_kernel (bf16 ones under tape_eval_bf16)
# and eval_tapes_grad_kernel (the plain path does not count).
launches = {"tape_eval": 0, "tape_eval_bf16": 0, "tape_grad": 0}


def table_mask(op_table=None) -> int:
    """Bit k set for each opcode k the interpreter computes."""
    mask = 0
    for code in op_table_codes(op_table):
        mask |= 1 << code
    return mask


def _check(kernel, ops, args, consts, X, stack_depth, gbar=None):
    """Raises ValueError unless K5 (``kernel`` 5) or K6 (6) takes these
    tensors: consts and X float32, or for K5 both bfloat16; the size limits
    are the launcher's (``geometry``)."""
    device = X.device
    if device.type != "cuda":
        raise ValueError(f"the tape kernels run on cuda, not {device}")
    if ops.ndim != 3 or ops.shape != args.shape or ops.shape != consts.shape:
        raise ValueError(f"ops, args, consts must be one (U, P, L) shape, got "
                         f"{tuple(ops.shape)}, {tuple(args.shape)}, {tuple(consts.shape)}")
    U, P, L = ops.shape
    if X.ndim != 3 or X.shape[0] != U:
        raise ValueError(f"X must be (U={U}, N, n_vars), got {tuple(X.shape)}")
    fdtype = torch.bfloat16 if kernel == 5 and X.dtype == torch.bfloat16 else torch.float32
    for name, t, dtype in (("ops", ops, torch.int32), ("args", args, torch.int32),
                           ("consts", consts, fdtype), ("X", X, fdtype)):
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {device}, got "
                             f"{t.dtype} on {t.device}")
    if gbar is not None and (gbar.shape != (U, P, X.shape[1]) or gbar.device != device
                             or gbar.dtype != torch.float32 or not gbar.is_contiguous()):
        raise ValueError(f"gbar must be contiguous float32 (U, P, N) on {device}, got "
                         f"{tuple(gbar.shape)} {gbar.dtype} on {gbar.device}")
    geometry(kernel, L, stack_depth, X.shape[2], max(1, X.shape[1]), fdtype)


def geometry(kernel: int, L: int, stack_depth: int, n_vars: int, N: int,
             dtype=torch.float32):
    """(tapes per CTA, rows a warp covers per pass) of K5 (``kernel`` 5, in
    ``dtype``: 128 rows in float32, 256 in bfloat16) or K6 (6) on N rows, as
    the launcher reports them (builds the library). Raises ValueError where
    the launcher refuses the sizes (its limits on L, the depth and n_vars,
    and the shared memory a CTA needs)."""
    tapes, rows = ctypes.c_int(), ctypes.c_int()
    rc = KERNEL.lib().tape_eval_geometry(kernel, int(dtype == torch.bfloat16), L, stack_depth,
                                         n_vars, N, ctypes.byref(tapes), ctypes.byref(rows))
    if rc != 0:
        raise ValueError(f"K{kernel} does not take L={L}, depth {stack_depth}, "
                         f"{n_vars} variables, {N} rows in {dtype}")
    return tapes.value, rows.value


def eval_tapes_kernel(ops, args, consts, X, stack_depth: int = 16, op_table=None):
    """K5: (U, P, N) predictions of the (U, P, L) tapes on X (U, N, n_vars),
    in X's dtype (float32, or bfloat16 with bfloat16 consts)."""
    _check(5, ops, args, consts, X, stack_depth)
    U, P, L = ops.shape
    N, n_vars = X.shape[1], X.shape[2]
    bf16 = X.dtype == torch.bfloat16
    out = torch.empty((U, P, N), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(X.device):
        rc = lib.tape_eval_launch(ops.data_ptr(), args.data_ptr(), consts.data_ptr(),
                                  X.data_ptr(), out.data_ptr(), U, P, L, N, n_vars,
                                  stack_depth, table_mask(op_table), int(bf16),
                                  torch.cuda.current_stream(X.device).cuda_stream)
    key = "tape_eval_bf16" if bf16 else "tape_eval"
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {rc}")
    launches[key] += 1
    return out


def eval_tapes_grad_kernel(ops, args, consts, X, gbar, stack_depth: int = 16, op_table=None):
    """K6: (U, P, L) d sum(gbar * eval_tapes(...)) / d consts."""
    _check(6, ops, args, consts, X, stack_depth, gbar)
    U, P, L = ops.shape
    N, n_vars = X.shape[1], X.shape[2]
    gc = torch.empty((U, P, L), dtype=torch.float32, device=X.device)
    if gc.numel() == 0 or N == 0:
        return gc.zero_()
    lib = KERNEL.lib()
    with torch.cuda.device(X.device):
        rc = lib.tape_grad_launch(ops.data_ptr(), args.data_ptr(), consts.data_ptr(),
                                  X.data_ptr(), gbar.data_ptr(), gc.data_ptr(), U, P, L, N,
                                  n_vars, stack_depth, table_mask(op_table),
                                  torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tape_grad kernel launch failed: CUDA error {rc}")
    launches["tape_grad"] += 1
    return gc


def eval_tapes_grad_plain(ops, args, consts, X, gbar, stack_depth: int = 16, op_table=None):
    """K6's plain version: autograd of ``eval_tapes_plain`` in ``consts``,
    a chunk of tapes at a time (each tape's gradient is its own) so that the
    (U, chunk, D, N) stacks autograd keeps for the L steps stay under 2^28
    elements."""
    U, P, L = ops.shape
    chunk = max(1, min(P, (1 << 28) // max(1, U * stack_depth * X.shape[1] * L)))
    out = []
    for s in range(0, ops.shape[1], chunk):
        c = consts[:, s:s + chunk].detach().clone().requires_grad_(True)
        with torch.enable_grad():
            pred = eval_tapes_plain(ops[:, s:s + chunk], args[:, s:s + chunk], c, X,
                                    stack_depth, op_table)
            (g,) = torch.autograd.grad(pred, c, gbar[:, s:s + chunk])
        out.append(g)
    return torch.cat(out, dim=1)


class _EvalTapes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, consts, ops, args, X, stack_depth, op_table):
        ctx.save_for_backward(ops, args, consts, X)
        ctx.stack_depth, ctx.op_table = stack_depth, op_table
        if X.device.type == "cpu":
            return eval_tapes_plain(ops, args, consts, X, stack_depth, op_table)
        return eval_tapes_kernel(ops, args, consts, X, stack_depth, op_table)

    @staticmethod
    def backward(ctx, gbar):
        ops, args, consts, X = ctx.saved_tensors
        fn = eval_tapes_grad_plain if X.device.type == "cpu" else eval_tapes_grad_kernel
        gc = fn(ops, args, consts, X, gbar.contiguous(), ctx.stack_depth, ctx.op_table)
        return gc, None, None, None, None, None


def eval_tapes(ops, args, consts, X, stack_depth: int = 16, op_table=None):
    """(U, P, N) predictions, differentiable in consts: K5 forward and K6
    backward on CUDA tensors, the plain versions on CPU tensors."""
    return _EvalTapes.apply(consts, ops, args, X, stack_depth, op_table)
