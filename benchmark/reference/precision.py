"""The precision of the reference's float32 products."""

import contextlib

import torch


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """float32 matrix products in TF32 inside the block when ``on`` (the
    control), in full float32 otherwise (the reference); the settings
    restored after it."""
    flag = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
        torch.set_float32_matmul_precision(precision)
