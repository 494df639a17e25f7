"""symmetry_ode_discovery_tpu_torch: the PyTorch/CUDA port of
symmetry_ode_discovery_tpu, written for one NVIDIA H100.

This slice covers the multi-seed L-BFGS discovery sweep: trajectory data
generated on the card (RK4, noise, GP smoothing), the SINDy library and the
equivariance constraint, the per-seed normal-equation reduction, the fused
L-BFGS protocol as a hand-written CUDA kernel (csrc/lbfgs_sweep.cu) and the
form/RMSE scoring. The JAX package in the same repository is the reference
that every module here is held against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
``device=None`` and no CUDA device they raise instead of falling back.
"""

import torch

__version__ = "0.1.0"

# Coefficients are the product of this package: small dense f32 linear
# algebra where TF32's ten-bit mantissa would quantize the discovered terms.
# Matmuls and convolutions run in full f32 (the JAX package pins
# jax_default_matmul_precision to float32 for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
# bf16 products (the --ae_dtype bf16 autoencoder) sum in f32, as the JAX
# package's bf16 dots with f32 accumulation do: no bf16 partial sums.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device. Raises when ``device`` is None and there is no CUDA
    device, so a run never moves to the CPU without the caller asking."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
