"""Neural building blocks: MLP encoder/decoder with optional BatchNorm and an
orthogonally parameterised final layer, as ``nn.Module``s.

The port's copy of symmetry_ode_discovery_tpu/models/mlp.py (EncoderMLP,
DecoderMLP, OrthoDense, get_activation). Layouts are torch's: a ``Linear``
keeps its weight as (out, in). ``OrthoDense`` keeps the free factor ``V`` as
(in, out), the JAX package's layout, because its weight is the thin-QR factor
of V and not V itself.

BatchNorm runs in eval mode only (running statistics, eps 1e-5): the port
uses the autoencoder frozen; LaLiGAN training is still to port.

Mixed dtypes promote as flax's do (models.autoencoder.AutoEncoder.cast: a
bf16 copy with the OrthoDense factor kept f32): ``OrthoDense`` multiplies a
bf16 input by its f32 factor in f32, and ``EvalBatchNorm`` normalises
(x - mean) * (rsqrt(var + eps) * scale) + bias in the promoted dtype of its
operands, the order of flax's ``_normalize``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name: str, args: Sequence[float] = ()) -> Callable:
    """torch-style activation names with their constructor arguments
    (ELU alpha, Softplus beta and threshold, LeakyReLU slope)."""
    a0 = args[0] if args else None
    table = {
        "ReLU": lambda: torch.relu,
        "Tanh": lambda: torch.tanh,
        "Sigmoid": lambda: torch.sigmoid,
        "ELU": lambda: (lambda x: F.elu(x, 1.0 if a0 is None else a0)),
        "SiLU": lambda: F.silu,
        "GELU": lambda: F.gelu,
        "Softplus": lambda: (lambda x: F.softplus(
            x, 1.0 if a0 is None else a0, args[1] if len(args) > 1 else 20.0)),
        "LeakyReLU": lambda: (lambda x: F.leaky_relu(x, 0.01 if a0 is None else a0)),
    }
    if name not in table:
        raise ValueError(f"Unknown activation: {name}")
    if args and name in ("ReLU", "Tanh", "Sigmoid", "SiLU", "GELU"):
        raise ValueError(f"activation {name} takes no activation_args")
    return table[name]()


class EvalBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis with running statistics, for inputs of
    any rank (..., features): the statistics are per feature, as flax's
    BatchNorm keeps them."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x):
        if x.dtype != torch.float32 or self.weight.dtype != torch.float32:
            y = x - self.running_mean
            y = y * (torch.rsqrt(self.running_var + self.eps) * self.weight)
            return y + self.bias
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), self.running_mean, self.running_var,
                         self.weight, self.bias, training=False, eps=self.eps)
        return y.reshape(shape)


def ortho_weight(V: torch.Tensor) -> torch.Tensor:
    """(in, out) matrix with orthonormal columns: the thin-QR factor of V with
    the signs of diag(R) folded in, which makes it unique."""
    Q, R = torch.linalg.qr(V)
    return Q * torch.sign(torch.diagonal(R))[None, :]


class OrthoDense(nn.Module):
    """y = x @ Q + b with Q = ortho_weight(V) (out_dim <= in_dim)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.V = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        Q = ortho_weight(self.V)
        dt = torch.promote_types(x.dtype, Q.dtype)
        return x.to(dt) @ Q.to(dt) + self.bias


class EncoderMLP(nn.Module):
    """n_layers hidden Linear blocks, BatchNorm after every Linear including
    the latent one when batch_norm, optional orthogonal latent layer."""

    def __init__(self, input_dim: int, hidden_dim: int, latent_dim: int, n_layers: int,
                 activation: str = "ReLU", activation_args: Sequence[float] = (),
                 batch_norm: bool = False, ortho: bool = False):
        super().__init__()
        self.act = get_activation(activation, activation_args)
        dims = [input_dim] + [hidden_dim] * n_layers
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.bn = nn.ModuleList(EvalBatchNorm(hidden_dim) for _ in range(n_layers)) \
            if batch_norm else None
        self.out = OrthoDense(dims[-1], latent_dim) if ortho else nn.Linear(dims[-1], latent_dim)
        self.bn_final = EvalBatchNorm(latent_dim) if batch_norm else None

    def forward(self, x):
        for k, layer in enumerate(self.dense):
            x = layer(x)
            if self.bn is not None:
                x = self.bn[k](x)
            x = self.act(x)
        x = self.out(x)
        if self.bn_final is not None:
            x = self.bn_final(x)
        return x


class DecoderMLP(nn.Module):
    """n_layers hidden Linear blocks and a Linear output layer."""

    def __init__(self, latent_dim: int, hidden_dim: int, output_dim: int, n_layers: int,
                 activation: str = "ReLU", activation_args: Sequence[float] = ()):
        super().__init__()
        self.act = get_activation(activation, activation_args)
        dims = [latent_dim] + [hidden_dim] * n_layers + [output_dim]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.dense[:-1]:
            x = self.act(layer(x))
        return self.dense[-1](x)
