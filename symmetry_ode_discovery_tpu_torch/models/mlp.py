"""Neural building blocks: MLP encoder/decoder with optional BatchNorm and an
orthogonally parameterised final layer, as ``nn.Module``s.

The port's copy of symmetry_ode_discovery_tpu/models/mlp.py (EncoderMLP,
DecoderMLP, OrthoDense, get_activation, and ae_arch 'mlp_split''s
SplitEncoder and SplitDecoder). Layouts are torch's: a ``Linear``
keeps its weight as (out, in). ``OrthoDense`` keeps the free factor ``V`` as
(in, out), the JAX package's layout, because its weight is the thin-QR factor
of V and not V itself.

BatchNorm (eps 1e-5) normalises by its running statistics unless a
forward is called with ``train=True``: then it normalises by the batch's
statistics as flax's BatchNorm does (mean and the biased "fast" variance
max(0, E[x^2] - E[x]^2) over every axis but the last) and moves the running
statistics towards them with flax's momentum 0.9, the same biased variance
included (``torch.nn.BatchNorm1d`` would use the unbiased one). With
``dp`` set (a parallel/dp.DataParallel; the trainer sets it on a rank of
data-parallel training) the batch's
statistics are the global batch's: the ranks' sums of x and x^2 and their
row counts all-reduced in one differentiable collective. Parameters
start as flax's initialisers make them (``init_flax_``): ``lecun_normal``
kernels, zero biases.

Mixed dtypes promote as flax's do (models.autoencoder.AutoEncoder.cast: a
bf16 copy with the OrthoDense factor kept f32): ``OrthoDense`` multiplies a
bf16 input by its f32 factor in f32, and ``BatchNorm`` normalises
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


# flax's lecun_normal: a normal truncated at two standard deviations whose
# standard deviation is sqrt(1 / fan_in) over the truncation's own (0.8796)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator = None):
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def init_flax_(module: nn.Module, generator: torch.Generator = None) -> nn.Module:
    """Initialise every ``Linear`` and ``OrthoDense`` of ``module`` as flax's
    Dense is (lecun_normal kernel over its fan-in, zero bias) and every
    BatchNorm with unit scale, zero bias and statistics 0 and 1, in module
    order from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, OrthoDense):
            lecun_normal_(m.V, m.V.shape[0], generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return module


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis for inputs of any rank (..., features),
    the statistics per feature as flax keeps them: running statistics by
    default, the batch's with ``train=True`` (see the module docstring)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)
        self.dp = None

    def forward(self, x, train: bool = False):
        if train:
            xf = x.reshape(-1, x.shape[-1]).to(torch.promote_types(x.dtype, torch.float32))
            if self.dp is None:
                mean, mean2 = xf.mean(0), (xf * xf).mean(0)
            else:
                f = xf.shape[-1]
                tot = self.dp.sum(torch.cat([xf.sum(0), (xf * xf).sum(0),
                                             xf.new_full((1,), xf.shape[0])]))
                mean, mean2 = tot[:f] / tot[-1], tot[f:2 * f] / tot[-1]
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + (1.0 - 0.9) * mean)
                self.running_var.copy_(0.9 * self.running_var + (1.0 - 0.9) * var)
            return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
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
        self.bn = nn.ModuleList(BatchNorm(hidden_dim) for _ in range(n_layers)) \
            if batch_norm else None
        self.out = OrthoDense(dims[-1], latent_dim) if ortho else nn.Linear(dims[-1], latent_dim)
        self.bn_final = BatchNorm(latent_dim) if batch_norm else None

    def forward(self, x, train: bool = False):
        for k, layer in enumerate(self.dense):
            x = layer(x)
            if self.bn is not None:
                x = self.bn[k](x, train)
            x = self.act(x)
        x = self.out(x)
        if self.bn_final is not None:
            x = self.bn_final(x, train)
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


class SplitEncoder(nn.Module):
    """Two EncoderMLPs, ``model1`` on the first input_dim // 2 features and
    ``model2`` on the rest, each giving half the latent, concatenated (the
    JAX package's SplitEncoder: with the full latent each, the
    concatenation would not fit the decoder)."""

    def __init__(self, input_dim: int, hidden_dim: int, latent_dim: int, n_layers: int,
                 activation: str = "ReLU", activation_args: Sequence[float] = (),
                 batch_norm: bool = False, ortho: bool = False):
        super().__init__()
        if latent_dim % 2:
            raise ValueError("mlp_split needs an even latent_dim")
        h = input_dim // 2
        kw = dict(hidden_dim=hidden_dim, latent_dim=latent_dim // 2, n_layers=n_layers,
                  activation=activation, activation_args=activation_args,
                  batch_norm=batch_norm, ortho=ortho)
        self.h = h
        self.model1 = EncoderMLP(h, **kw)
        self.model2 = EncoderMLP(input_dim - h, **kw)
        # the z-mean of 'global' normalisation reads the encoder's final
        # BatchNorm; a split encoder has two, which that loss does not use
        self.bn_final = None

    def forward(self, x, train: bool = False):
        return torch.cat([self.model1(x[..., :self.h], train),
                          self.model2(x[..., self.h:], train)], dim=-1)


class SplitDecoder(nn.Module):
    """Two DecoderMLPs, each reconstructing half the output from half the
    latent, concatenated."""

    def __init__(self, latent_dim: int, hidden_dim: int, output_dim: int, n_layers: int,
                 activation: str = "ReLU", activation_args: Sequence[float] = ()):
        super().__init__()
        if output_dim % 2:
            raise ValueError("mlp_split needs an even output_dim")
        self.h = latent_dim // 2
        kw = dict(hidden_dim=hidden_dim, output_dim=output_dim // 2, n_layers=n_layers,
                  activation=activation, activation_args=activation_args)
        self.model1 = DecoderMLP(self.h, **kw)
        self.model2 = DecoderMLP(latent_dim - self.h, **kw)

    def forward(self, x):
        return torch.cat([self.model1(x[..., :self.h]), self.model2(x[..., self.h:])], dim=-1)
