"""Discriminator: an MLP to a sigmoid on the flattened latent vectors, with an
optional label embedding and the original x concatenated.

The port's copy of symmetry_ode_discovery_tpu/models/discriminator.py. flax
infers the first layer's width from its input; here it is given: the
flattened latent, plus the label's width (``y_embed_dim`` with ``embed_y``,
else ``y_dim``), plus the flattened x's (``x_dim``) when the caller passes
them. Initialise with ``models.mlp.init_flax_`` for flax's initialisers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .mlp import get_activation


class Discriminator(nn.Module):
    def __init__(self, z_dim: int, hidden_dim: int = 512, n_layers: int = 5,
                 activation: str = "ReLU", activation_args: Sequence[float] = (),
                 embed_y: bool = False, y_classes: int = 2, y_embed_dim: int = 16,
                 y_dim: int = 0, x_dim: int = 0):
        super().__init__()
        self.act = get_activation(activation, activation_args)
        self.embed = nn.Embedding(y_classes, y_embed_dim) if embed_y else None
        in_dim = z_dim + (y_embed_dim if embed_y else y_dim) + x_dim
        dims = [in_dim] + [hidden_dim] * n_layers + [1]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, z: torch.Tensor, y: Optional[torch.Tensor] = None,
                x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(batch, 1) probabilities for z (batch, ...)."""
        h = z.reshape(z.shape[0], -1)
        if y is not None:
            if self.embed is not None:
                y = self.embed(y)
            h = torch.cat([h, y], dim=-1)
        if x is not None:
            h = torch.cat([h, x.reshape(x.shape[0], -1)], dim=-1)
        for layer in self.dense[:-1]:
            h = self.act(layer(h))
        return torch.sigmoid(self.dense[-1](h))
