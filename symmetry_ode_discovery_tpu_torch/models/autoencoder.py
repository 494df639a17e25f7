"""AutoEncoder: the MLP encoder/decoder pair as an ``nn.Module``.

The port's copy of symmetry_ode_discovery_tpu/models/autoencoder.py for
ae_arch 'mlp' and 'none' (the identity). Equation discovery applies it in
eval mode, frozen, with weights from a checkpoint
(``convert.laligan_from_npz``); LaLiGAN training calls ``forward(x,
train=True)``, whose BatchNorms normalise by the batch's statistics and move
their running statistics (models/mlp.py). 'mlp_split', compute_dz,
compute_dx and iga are still to port.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .mlp import DecoderMLP, EncoderMLP, OrthoDense


@dataclasses.dataclass(frozen=True)
class AutoEncoderConfig:
    ae_arch: str = "mlp"
    input_dim: int = 2
    hidden_dim: int = 512
    latent_dim: int = 2
    n_layers: int = 5
    n_comps: int = 1
    activation: str = "ReLU"
    activation_args: Tuple[float, ...] = ()
    batch_norm: bool = False
    ortho_ae: bool = False


class AutoEncoder(nn.Module):
    def __init__(self, cfg: AutoEncoderConfig):
        super().__init__()
        if cfg.ae_arch not in ("mlp", "none"):
            raise NotImplementedError(
                f"ae_arch {cfg.ae_arch!r}: only 'mlp' and 'none' are ported (ROADMAP item 7)")
        self.cfg = cfg
        if cfg.ae_arch == "none":  # the identity: data-space discovery without an AE
            self.encoder = self.decoder = None
            return
        self.encoder = EncoderMLP(cfg.input_dim, cfg.hidden_dim, cfg.latent_dim, cfg.n_layers,
                                  cfg.activation, cfg.activation_args, cfg.batch_norm,
                                  cfg.ortho_ae)
        self.decoder = DecoderMLP(cfg.latent_dim, cfg.hidden_dim, cfg.input_dim, cfg.n_layers,
                                  cfg.activation, cfg.activation_args)

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """z for x (..., input_dim); BatchNorm on the batch's statistics, and
        its running statistics updated, when ``train``."""
        return x if self.encoder is None else self.encoder(x, train)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return z if self.decoder is None else self.decoder(z)

    def forward(self, x: torch.Tensor, train: bool = False):
        """(z, xhat) for x, as ``encode`` and ``decode``."""
        z = self.encode(x, train)
        return z, self.decode(z)

    def cast(self, dtype: torch.dtype) -> "AutoEncoder":
        """A copy whose Dense weights and biases and BatchNorm statistics and
        affines are in ``dtype``, the OrthoDense factor V kept in f32, as the
        JAX package's ``make_symmreg_i_fast`` casts the frozen autoencoder
        for --ae_dtype bf16 (QR has no bf16 kernel). Its encode and decode
        take inputs in ``dtype``."""
        out = copy.deepcopy(self).to(dtype)
        if self.encoder is not None and isinstance(out.encoder.out, OrthoDense):
            out.encoder.out.V.data = self.encoder.out.V.detach().clone()
        return out

    def encoder_final_bias(self) -> Optional[torch.Tensor]:
        """The z-mean of 'global' normalisation in the symmetry losses: the
        final BatchNorm's bias, or None without BatchNorm."""
        if self.encoder is None or self.encoder.bn_final is None:
            return None
        return self.encoder.bn_final.bias
