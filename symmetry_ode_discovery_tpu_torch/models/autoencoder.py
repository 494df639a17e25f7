"""AutoEncoder: the MLP encoder/decoder pair as an ``nn.Module``.

The port's copy of symmetry_ode_discovery_tpu/models/autoencoder.py for
ae_arch 'mlp', 'mlp_split' (twin halves, models/mlp.py) and 'none' (the
identity). Equation discovery applies it in eval mode, frozen, with weights
from a checkpoint (``convert.laligan_from_npz``); LaLiGAN training calls
``forward(x, train=True)``, whose BatchNorms normalise by the batch's
statistics and move their running statistics (models/mlp.py).

The pushforwards are JVPs (``torch.func.jvp``): ``compute_dz`` of the
encoder in eval mode, ``compute_dx`` of the decoder, and ``iga``, the
infinitesimal group action g z pushed through the decoder. Their tangents
are differentiable with respect to the parameters (the joint SINDy loss
back-propagates through them). ``compute_dz`` and ``encode`` take the
running statistics to use (``stats``, from ``stats()``): the joint loss
reads the statistics its step started from, while the train-mode forward
of the same step moves the module's own in place.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .mlp import DecoderMLP, EncoderMLP, OrthoDense, SplitDecoder, SplitEncoder


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
        archs = {"mlp": (EncoderMLP, DecoderMLP), "mlp_split": (SplitEncoder, SplitDecoder)}
        if cfg.ae_arch not in archs and cfg.ae_arch != "none":
            raise ValueError(f"Unknown ae_arch: {cfg.ae_arch}")
        self.cfg = cfg
        if cfg.ae_arch == "none":  # the identity: data-space discovery without an AE
            self.encoder = self.decoder = None
            return
        enc, dec = archs[cfg.ae_arch]
        self.encoder = enc(cfg.input_dim, cfg.hidden_dim, cfg.latent_dim, cfg.n_layers,
                           cfg.activation, cfg.activation_args, cfg.batch_norm, cfg.ortho_ae)
        self.decoder = dec(cfg.latent_dim, cfg.hidden_dim, cfg.input_dim, cfg.n_layers,
                           cfg.activation, cfg.activation_args)

    def stats(self) -> dict:
        """A copy of the encoder's running statistics, by buffer name."""
        if self.encoder is None:
            return {}
        return {k: v.detach().clone() for k, v in self.encoder.named_buffers()}

    def encode(self, x: torch.Tensor, train: bool = False, stats: dict = None) -> torch.Tensor:
        """z for x (..., input_dim); BatchNorm on the batch's statistics, and
        its running statistics updated, when ``train``; in eval mode on
        ``stats`` (from ``stats()``) when given, else the module's own."""
        if self.encoder is None:
            return x
        if stats:
            return torch.func.functional_call(self.encoder, stats, (x,), {"train": train})
        return self.encoder(x, train)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return z if self.decoder is None else self.decoder(z)

    def forward(self, x: torch.Tensor, train: bool = False):
        """(z, xhat) for x, as ``encode`` and ``decode``."""
        z = self.encode(x, train)
        return z, self.decode(z)

    def compute_dz(self, x: torch.Tensor, dx: torch.Tensor, stats: dict = None) -> torch.Tensor:
        """dz = J_enc(x) dx, the encoder in eval mode (on ``stats`` when
        given)."""
        if self.encoder is None:
            return dx
        return torch.func.jvp(lambda xx: self.encode(xx, False, stats), (x,), (dx,))[1]

    def compute_dx(self, z: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
        """dx = J_dec(z) dz."""
        if self.decoder is None:
            return dz
        return torch.func.jvp(self.decoder, (z,), (dz,))[1]

    def iga(self, g: torch.Tensor, x: torch.Tensor, normalize_z: bool = True) -> torch.Tensor:
        """The infinitesimal group action in data space: J_dec(z) (g z) for
        z the eval-mode encoding of x (centred over the batch when
        ``normalize_z``), g acting on each row's flattened latent."""
        z = self.encode(x)
        if normalize_z:
            z = z - z.mean(dim=0, keepdim=True)
        v_z = torch.einsum("jk,bk->bj", g, z.reshape(z.shape[0], -1)).reshape(z.shape)
        return torch.func.jvp(self.decode, (z,), (v_z,))[1]

    def cast(self, dtype: torch.dtype) -> "AutoEncoder":
        """A copy whose Dense weights and biases and BatchNorm statistics and
        affines are in ``dtype``, the OrthoDense factor V kept in f32, as the
        JAX package's ``make_symmreg_i_fast`` casts the frozen autoencoder
        for --ae_dtype bf16 (QR has no bf16 kernel). Its encode and decode
        take inputs in ``dtype``."""
        out = copy.deepcopy(self).to(dtype)
        if self.encoder is not None:
            for mine, theirs in zip(self.encoder.modules(), out.encoder.modules()):
                if isinstance(mine, OrthoDense):
                    theirs.V.data = mine.V.detach().clone()
        return out

    def encoder_final_bias(self) -> Optional[torch.Tensor]:
        """The z-mean of 'global' normalisation in the symmetry losses: the
        final BatchNorm's bias, or None without BatchNorm."""
        if self.encoder is None or self.encoder.bn_final is None:
            return None
        return self.encoder.bn_final.bias
