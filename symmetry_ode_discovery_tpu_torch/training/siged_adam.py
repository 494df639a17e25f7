"""SINDy equation discovery by Adam over minibatches.

The port's counterpart of symmetry_ode_discovery_tpu/training/siged_adam.py
(the JAX CLI's default --sindy_optimizer adam). Per batch: the prediction
loss (data space, or latent space through the frozen autoencoder's JVPs),
an optional symmetry penalty (the composed hook of
``training.siged.make_sym_reg_fn`` in data space; the per-basis
infinitesimal penalty in the latent space) and L1; sequential thresholding
every ``st_freq`` epochs.

Adam is torch's (``torch.optim.Adam``) with optax's defaults: b1 0.9, b2
0.999, eps 1e-8 added to the bias-corrected sqrt(v), no eps_root. torch's
update lr (m / (1 - b1^t)) / (sqrt(v) / sqrt(1 - b2^t) + eps) is optax's
lr m_hat / (sqrt(v_hat) + eps) with the factors taken in another order.

The parameters are one flat vector theta: vec(Xi) row-major, or [beta,
const] under the constraint (``training.siged._make_param_fns``), updated
element by element as optax updates each leaf. Draws: ``init(gen)`` draws
theta0 standard normal, each epoch a permutation of the rows, cut to
n_batches * bs rows with bs = min(batch_size, n); ``train_siged_adam``
takes a fed theta0 and fed per-epoch permutations instead (the JAX
package's draws, for a replay).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .siged import _make_param_fns


@dataclasses.dataclass(frozen=True)
class AdamHParams:
    num_epochs: int = 1000
    batch_size: int = 256
    lr_sindy: float = 1e-3
    w_sindy_z: float = 1e-3
    w_sindy_x: float = 1e-1
    w_sindy_reg: float = 1e-1
    sindy_reg_type: str = "l1"
    w_sym_reg: float = 0.0
    st_freq: int = 100
    threshold: float = 0.1
    use_latent: bool = False


class SIGEDAdamTrainer:
    """use_latent=False: dx_pred = Theta(x) Xi^T (+ the composed symmetry
    hook ``sym_reg_fn(forward_fn, x)``). use_latent=True: the regressor acts
    on z = encode(x), with the decode-JVP data loss and the per-basis
    infinitesimal penalty sum((J_f(z) v z - v dz_pred)^2); ``latent_fns``
    holds 'encode', 'compute_dz' and 'compute_dx' (the frozen autoencoder's
    maps), ``basis_list`` the Lie basis."""

    def __init__(self, cfg, Q, hp: AdamHParams, sym_reg_fn: Optional[Callable] = None,
                 latent_fns: Optional[dict] = None, basis_list=None):
        self.cfg, self.hp = cfg, hp
        self.sym_reg_fn = sym_reg_fn
        self.latent_fns = latent_fns or {}
        self.basis_list = tuple(basis_list) if basis_list else ()
        self.n_params, self.groups, xi_of = _make_param_fns(cfg, Q)
        self.xi_of = lambda theta: xi_of(theta[None])[0]

    def init(self, gen: torch.Generator):
        """(theta, mask, optimizer): theta0 standard normal from ``gen``, on
        its device."""
        return self.start(torch.randn(self.n_params, generator=gen, device=gen.device))

    def start(self, theta0: torch.Tensor):
        """(theta, mask, optimizer) from a given theta0 (n_params,), in its
        dtype."""
        theta = theta0.detach().clone().requires_grad_(True)
        mask = torch.ones((self.cfg.latent_dim, self.cfg.n_terms), dtype=theta.dtype,
                          device=theta.device)
        opt = torch.optim.Adam([theta], lr=self.hp.lr_sindy, betas=(0.9, 0.999), eps=1e-8)
        return theta, mask, opt

    def loss_fn(self, theta, mask, x, dx):
        """(loss, metrics) of one batch; metrics are detached scalars."""
        hp, lib = self.hp, self.cfg.library
        Xi = self.xi_of(theta) * mask
        metrics = {}
        if hp.use_latent:
            with torch.no_grad():
                z = self.latent_fns["encode"](x)
                dz = self.latent_fns["compute_dz"](x, dx)
            dz_pred = lib(z) @ Xi.T
            dx_pred = self.latent_fns["compute_dx"](z, dz_pred)
            loss_z = ((dz_pred - dz) ** 2).mean()
            loss_x = ((dx_pred - dx) ** 2).mean()
            metrics["loss_sindy_z"], metrics["loss_sindy_x"] = loss_z, loss_x
            loss = hp.w_sindy_z * loss_z + hp.w_sindy_x * loss_x
            if hp.w_sym_reg > 0.0 and self.basis_list:
                sym = 0.0
                for v in self.basis_list:
                    jv = torch.func.jvp(lambda zz: lib(zz) @ Xi.T, (z,), (z @ v.T,))[1]
                    sym = sym + ((jv - dz_pred @ v.T) ** 2).sum()
                metrics["loss_sym_reg"] = sym
                loss = loss + hp.w_sym_reg * sym
        else:
            loss_x = ((lib(x) @ Xi.T - dx) ** 2).mean()
            metrics["loss_sindy_x"] = loss_x
            loss = hp.w_sindy_x * loss_x
            if hp.w_sym_reg > 0.0 and self.sym_reg_fn is not None:
                sym = self.sym_reg_fn(lambda q: lib(q) @ Xi.T, x)
                metrics["loss_sym_reg"] = sym
                loss = loss + hp.w_sym_reg * sym
        if hp.sindy_reg_type == "l1":
            l1 = sum(theta[i:j].abs().sum() for i, j in self.groups)
            metrics["loss_sindy_reg"] = l1
            loss = loss + hp.w_sindy_reg * l1
        return loss, {k: v.detach() for k, v in metrics.items()}

    def batches(self, perm: torch.Tensor, n: int) -> torch.Tensor:
        """An epoch's (n_batches, bs) row indices from a permutation of the n
        rows: cut to n_batches * bs, bs = min(batch_size, n)."""
        bs = min(self.hp.batch_size, n)
        n_batches = n // bs
        return perm[:n_batches * bs].reshape(n_batches, bs)

    def epoch(self, theta, mask, opt, x, dx, perm):
        """One epoch over the batches of ``perm``; returns the metrics'
        means over the batches (tensors)."""
        sums = {}
        idx_all = self.batches(perm.to(x.device), x.shape[0])
        for idx in idx_all:
            opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss, metrics = self.loss_fn(theta, mask, x[idx], dx[idx])
                loss.backward()
            opt.step()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        return {k: v / idx_all.shape[0] for k, v in sums.items()}

    def threshold(self, theta, mask):
        with torch.no_grad():
            Xi = self.xi_of(theta)
            return ((Xi.abs() > self.hp.threshold) & (mask > 0)).to(mask.dtype)


def train_siged_adam(trainer: SIGEDAdamTrainer, x, dx, seed: int = 0, verbose=False,
                     log_interval=1, theta0=None, perms=None, epoch_hook=None):
    """Train on all rows (x, dx (n, dim)); returns (Xi, mask, history).
    Draws from ``torch.Generator(x.device)``: theta0 from seed 2 seed + 1,
    the permutations from seed 2 seed, unless ``theta0`` (n_params,) and
    ``perms`` (a sequence of num_epochs permutations of range(n)) are
    given. ``epoch_hook(epoch, theta, mask, metrics)`` runs after each
    epoch's thresholding."""
    from .sweep import _generator

    hp = trainer.hp
    dev = x.device
    if theta0 is None:
        theta, mask, opt = trainer.init(_generator(seed, 1, dev))
    else:
        theta, mask, opt = trainer.start(torch.as_tensor(theta0, dtype=x.dtype, device=dev))
    if perms is not None and len(perms) < hp.num_epochs:
        raise ValueError(f"{len(perms)} fed permutations for {hp.num_epochs} epochs")
    gen = _generator(seed, 0, dev)
    history = []
    for epoch in range(hp.num_epochs):
        perm = (torch.as_tensor(np.array(perms[epoch]), dtype=torch.long, device=dev) if perms is not None
                else torch.randperm(x.shape[0], generator=gen, device=dev))
        metrics = trainer.epoch(theta, mask, opt, x, dx, perm)
        if hp.st_freq > 0 and (epoch + 1) % hp.st_freq == 0:
            mask = trainer.threshold(theta, mask)
        history.append({k: float(v) for k, v in metrics.items()})
        if epoch_hook is not None:
            epoch_hook(epoch, theta, mask, history[-1])
        if verbose and (epoch + 1) % log_interval == 0:
            print(", ".join([f"Epoch {epoch}"] +
                            [f"{k}: {v:.4f}" for k, v in history[-1].items()]))
    return trainer.xi_of(theta).detach(), mask, history
