"""One LaLiGAN batch step in plain PyTorch, on parameters held as a dict of
tensors by the benchmark's own names (``names``).

The combined loss of one batch x (batch, n_comps, input_dim) and one
coefficient draw c (batch, channels):

    z       = encoder(x) in training mode (BatchNorm on the batch's mean and
              biased variance, eps 1e-5; the latent layer's weight the
              orthogonal factor of V)
    xhat    = decoder(z)
    zt      = g . (z - m) + m,  m the mean of z over batch and components,
              g = exp((c sigma) L) on every component's block, L = Li mask
    loss    = w_recon mean((xhat - x)^2) + w_gan bce(D(zt), 1)
              + w_reg_norm sum max(0, 0.5 - |L|^2)
              + (bce(D(z.detach()), 1) + bce(D(zt.detach()), 0)) / 2

with D the discriminator on the flattened latents and bce the binary
cross-entropy with its log clamped at -100; then one gradient and optax's
Adam on every trainable leaf (each group's learning rate).
"""

from __future__ import annotations

import numpy as np
import torch

BN_EPS = 1e-5
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def names(n_layers: int) -> dict:
    """The trainable leaves by group: {"ae": [...], "d": [...], "g": [...]}."""
    enc = [f"enc.{k}.{w}" for k in range(n_layers) for w in ("kernel", "bias")]
    enc += [f"enc.bn{k}.{w}" for k in range(n_layers) for w in ("scale", "bias")]
    enc += ["enc.out.V", "enc.out.bias", "enc.bnf.scale", "enc.bnf.bias"]
    dec = [f"dec.{k}.{w}" for k in range(n_layers + 1) for w in ("kernel", "bias")]
    disc = [f"disc.{k}.{w}" for k in range(n_layers + 1) for w in ("kernel", "bias")]
    return {"ae": enc + dec, "d": disc, "g": ["gen.Li", "gen.struct_const"]}


def _bn_train(h, scale, bias):
    f = h.shape[-1]
    hf = h.reshape(-1, f)
    mean, mean2 = hf.mean(0), (hf * hf).mean(0)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (h - mean) * (torch.rsqrt(var + BN_EPS) * scale) + bias


def _ortho(V):
    Q, R = torch.linalg.qr(V)
    return Q * torch.sign(torch.diagonal(R))[None, :]


def _bce(p, target: float):
    def log100(q):
        pos = q > 0
        safe = torch.where(pos, q, torch.ones_like(q))
        return torch.where(pos, torch.clamp(torch.log(safe), min=-100.0),
                           torch.full_like(q, -100.0))

    return -torch.mean(target * log100(p) + (1 - target) * log100(1 - p))


class Lassi:
    def __init__(self, args: dict):
        self.a = args
        self.n_layers = args["n_layers"]
        self.groups = names(self.n_layers)
        self.lr = {"ae": args["lr_ae"], "d": args["lr_d"], "g": args["lr_g"]}
        if args["use_original_x"] or args["include_sindy"] or args["keep_center"]:
            raise ValueError("the reference takes LaLiGAN without original x, joint SINDy "
                             "or keep_center")
        if args["coef_dist"] != "normal" or args["int_param"]:
            raise ValueError("the reference takes normal coefficients without int_param")

    def encoder(self, P, x):
        h = x
        for k in range(self.n_layers):
            h = h @ P[f"enc.{k}.kernel"] + P[f"enc.{k}.bias"]
            h = torch.relu(_bn_train(h, P[f"enc.bn{k}.scale"], P[f"enc.bn{k}.bias"]))
        h = h @ _ortho(P["enc.out.V"]) + P["enc.out.bias"]
        return _bn_train(h, P["enc.bnf.scale"], P["enc.bnf.bias"])

    def _mlp(self, P, prefix, h):
        for k in range(self.n_layers + 1):
            h = h @ P[f"{prefix}.{k}.kernel"] + P[f"{prefix}.{k}.bias"]
            if k < self.n_layers:
                h = torch.relu(h)
        return h

    def disc(self, P, z):
        return torch.sigmoid(self._mlp(P, "disc", z.reshape(z.shape[0], -1)))

    def transform(self, P, z, coef):
        m = z.mean(dim=(0, 1), keepdim=True)
        zc = z - m
        c = coef @ P["gen.sigma"]                       # (batch, channels)
        L = P["gen.Li"] * P["gen.mask"]                 # (channels, d, d)
        g = torch.linalg.matrix_exp(torch.einsum("bj,jkl->bkl", c, L))
        return torch.einsum("bij,bcj->bci", g, zc) + m  # every component's block

    def reg_norm(self, P):
        L = P["gen.Li"] * P["gen.mask"]
        return torch.clamp(0.5 - torch.einsum("kdf,kdf->k", L, L), min=0.0).sum()

    def loss(self, P, x, coef):
        a = self.a
        z = self.encoder(P, x)
        xhat = self._mlp(P, "dec", z)
        zt = self.transform(P, z, coef)
        loss = a["w_recon"] * torch.mean((xhat - x) ** 2)
        loss = loss + a["w_gan"] * _bce(self.disc(P, zt), 1.0)
        loss = loss + a["w_reg_norm"] * self.reg_norm(P)
        d_real = _bce(self.disc(P, z.detach()), 1.0)
        d_fake = _bce(self.disc(P, zt.detach()), 0.0)
        return loss + (d_real + d_fake) / 2

    def step(self, P: dict, opt: dict, x, coef):
        """(loss, {leaf: gradient}): one step, P and opt (per leaf mu, nu and
        the count) updated in place."""
        leaves = [n for g in self.groups.values() for n in g]
        with torch.enable_grad():
            Pg = {k: (v.detach().requires_grad_(True) if k in leaves else v)
                  for k, v in P.items()}
            loss = self.loss(Pg, x, coef)
            grads = torch.autograd.grad(loss, [Pg[n] for n in leaves], allow_unused=True)
        grads = {n: torch.zeros_like(P[n]) if g is None else g for n, g in zip(leaves, grads)}
        opt["count"] += 1
        t = np.int32(opt["count"])
        bc1 = float(np.float32(1) - np.float32(B1) ** t)
        bc2 = float(np.float32(1) - np.float32(B2) ** t)
        with torch.no_grad():
            for group, members in self.groups.items():
                for n in members:
                    g = grads[n]
                    mu = opt["mu"][n] * B1 + g * (1 - B1)
                    nu = opt["nu"][n] * B2 + (g * g) * (1 - B2)
                    opt["mu"][n], opt["nu"][n] = mu, nu
                    P[n] = P[n] + (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) * (-self.lr[group])
        return loss.detach(), grads

    def fresh_opt(self, P: dict) -> dict:
        leaves = [n for g in self.groups.values() for n in g]
        return {"count": 0, "mu": {n: torch.zeros_like(P[n]) for n in leaves},
                "nu": {n: torch.zeros_like(P[n]) for n in leaves}}
