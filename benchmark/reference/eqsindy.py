"""The EquivSINDy-r closure in plain PyTorch: the loss of every lane of a
chunk and its gradient in the lane's parameters, with the symmetry penalty
of the frozen LaLiGAN autoencoder, from the checkpoint's own arrays.

Per lane, with A = (Xi m)^T and Theta the SINDy library:

    loss = w_x mean((Theta(x) A - dx)^2) + w_sym pen [+ w_reg |theta|_1]
    pen  = sum over basis elements v of mean((iv - v_fx)^2) / mean(iv^2)

where fx and iv are the Euler endpoint of dq/dt = Theta(q) A from x after
int_t / int_dt steps and its derivative along v_x = J_dec(z_x) (v_11 z_x),
z = encode(.) - z_mean (z_mean the final BatchNorm's bias), and v_fx =
J_dec(z_fx) (v_22 z_fx + v_21 z_x). The encoder is evaluated layer by layer
with its eval-mode BatchNorms and the orthogonal factor of its latent layer;
the decoder's JVP is the tangent carried through its ReLU masks. Gradients
come from autograd, lanes in blocks so that the activations fit.
"""

from __future__ import annotations

import re

import torch

BN_EPS = 1e-5


def ortho(V):
    """The thin-QR factor of V with the signs of diag(R) folded in."""
    Q, R = torch.linalg.qr(V)
    return Q * torch.sign(torch.diagonal(R))[None, :]


def parse_learnable_repr(repr_str: str):
    """[(n_comps, n_channels, block_dim)] of a representation string made
    only of learnable blocks '(c,ch,d)'."""
    blocks = []
    for m in re.findall(r"\(([^()]*)\)", repr_str):
        parts = [p.strip() for p in m.split(",") if p.strip()]
        if len(parts) != 3:
            raise ValueError(f"the reference takes learnable blocks (c,ch,d) only, got ({m})")
        blocks.append(tuple(int(p) for p in parts))
    return blocks


def full_basis(generator: dict, mask: dict, repr_str: str):
    """One block-diagonal (n_dims, n_dims) basis element a channel, each
    block the channel's generator times its mask, repeated over the block's
    components."""
    blocks = parse_learnable_repr(repr_str)
    n_dims = sum(c * d for c, _, d in blocks)
    out, start = [], 0
    for i, (c, ch, d) in enumerate(blocks):
        L = generator["Li"][i] * mask[i]
        for j in range(ch):
            v = torch.zeros((n_dims, n_dims), dtype=L.dtype, device=L.device)
            for k in range(c):
                s = start + k * d
                v[s:s + d, s:s + d] = L[j]
            out.append(v)
        start += c * d
    return out


class Library:
    """Theta(q) in the program's term order: [1, q_i, q_i q_j (i <= j),
    q_i q_j q_k (i <= j <= k), sin q_i, exp q_i], and its derivative along t."""

    def __init__(self, dim: int, poly_order: int, include_sine: bool, include_exp: bool):
        self.dim, self.poly_order = dim, poly_order
        self.include_sine, self.include_exp = include_sine, include_exp
        d = dim
        self.pairs = [(i, j) for i in range(d) for j in range(i, d)] if poly_order > 1 else []
        self.triples = ([(i, j, k) for i in range(d) for j in range(i, d) for k in range(j, d)]
                        if poly_order > 2 else [])

    @property
    def n_terms(self) -> int:
        n = 1 + self.dim + len(self.pairs) + len(self.triples)
        return n + self.dim * (int(self.include_sine) + int(self.include_exp))

    def __call__(self, q):
        return self.jvp(q, None)[0]

    def jvp(self, q, t):
        cols = [torch.ones_like(q[..., :1]), q]
        tans = [torch.zeros_like(q[..., :1]), t] if t is not None else None
        for i, j in self.pairs:
            cols.append(q[..., i:i + 1] * q[..., j:j + 1])
            if t is not None:
                tans.append(t[..., i:i + 1] * q[..., j:j + 1] + q[..., i:i + 1] * t[..., j:j + 1])
        for i, j, k in self.triples:
            qi, qj, qk = q[..., i:i + 1], q[..., j:j + 1], q[..., k:k + 1]
            cols.append(qi * qj * qk)
            if t is not None:
                ti, tj, tk = t[..., i:i + 1], t[..., j:j + 1], t[..., k:k + 1]
                tans.append((ti * qj + qi * tj) * qk + qi * qj * tk)
        if self.include_sine:
            cols.append(torch.sin(q))
            if t is not None:
                tans.append(t * torch.cos(q))
        if self.include_exp:
            e = torch.exp(q)
            cols.append(e)
            if t is not None:
                tans.append(t * e)
        return torch.cat(cols, dim=-1), (torch.cat(tans, dim=-1) if t is not None else None)


class Closure:
    """The loss and gradient of a chunk's lanes. ``ckpt``: the checkpoint
    (reference/checkpoint.load); ``args``: the configuration's flags as a
    dict."""

    def __init__(self, ckpt: dict, args: dict, block_lanes: int = 10):
        if args["eq_constraint"] or args["sym_reg_type"] != "i":
            raise ValueError("the reference takes the unconstrained infinitesimal penalty only")
        p, bs = ckpt["autoencoder"]["params"], ckpt["autoencoder"]["batch_stats"]
        enc, ebs = p["encoder"], bs["encoder"]
        n_hidden = sum(1 for k in enc if k.startswith("Dense_"))
        self.enc = [(enc[f"Dense_{k}"]["kernel"], enc[f"Dense_{k}"]["bias"],
                     enc[f"BatchNorm_{k}"]["scale"], enc[f"BatchNorm_{k}"]["bias"],
                     ebs[f"BatchNorm_{k}"]["mean"], ebs[f"BatchNorm_{k}"]["var"])
                    for k in range(n_hidden)]
        self.enc_out = (ortho(enc["OrthoDense_0"]["V"]), enc["OrthoDense_0"]["bias"])
        self.bn_final = (enc["bn_final"]["scale"], enc["bn_final"]["bias"],
                         ebs["bn_final"]["mean"], ebs["bn_final"]["var"])
        self.z_mean = enc["bn_final"]["bias"]
        dec = p["decoder"]
        self.dec = [(dec[f"Dense_{k}"]["kernel"], dec[f"Dense_{k}"]["bias"])
                    for k in range(sum(1 for k in dec if k.startswith("Dense_")))]
        self.basis = full_basis(ckpt["generator"], ckpt["generator_mask"], args["repr"])
        self.latent = args["latent_dim"]
        self.lib = Library(self.latent, args["poly_order"], args["include_sine"],
                           args["include_exp"])
        self.n_steps, self.dt = int(args["int_t"] / args["int_dt"]), args["int_dt"]
        self.w_x, self.w_sym = args["w_sindy_x"], args["w_sym_reg"]
        self.w_reg = args["w_sindy_reg"] if args["sindy_reg_type"] == "l1" else 0.0
        self.l1 = args["sindy_reg_type"] == "l1"
        self.block = block_lanes

    @staticmethod
    def _bn(h, scale, bias, mean, var):
        return (h - mean) * torch.rsqrt(var + BN_EPS) * scale + bias

    def encode(self, x):
        """encode(x) - z_mean for x (..., input_dim)."""
        h = x
        for K, b, scale, bias, mean, var in self.enc:
            h = torch.relu(self._bn(h @ K + b, scale, bias, mean, var))
        Q, b = self.enc_out
        return self._bn(h @ Q + b, *self.bn_final) - self.z_mean

    def dec_jvp(self, z, u):
        """J_dec(z) u."""
        a, t = z, u
        last = len(self.dec) - 1
        for k, (K, b) in enumerate(self.dec):
            tq = t @ K
            if k < last:
                pre = a @ K + b
                a = torch.relu(pre)
                t = torch.where(pre > 0, tq, torch.zeros_like(tq))
            else:
                t = tq
        return t

    def euler_pair(self, x, v, A):
        q, tq = x, v
        for _ in range(self.n_steps):
            th, dth = self.lib.jvp(q, tq)
            q, tq = q + self.dt * (th @ A), tq + self.dt * (dth @ A)
        return q, tq

    def prep(self, x):
        """(z_x, [v_x per basis element]) of lanes x (L, k, dim)."""
        with torch.no_grad():
            z_x = self.encode(x)
            v_xs = [self.dec_jvp(z_x, z_x @ v[:self.latent, :self.latent].T) for v in self.basis]
        return z_x, v_xs

    def terms(self, theta, mask, x, dx, ctx):
        """(loss, penalty), each (L,), of lanes with parameters theta (L,
        n_params) and masks (L, d, p); differentiable in theta."""
        d, p = self.latent, self.lib.n_terms
        XiM = theta.reshape(-1, d, p) * mask
        A = XiM.mT
        mse = ((self.lib(x) @ A - dx) ** 2).mean(dim=(1, 2))
        z_x, v_xs = ctx
        lat = self.latent
        pen = 0.0
        for v, v_x in zip(self.basis, v_xs):
            fx, iv = self.euler_pair(x, v_x, A)
            z_fx = self.encode(fx)
            v_fx = self.dec_jvp(z_fx, z_fx @ v[lat:, lat:].T + z_x @ v[lat:, :lat].T)
            pen = pen + ((iv - v_fx) ** 2).mean(dim=(1, 2)) / (iv ** 2).mean(dim=(1, 2))
        loss = self.w_x * mse + self.w_sym * pen
        if self.l1:
            loss = loss + self.w_reg * theta.abs().sum(-1)
        return loss, pen

    def value_and_grad(self, theta, mask, x, dx, ctx):
        """(loss, penalty, gradient) of lanes, evaluated ``block`` lanes at a
        time."""
        losses, pens, grads = [], [], []
        z_x, v_xs = ctx
        for lo in range(0, theta.shape[0], self.block):
            sl = slice(lo, lo + self.block)
            th = theta[sl].detach().requires_grad_(True)
            with torch.enable_grad():
                loss, pen = self.terms(th, mask[sl], x[sl], dx[sl],
                                       (z_x[sl], [v[sl] for v in v_xs]))
                (g,) = torch.autograd.grad(loss.sum(), th)
            losses.append(loss.detach())
            pens.append(pen.detach())
            grads.append(g)
        return torch.cat(losses), torch.cat(pens), torch.cat(grads)
