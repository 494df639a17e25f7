"""The infinitesimal symmetry penalty of EquivSINDy-r, fast path with the
fused rollout, batched over lanes.

The port's counterpart of symmetry_ode_discovery_tpu/training/symmreg.py
``make_symmreg_i_fast`` with ``fused_rollout_lib`` (the path the CLI runs by
default). With the autoencoder and the generator frozen and the fit batch x
fixed per lane, everything evaluated at x is computed once per lane in
``prep``: z_x = encode(x) - z_mean and, per basis element v,
v_x = J_dec(z_x) (v_11 z_x). Every closure evaluation then costs one Euler
rollout-and-tangent pair, one encoder pass at the endpoint fx and one
decoder JVP at z_fx:

    fx, iv = euler_pair(x, v_x; Xi m)       (ops.integrators.make_euler_pair)
    v_fx   = J_dec(z_fx) (v_22 z_fx + v_21 z_x)
    loss  += mean((iv - v_fx)^2) / mean(iv^2)        per basis element

With ``pallas=True`` the encoder pass and the decoder JVP run through the
frozen-chain kernels (K2, K3: ops.symmpen.enc_apply and dec_jvp); without it
through autograd of the AutoEncoder module. ``ae_dtype=torch.bfloat16`` is
the reference's bf16 autoencoder: ``prep`` (z_x and the decoder Jacobian at
x) and the autograd path run a bf16 copy of the module
(``AutoEncoder.cast``: the OrthoDense factor stays f32, inputs are cast to
bf16 and outputs back to f32), and the kernels run their bf16 mode on the
folded f32 weights. The lanes of a chunk are stacked
along the row axis for those chains, so each closure makes one launch per
chain for the whole chunk; rows are independent, so this changes no number.
The composed closure path (--no_fused_rollout), symmreg_f and symmreg_r are
still to port. ``make_precompute_symmreg_r`` gives EquivGP-r its tables
g(x) and J_g(x).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import lie_generator as lg


def _resolve_z_mean(ae, normalize, z_mean):
    if normalize == "global" and z_mean is None:
        z_mean = ae.encoder_final_bias()
        if z_mean is None:
            raise ValueError("normalize='global' needs a BatchNorm final layer "
                             "or an explicit z_mean")
    return z_mean


def make_symmreg_i_fast(ae, spec, g_state, int_t: float, int_dt: float, z_mean=None,
                        relative: bool = True, ae_dtype=None, pallas: bool = False,
                        fused_rollout_lib=None):
    """(prep, penalty) of the infinitesimal symmetry loss, batched over
    lanes: ``prep(x)`` with x (lanes, k, dim) returns the per-lane context;
    ``penalty(XiM, x, ctx)`` with XiM (lanes, d, p) returns the per-lane
    penalty (lanes,). ``penalty.wants_coefs`` is True (the stepper passes the
    masked coefficients). ae: models.autoencoder.AutoEncoder, frozen and in
    eval mode."""
    from ..ops.integrators import make_euler_pair

    dtype = torch.float32 if ae_dtype is None else ae_dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ae_dtype must be float32 or bfloat16, got {ae_dtype}")
    if fused_rollout_lib is None:
        raise NotImplementedError(
            "the composed odeint + jvp closure (--no_fused_rollout) is not ported "
            "(ROADMAP item 7)")
    ae.requires_grad_(False).eval()
    with torch.no_grad():
        zm = _resolve_z_mean(ae, "global", z_mean).detach()
    ae_c = ae if dtype == torch.float32 else ae.cast(dtype)
    basis = [v.detach() for v in lg.get_full_basis_list(spec, g_state)]
    latent = ae.cfg.latent_dim

    def enc1(x):
        """z - z_mean for x (..., input_dim), through the module in ``dtype``."""
        return ae_c.encode(x.to(dtype)).float() - zm

    def dec1(z):
        return ae_c.decode(z.to(dtype)).float()
    for v in basis:
        if not np.allclose(v[:latent, latent:].cpu().numpy(), 0.0):
            raise ValueError("fused_rollout requires block-diagonal basis elements "
                             "(v_x must not depend on the rollout endpoint)")

    if pallas:
        from ..ops import symmpen

        enc_folded = symmpen.fold_encoder(ae, z_mean=zm)
        dec_folded = symmpen.fold_decoder(ae)

        def enc_rows(x):
            return symmpen.enc_apply(enc_folded, x, dtype)

        def dec_jvp_rows(z, u):
            return symmpen.dec_jvp(dec_folded, z, u, dtype)
    else:
        enc_rows = enc1

        def dec_jvp_rows(z, u):
            return torch.func.jvp(dec1, (z,), (u,))[1]

    def rows(fn, *ts):
        """Apply a row-wise chain to (lanes, k, c) tensors stacked as rows."""
        L, k = ts[0].shape[:2]
        out = fn(*[t.reshape(L * k, t.shape[-1]) for t in ts])
        return out.reshape(L, k, -1)

    n_steps = int(int_t / int_dt)
    lib = fused_rollout_lib

    def field_jvp(A):
        """The candidate field q -> Theta(q) A and its derivative along tq."""
        def f_and_tangent(q, tq):
            theta, dtheta = lib.jvp(q, tq)
            return theta @ A, dtheta @ A

        return f_and_tangent

    ep = make_euler_pair(field_jvp, n_steps, int_dt)

    def prep(x):
        """z_x and v_x per basis element, constant across the fit."""
        z_x = enc1(x)
        eye = torch.eye(latent, dtype=z_x.dtype, device=z_x.device)
        # decoder Jacobian columns J e_j at z_x, as the JAX package's jacfwd
        cols = [torch.func.jvp(dec1, (z_x,), (eye[j].expand_as(z_x),))[1]
                for j in range(latent)]
        Jd_x = torch.stack(cols, dim=-1)  # (lanes, k, dim, latent)
        v_xs = [torch.einsum("lbij,lbj->lbi", Jd_x, z_x @ v[:latent, :latent].T)
                for v in basis]
        return {"z_x": z_x, "v_xs": torch.stack(v_xs, dim=1)}  # (lanes, n_basis, k, dim)

    def penalty(XiM, x, ctx):
        z_x = ctx["z_x"]
        A = XiM.mT  # (lanes, p, d)
        loss = 0.0
        for i, v in enumerate(basis):
            fx, iv = ep(x, ctx["v_xs"][:, i], A)
            z_fx = rows(enc_rows, fx)
            v_z_fx = z_fx @ v[latent:, latent:].T + z_x @ v[latent:, :latent].T
            v_fx = rows(dec_jvp_rows, z_fx, v_z_fx)
            sq = ((iv - v_fx) ** 2).mean(dim=(1, 2))
            if relative:
                sq = sq / (iv ** 2).mean(dim=(1, 2))
            loss = loss + sq
        return loss

    penalty.wants_coefs = True
    return prep, penalty


def _group_transform(ae, g, x, z_mean):
    """g acting on data space through the autoencoder, 'global' z
    normalisation: decode(g (encode(x) - z_mean) + z_mean), component 0.
    The input is duplicated across the two components the encoder takes."""
    xx = torch.stack([x, x], dim=1)
    z = ae.encode(xx) - z_mean
    g_z = (z.reshape(z.shape[0], -1) @ g.T).reshape(z.shape) + z_mean
    return ae.decode(g_z)[:, 0]


def make_precompute_symmreg_r(ae, spec, g_state, z_mean=None, scale: float = 0.01):
    """``precompute(x) -> (gx_list, Jgx_list)``: per deterministic group
    element g = exp(0.01 sigma L), g(x) (N, d) and its Jacobian in x,
    J_g(x) (N, d, d) with J[n, i, j] = d g(x)_i / d x_j, for x (N, d). The
    Jacobian is d JVPs along the unit vectors (rows are independent: the
    frozen autoencoder runs in eval mode)."""
    ae.requires_grad_(False).eval()
    with torch.no_grad():
        zm = _resolve_z_mean(ae, "global", z_mean).detach()
    g_list = [g.detach() for g in lg.get_deterministic_group_elems(spec, g_state, scale=scale)]

    def precompute(x):
        gx_list, Jgx_list = [], []
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        for g in g_list:
            gt = lambda xx, g=g: _group_transform(ae, g, xx, zm)
            with torch.no_grad():
                gx_list.append(gt(x))
            cols = [torch.func.jvp(gt, (x,), (eye[j].expand_as(x),))[1]
                    for j in range(x.shape[-1])]
            Jgx_list.append(torch.stack(cols, dim=-1).detach())
        return gx_list, Jgx_list

    return precompute
