"""Symmetry-regularization losses for equation discovery (EquivSINDy-r,
EquivGP-r).

The port's counterpart of symmetry_ode_discovery_tpu/training/symmreg.py.

The composed losses, on one lane (the JAX package's functions, with the
frozen ``AutoEncoder`` in place of its definition, parameters and
statistics):
- ``symmreg_i``: infinitesimal, || J_f(x) v_x - v_{f(x)} ||^2 per Lie basis
  element, v pushed through the decoder by a JVP;
- ``symmreg_f``: finite, || f(g.x) - g.f(x) ||^2 per deterministic group
  element;
- ``symmreg_r``: reversed, for an ODE h, || J_g(x) h(x) - h(g.x) ||^2;
- ``precompute_symmreg_r``: g(x) and J_g(x) tables for decoupled engines.
JVPs are ``torch.func.jvp``, differentiable in the parameters of f or h by
autograd. z normalisation 'global' subtracts the encoder's final BatchNorm
bias when no z_mean is given.

The fast path of the infinitesimal loss, batched over lanes
(``make_symmreg_i_fast``): with the autoencoder and the generator frozen and
the fit batch x fixed per lane, everything evaluated at x is computed once
per lane in ``prep``: z_x = encode(x) - z_mean, the decoder Jacobian at z_x
and, per basis element v, v_x = J_dec(z_x) (v_11 z_x). With the fused
rollout (``fused_rollout_lib``, the CLI's default) every closure evaluation
costs one Euler rollout-and-tangent pair, one encoder pass at the endpoint
fx and one decoder JVP at z_fx:

    fx, iv = euler_pair(x, v_x; Xi m)       (ops.integrators.make_euler_pair)
    v_fx   = J_dec(z_fx) (v_22 z_fx + v_21 z_x)
    loss  += mean((iv - v_fx)^2) / mean(iv^2)        per basis element

Without it (--no_fused_rollout, or a basis that is not block-diagonal)
the penalty takes the candidate field as a closure and differentiates the
Euler rollout by ``torch.func.jvp`` of ``odeint``.

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
``make_precompute_symmreg_r`` gives EquivGP-r its tables g(x) and J_g(x).
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


def _z_shift(ae, z, normalize, z_mean):
    """(z - shift, shift) for a z normalisation: 'in_batch' the batch mean,
    'global' the z-mean (the final BatchNorm bias unless given), else 0."""
    if normalize == "in_batch":
        zm = z.mean(dim=0, keepdim=True)
    elif normalize == "global":
        zm = _resolve_z_mean(ae, normalize, z_mean)
    else:
        return z, 0.0
    return z - zm, zm


def _act(m, z):
    """m acting on each row's flattened latent (all components)."""
    return (z.reshape(z.shape[0], -1) @ m.T).reshape(z.shape)


def symmreg_i(ae, spec, g_state, x_fx: torch.Tensor, f=None, dfdx=None,
              normalize: str = "global", z_mean=None, relative: bool = True) -> torch.Tensor:
    """Infinitesimal symmetry loss on one lane. x_fx: (batch, 2, input_dim)
    stacking the input and the predicted output; exactly one of ``f`` (the
    flow map, differentiated by ``torch.func.jvp``) and ``dfdx`` ((batch,
    d, d), its Jacobian at x)."""
    if (f is None) == (dfdx is None):
        raise ValueError("Exactly one of f and dfdx must be specified.")
    z, _ = _z_shift(ae, ae.encode(x_fx), normalize, z_mean)
    x = x_fx[:, 0]
    loss = 0.0
    for v in lg.get_full_basis_list(spec, g_state):
        v_x_fx = torch.func.jvp(ae.decode, (z,), (_act(v, z),))[1]
        v_x, v_fx = v_x_fx[:, 0], v_x_fx[:, 1]
        if f is not None:
            iv = torch.func.jvp(f, (x,), (v_x,))[1]
        else:
            iv = torch.einsum("bjk,bk->bj", dfdx, v_x)
        sq = ((iv - v_fx) ** 2).mean()
        if relative:
            sq = sq / (iv ** 2).mean()
        loss = loss + sq
    return loss


def symmreg_f(ae, spec, g_state, x_fx: torch.Tensor, f, normalize: str = "global",
              z_mean=None, relative: bool = True) -> torch.Tensor:
    """Finite symmetry loss on one lane: per deterministic group element g,
    mean((f(g.x) - g.f(x))^2), over mean((f(g.x) - f(x))^2) when
    ``relative``; g acts in the latent space about the normalisation's
    shift."""
    fx = x_fx[:, 1]
    z, zm = _z_shift(ae, ae.encode(x_fx), normalize, z_mean)
    loss = 0.0
    for g in lg.get_deterministic_group_elems(spec, g_state):
        g_x_fx = ae.decode(_act(g, z) + zm)
        g_x, g_fx = g_x_fx[:, 0], g_x_fx[:, 1]
        f_g_x = f(g_x)
        sq = ((f_g_x - g_fx) ** 2).mean()
        if relative:
            sq = sq / ((f_g_x - fx) ** 2).mean()
        loss = loss + sq
    return loss


def _group_transform(ae, g, x, normalize: str = "global", z_mean=None):
    """g acting on data space through the autoencoder: decode(g (encode(x) -
    shift) + shift), component 0. The input is duplicated across the two
    components the encoder takes."""
    xx = torch.stack([x, x], dim=1)
    z, zm = _z_shift(ae, ae.encode(xx), normalize, z_mean)
    return ae.decode(_act(g, z) + zm)[:, 0]


def symmreg_r(ae, spec, g_state, x: torch.Tensor, h, normalize: str = "global",
              z_mean=None, scale: float = 0.01) -> torch.Tensor:
    """Reversed symmetry loss for an ODE h on one lane: per group element
    g = exp(0.01 sigma L), mean((J_g(x) h(x) - h(g(x)))^2)."""
    loss = 0.0
    for g in lg.get_deterministic_group_elems(spec, g_state, scale=scale):
        def gt(xx, g=g):
            return _group_transform(ae, g, xx, normalize, z_mean)

        variation1 = torch.func.jvp(gt, (x,), (h(x),))[1]
        loss = loss + ((variation1 - h(gt(x))) ** 2).mean()
    return loss


def make_symmreg_i_fast(ae, spec, g_state, int_t: float, int_dt: float, z_mean=None,
                        relative: bool = True, ae_dtype=None, pallas: bool = False,
                        fused_rollout_lib=None):
    """(prep, penalty) of the infinitesimal symmetry loss, batched over
    lanes: ``prep(x)`` with x (lanes, k, dim) returns the per-lane context.
    With ``fused_rollout_lib`` (the candidate equation's FunctionLibrary)
    ``penalty(XiM, x, ctx)`` takes the masked coefficients XiM (lanes, d, p)
    and ``penalty.wants_coefs`` is True; it raises ValueError for a basis
    element that is not block-diagonal (v_x would depend on the rollout
    endpoint). Without it ``penalty(forward_fn, x, ctx)`` takes the candidate
    field (lanes, k, d) -> (lanes, k, d). Either returns the per-lane
    penalty (lanes,). ae: models.autoencoder.AutoEncoder, frozen and in
    eval mode."""
    from ..ops.integrators import make_euler_pair, odeint

    dtype = torch.float32 if ae_dtype is None else ae_dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ae_dtype must be float32 or bfloat16, got {ae_dtype}")
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
    if fused_rollout_lib is not None:
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

    def jacobian_at(z_x):
        """Decoder Jacobian columns J e_j at z_x, as the JAX package's jacfwd."""
        eye = torch.eye(latent, dtype=z_x.dtype, device=z_x.device)
        cols = [torch.func.jvp(dec1, (z_x,), (eye[j].expand_as(z_x),))[1]
                for j in range(latent)]
        return torch.stack(cols, dim=-1)  # (lanes, k, dim, latent)

    n_steps = int(int_t / int_dt)

    def sq_term(iv, v_fx):
        sq = ((iv - v_fx) ** 2).mean(dim=(1, 2))
        return sq / (iv ** 2).mean(dim=(1, 2)) if relative else sq

    if fused_rollout_lib is None:
        def prep(x):
            """z_x and the decoder Jacobian at x, constant across the fit."""
            z_x = enc1(x)
            return {"z_x": z_x, "Jd_x": jacobian_at(z_x)}

        def penalty(forward_fn, x, ctx):
            def forward_step(q):
                return odeint(forward_fn, q, int_t, int_dt)

            fx = forward_step(x)
            z_x, Jd_x = ctx["z_x"], ctx["Jd_x"]
            z_fx = rows(enc_rows, fx)
            z_flat = torch.cat([z_x, z_fx], dim=-1)  # (lanes, k, 2 latent)
            loss = 0.0
            for v in basis:
                v_z = z_flat @ v.T
                v_x = torch.einsum("lbij,lbj->lbi", Jd_x, v_z[..., :latent])
                v_fx = rows(dec_jvp_rows, z_fx, v_z[..., latent:])
                iv = torch.func.jvp(forward_step, (x,), (v_x,))[1]
                loss = loss + sq_term(iv, v_fx)
            return loss

        return prep, penalty

    lib = fused_rollout_lib

    def field_jvp(A):
        """The candidate field q -> Theta(q) A and its derivative along tq."""
        def f_and_tangent(q, tq):
            theta, dtheta = lib.jvp(q, tq)
            return theta @ A, dtheta @ A

        return f_and_tangent

    ep = make_euler_pair(field_jvp, n_steps, int_dt)

    def prep_fused(x):
        """z_x and v_x per basis element, constant across the fit."""
        z_x = enc1(x)
        Jd_x = jacobian_at(z_x)
        v_xs = [torch.einsum("lbij,lbj->lbi", Jd_x, z_x @ v[:latent, :latent].T)
                for v in basis]
        return {"z_x": z_x, "v_xs": torch.stack(v_xs, dim=1)}  # (lanes, n_basis, k, dim)

    def penalty_fused(XiM, x, ctx):
        z_x = ctx["z_x"]
        A = XiM.mT  # (lanes, p, d)
        loss = 0.0
        for i, v in enumerate(basis):
            fx, iv = ep(x, ctx["v_xs"][:, i], A)
            z_fx = rows(enc_rows, fx)
            v_z_fx = z_fx @ v[latent:, latent:].T + z_x @ v[latent:, :latent].T
            loss = loss + sq_term(iv, rows(dec_jvp_rows, z_fx, v_z_fx))
        return loss

    penalty_fused.wants_coefs = True
    return prep_fused, penalty_fused


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
            gt = lambda xx, g=g: _group_transform(ae, g, xx, "global", zm)
            with torch.no_grad():
                gx_list.append(gt(x))
            cols = [torch.func.jvp(gt, (x,), (eye[j].expand_as(x),))[1]
                    for j in range(x.shape[-1])]
            Jgx_list.append(torch.stack(cols, dim=-1).detach())
        return gx_list, Jgx_list

    return precompute


def precompute_symmreg_r(ae, spec, g_state, x: torch.Tensor, z_mean=None,
                         scale: float = 0.01):
    """(g(x), J_g(x)) per deterministic group element, one shot; for
    repeated calls use make_precompute_symmreg_r."""
    return make_precompute_symmreg_r(ae, spec, g_state, z_mean=z_mean, scale=scale)(x)
