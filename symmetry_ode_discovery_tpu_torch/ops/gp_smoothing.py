"""Gaussian-process smoothing and numerical differentiation of noisy
trajectories.

The smoother is one T x T Cholesky factorization of (K + noise^2 I), shared
by every trajectory and dimension (the per-dimension kernels are scalar
multiples of one unit kernel, so their scales cancel), followed by two
products: K @ Z for the smoothed signal and D @ Z for its derivative, with
Z = (K + noise^2 I)^{-1} Y and the difference kernel D = (K2 - K)/1e-3, where
K2 = K(t + 1e-3, t). Applying D to the shared solve avoids subtracting two
smoothed signals that differ at the 1e-3 level.

Engines: f32 at noise >= 0.15, f64 below, where the kernel's condition
number (~noise^-2) is beyond f32. The JAX package runs its f64 engine on the
host with scipy; here it runs in float64 on whatever device the data is on,
the card included, since the point is the precision and not the host.
"""

from __future__ import annotations

import torch


def rbf_kernel(t, sigma_out, sigma_in, t2=None):
    """RBF kernel matrix K[i, j] = sigma_out^2 exp(-(t_i - t2_j)^2 / (2 sigma_in^2))."""
    tr = t if t2 is None else t2
    return sigma_out ** 2 * torch.exp(
        -1.0 / (2 * sigma_in ** 2) * (t[:, None] - tr[None, :]) ** 2)


def gp_smooth_apply(t, Y, noise_level, sigma_in, dtype=torch.float32):
    """(S @ Y, (S2 - S) @ Y / 1e-3) for the data matrix Y (T, r), where
    S = K (K + noise^2 I)^{-1} and S2 = K2 (K + noise^2 I)^{-1}, computed in
    ``dtype`` through one Cholesky factorization."""
    t = t.to(dtype)
    Y = Y.to(dtype)
    if dtype == torch.float64:
        # the same arithmetic as the JAX package's float64 engine
        d2 = (t[:, None] - t[None, :]) ** 2
        K = torch.exp(-d2 / (2 * sigma_in ** 2))
        K2 = torch.exp(-((t + 1e-3)[:, None] - t[None, :]) ** 2 / (2 * sigma_in ** 2))
    else:
        K = rbf_kernel(t, 1.0, sigma_in)
        K2 = rbf_kernel(t + 1e-3, 1.0, sigma_in, t)
    D = (K2 - K) / 1e-3
    del K2
    A = K + noise_level ** 2 * torch.eye(t.shape[0], dtype=dtype, device=t.device)
    L = torch.linalg.cholesky(A)
    del A
    Z = torch.linalg.solve_triangular(L, Y, upper=False)
    Z = torch.linalg.solve_triangular(L.mT, Z, upper=True)
    return K @ Z, D @ Z


def num_diff_gp(x, dt, noise_level, std_base=None, sigma_in=None, engine="auto"):
    """GP-smooth x (seq_len, n_trajs, dim) and differentiate it.

    std_base (the per-dimension std) cancels in the smoother and is accepted
    for signature parity with the JAX package. sigma_in defaults to dt.
    engine: 'f64', 'f32', or 'auto' (f32 when noise_level >= 0.15, else f64).
    Returns (dxdt, x_smooth) as float32, in the reference's order.
    """
    seq_len, n_trajs, input_dim = x.shape
    if sigma_in is None:
        sigma_in = dt
    if engine == "auto":
        engine = "f32" if noise_level >= 0.15 else "f64"
    if engine not in ("f32", "f64"):
        raise ValueError(f"unknown GP engine: {engine!r}")
    dtype = torch.float64 if engine == "f64" else torch.float32
    t = torch.arange(seq_len, dtype=dtype, device=x.device) * dt
    Y = x.reshape(seq_len, n_trajs * input_dim)
    Ys, Yd = gp_smooth_apply(t, Y, noise_level, sigma_in, dtype=dtype)
    x_smooth = Ys.reshape(seq_len, n_trajs, input_dim).to(torch.float32)
    dxdt = Yd.reshape(seq_len, n_trajs, input_dim).to(torch.float32)
    return dxdt, x_smooth


def fit_sigma_in(Y, t, noise_sigma, sigma_out, sigma_in0):
    """Marginal-likelihood fit of the kernel length scale (Powell, scipy on
    the host in float64, as the JAX package fits it). Optional: the
    pipeline passes an explicit gp_sigma_in everywhere."""
    import numpy as np
    from scipy.optimize import minimize

    Y = np.asarray(Y, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    tau = sigma_out ** 2 / noise_sigma ** 2
    n, r = Y.shape[0] * Y.shape[1], Y.shape[1]

    def loss(logx):
        s_in = float(np.exp(logx[0]))
        d2 = (t[:, None] - t[None, :]) ** 2
        K = sigma_out ** 2 * np.exp(-d2 / (2 * s_in ** 2))
        W = np.linalg.inv(1.0 / tau * np.linalg.inv(K) + np.eye(K.shape[0]))
        b = Y.T  # an orthogonal A leaves Y @ A's row space, so S, unchanged
        S = np.abs(np.sum(Y ** 2) - np.sum(np.diag(b @ W @ b.T)))
        f2 = np.log(S) * (-1 * n / 2)
        f1 = -0.5 * r * np.linalg.slogdet(tau * K + np.eye(K.shape[0]))[1]
        return -1 * (f1 + f2)

    res = minimize(loss, x0=np.log(np.array([sigma_in0])), method="Powell")
    return float(np.exp(res["x"][0]))
