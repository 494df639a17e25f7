"""Fused L-BFGS equation-discovery sweep: the CUDA kernel, its wrapper and
its plain PyTorch version.

One lane is one (dataset, seed) run of the whole discovery protocol: epochs
of torch.optim.LBFGS-style fixed-lr L-BFGS (history of curvature pairs,
ys > 1e-10 update guard, H_diag = ys/yy, first step t = min(1, 1/|g|_1) * lr,
t = lr afterwards) with torch's inner-loop breaks (max|g| <= 1e-7, g.d >
-1e-9, max|d t| <= 1e-9, and a loss change below max(1e-9, one ulp)), then
per epoch the convergence delta (a sum of per-parameter-group norms),
sequential thresholding with an optimizer reset, the stop on convergence
since the last thresholding, and the NaN stop before thresholding. Loss:

    mse  = (sum_i Xm_i S Xm_i^T - 2 <Xm, B> + q) / (N d),   Xm = Xi * mask
    loss = w_x * mse + w_reg * ||theta||_1,  vec(Xi) = Mmap @ theta (row-major)

``lbfgs_sweep`` runs the CUDA kernel (csrc/lbfgs_sweep.cu) for tensors on a
CUDA device and the plain version ``lbfgs_sweep_plain`` for tensors on the
CPU. The kernel is built with nvcc into build/torch_kernels/ at first use and
bound with ctypes; it is rebuilt only when its source or flags change.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ._nvcc import BUILD_DIR, CSRC, Kernel  # noqa: F401 (BUILD_DIR: where the .so goes)

TOL_GRAD = 1e-7    # torch LBFGS tolerance_grad
TOL_CHANGE = 1e-9  # torch LBFGS tolerance_change
MAX_WIDTH = 128    # max parameters and max d*p (four 32-wide slices a warp)
MAX_HISTORY = 64

SOURCE = CSRC / "lbfgs_sweep.cu"
# IEEE division and square root and no FMA contraction: the one-ulp
# loss-change test and the ys > 1e-10 guard depend on per-op rounding.
# -maxrregcount=96: without it ptxas parks values in local memory around the
# division and square-root subroutine calls in the 2- and 3-slice
# instantiations; with it they take 72 and 94 registers and spill nothing.
# It does not cap the 4-slice instantiation, which takes 130 registers with
# no spill; why ptxas lets that one past the flag is not established (every
# instantiation carries __launch_bounds__). chip_smoke.py gates on the report.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-ftz=false", "-maxrregcount=96", "-Xptxas", "-v",
)

# Kernel launches made through `lbfgs_sweep` (the plain path does not count).
launches = 0


@dataclasses.dataclass(frozen=True)
class PLBFGSConfig:
    d: int                  # output dims of Xi
    p: int                  # library terms
    n_params: int           # free parameters (d*p unconstrained; q[+d] constrained)
    num_epochs: int = 100
    inner_iters: int = 20
    history: int = 32       # curvature pairs
    lr: float = 1.0
    w_x: float = 1.0
    w_reg: float = 0.0
    reg_l1: bool = True
    st_freq: int = 100
    threshold: float = 1e-2
    tol: float = 1e-3
    # parameters [0, n_beta) and [n_beta, n_params) are separate parameter
    # groups (beta, const): the convergence delta sums their norms.
    # None = a single group.
    n_beta: Optional[int] = None


KERNEL = Kernel(SOURCE, NVCC_FLAGS, {
    "lbfgs_sweep_launch": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                           + [ctypes.c_float] * 5 + [ctypes.c_void_p], ctypes.c_int)})
build_info = KERNEL.info


def build() -> ctypes.CDLL:
    """Compile csrc/lbfgs_sweep.cu with nvcc (once per source hash) and load
    it. ``build_info`` records the library path, whether this call compiled
    it, the seconds taken and nvcc's -Xptxas -v report."""
    return KERNEL.lib()


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lbfgs_sweep(cfg: PLBFGSConfig, S, B, q, n_elems, theta0, Mmap=None, work=None):
    """Run the discovery protocol on every lane.

    S (lanes, p, p), B (lanes, d, p), q (lanes,), n_elems (lanes,) = N*d,
    theta0 (lanes, n_params), Mmap (d*p, n_params) or None for the identity;
    all float32. Returns (theta (lanes, n_params), mask (lanes, d, p) float32,
    stop_epoch (lanes,) int32). On a CUDA device this launches the kernel; on
    the CPU it runs ``lbfgs_sweep_plain``; both paths take the same checked
    inputs. ``work``, an optional int32 (lanes, 2) CUDA tensor, receives per
    lane the loss/gradient evaluations and the history pairs visited by the
    two-loop recursion.
    """
    global launches
    device = S.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"lbfgs_sweep runs on cuda or cpu, not {device}")
    lanes = S.shape[0]
    d, p, n = cfg.d, cfg.p, cfg.n_params
    if lanes < 1:
        raise ValueError("lbfgs_sweep needs at least one lane")
    if n > MAX_WIDTH or d * p > MAX_WIDTH:
        raise ValueError(f"n_params {n} and d*p {d * p} must be <= {MAX_WIDTH}")
    if not 1 <= cfg.history <= MAX_HISTORY:
        raise ValueError(f"history must be in [1, {MAX_HISTORY}]")
    f32 = torch.float32
    _check("S", S, (lanes, p, p), f32, device)
    _check("B", B, (lanes, d, p), f32, device)
    _check("q", q, (lanes,), f32, device)
    _check("n_elems", n_elems, (lanes,), f32, device)
    _check("theta0", theta0, (lanes, n), f32, device)
    if Mmap is not None:
        _check("Mmap", Mmap, (d * p, n), f32, device)
    if device.type == "cpu":
        return lbfgs_sweep_plain(cfg, S, B, q, n_elems, theta0, Mmap)
    if Mmap is None:
        Mmap = torch.eye(d * p, dtype=f32, device=device)
    if work is not None:
        _check("work", work, (lanes, 2), torch.int32, device)

    lib = build()
    theta = torch.empty((lanes, n), dtype=f32, device=device)
    mask = torch.empty((lanes, d, p), dtype=f32, device=device)
    stop = torch.empty((lanes,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.lbfgs_sweep_launch(
            S.data_ptr(), B.data_ptr(), q.data_ptr(), n_elems.data_ptr(),
            theta0.data_ptr(), Mmap.data_ptr(), theta.data_ptr(), mask.data_ptr(),
            stop.data_ptr(), None if work is None else work.data_ptr(),
            lanes, d, p, n, cfg.num_epochs, cfg.inner_iters, cfg.history,
            cfg.st_freq, -1 if cfg.n_beta is None else cfg.n_beta,
            int(cfg.w_reg > 0.0 and cfg.reg_l1), cfg.lr, cfg.w_x, cfg.w_reg,
            cfg.threshold, cfg.tol, stream)
    if rc != 0:
        raise RuntimeError(f"lbfgs_sweep kernel launch failed: CUDA error {rc}")
    launches += 1
    return theta, mask, stop


def lbfgs_sweep_plain(cfg: PLBFGSConfig, S, B, q, n_elems, theta0, Mmap=None):
    """The same protocol as batched PyTorch operations over lanes, in the
    TPU kernel's arithmetic order where it is cheap to keep (the quadratic
    form is accumulated term by term). Same arguments and results as
    ``lbfgs_sweep``."""
    lanes = S.shape[0]
    d, p, n = cfg.d, cfg.p, cfg.n_params
    nv, m = d * p, cfg.history
    dev, f32 = S.device, torch.float32
    S = S.to(f32)
    Bv = B.to(f32).reshape(lanes, nv)
    qv = q.to(f32).reshape(lanes, 1)
    inv_nd = (1.0 / n_elems.to(f32)).reshape(lanes, 1)
    Mm = (torch.eye(nv, dtype=f32, device=dev) if Mmap is None
          else torch.as_tensor(Mmap, dtype=f32, device=dev))
    use_l1 = cfg.w_reg > 0.0 and cfg.reg_l1

    def vec_of(th):
        return th @ Mm.T

    def loss_and_grad(th, mask):
        xm = vec_of(th) * mask
        xm3 = xm.reshape(lanes, d, p)
        Sx = torch.zeros_like(xm3)
        for j in range(p):
            Sx = Sx + xm3[:, :, j:j + 1] * S[:, None, j, :]
        Sx = Sx.reshape(lanes, nv)
        mse = ((xm * Sx).sum(1, keepdim=True)
               - 2.0 * (xm * Bv).sum(1, keepdim=True) + qv) * inv_nd
        loss = cfg.w_x * mse
        g = ((2.0 * cfg.w_x) * inv_nd * (Sx - Bv) * mask) @ Mm
        if use_l1:
            loss = loss + cfg.w_reg * th.abs().sum(1, keepdim=True)
            g = g + cfg.w_reg * torch.sign(th)
        return loss, g

    def dot(a, b):
        return (a * b).sum(1, keepdim=True)

    def param_delta(a, b):
        dd = a - b
        if cfg.n_beta is None:
            return torch.sqrt(dot(dd, dd))
        db, dc = dd[:, :cfg.n_beta], dd[:, cfg.n_beta:]
        return torch.sqrt(dot(db, db)) + torch.sqrt(dot(dc, dc))

    def col(value, dtype=f32):
        return torch.full((lanes, 1), value, dtype=dtype, device=dev)

    theta = theta0.to(f32).clone()
    mask = torch.ones((lanes, nv), dtype=f32, device=dev)
    prev, pprev = theta, theta
    since_thresh = col(0, torch.int32)
    done = col(False, torch.bool)
    stop = col(cfg.num_epochs, torch.int32)
    prev_g = torch.zeros_like(theta)
    d_dir = torch.zeros_like(theta)
    prev_loss = col(1e30)
    hist_len = col(0, torch.int32)
    H_diag = col(1.0)
    n_iter = col(0, torch.int32)
    s_hist = torch.zeros((m, lanes, n), dtype=f32, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho_hist = torch.zeros((m, lanes, 1), dtype=f32, device=dev)
    slot = torch.arange(m, device=dev).reshape(m, 1, 1)

    def direction_of(g):
        # two-loop recursion over the chronological history; slots at or
        # beyond every lane's hist_len contribute nothing and are skipped
        k_top = int(hist_len.max())
        q_ = -g
        alphas = [None] * k_top
        for k in range(k_top - 1, -1, -1):
            valid = (hist_len > k).to(f32)
            a = rho_hist[k] * dot(s_hist[k], q_) * valid
            q_ = q_ - a * y_hist[k]
            alphas[k] = a
        r = q_ * H_diag
        for k in range(k_top):
            valid = (hist_len > k).to(f32)
            beta = rho_hist[k] * dot(y_hist[k], r) * valid
            r = r + s_hist[k] * (alphas[k] - beta) * valid
        return r

    for e in range(cfg.num_epochs):
        frozen = done
        ep_froz = torch.zeros_like(done)
        th = theta
        for i in range(cfg.inner_iters):
            loss, g = loss_and_grad(th, mask)
            opt_cond = g.abs().amax(1, keepdim=True) <= TOL_GRAD
            step_small = d_dir.abs().amax(1, keepdim=True) <= TOL_CHANGE
            ulp = loss.abs() * (2.0 ** -23)
            loss_small = (loss - prev_loss).abs() < torch.clamp(ulp, min=TOL_CHANGE)
            new_freeze = opt_cond | ((step_small | loss_small) if i > 0 else False)
            ep_froz = ep_froz | new_freeze
            active = ~ep_froz & ~frozen
            if not bool(active.any()):
                break  # every lane is frozen for the rest of this epoch

            is_first = n_iter == 0
            y = g - prev_g
            s = d_dir
            ys = dot(y, s)
            do_update = active & ~is_first & (ys > 1e-10)
            full = hist_len >= m
            shift = do_update & full
            s_hist[:-1] = torch.where(shift, s_hist[1:], s_hist[:-1])
            y_hist[:-1] = torch.where(shift, y_hist[1:], y_hist[:-1])
            rho_hist[:-1] = torch.where(shift, rho_hist[1:], rho_hist[:-1])
            write = (slot == torch.clamp(hist_len, max=m - 1)) & do_update
            rho_new = torch.where(ys != 0, 1.0 / torch.where(ys != 0, ys, 1.0), 0.0)
            s_hist = torch.where(write, s, s_hist)
            y_hist = torch.where(write, y, y_hist)
            rho_hist = torch.where(write, rho_new, rho_hist)
            hist_len = hist_len + (do_update & ~full).to(torch.int32)
            yy = dot(y, y)
            H_new = torch.where(yy > 0, ys / torch.where(yy > 0, yy, 1.0), 1.0)
            H_diag = torch.where(do_update, H_new, H_diag)

            direction = torch.where(is_first, -g, direction_of(g))
            g1 = g.abs().sum(1, keepdim=True)
            t_first = torch.minimum(
                torch.ones_like(g1), 1.0 / torch.clamp(g1, min=1e-30)) * cfg.lr
            t = torch.where(is_first, t_first, cfg.lr)
            gtd_break = dot(g, direction) > -TOL_CHANGE
            step = direction * t
            th = torch.where(active & ~gtd_break, th + step, th)
            prev_g = torch.where(active, g, prev_g)
            prev_loss = torch.where(active, loss, prev_loss)
            d_dir = torch.where(active, step, d_dir)
            n_iter = n_iter + active.to(torch.int32)
            ep_froz = ep_froz | (gtd_break & active)
        new_theta = torch.where(frozen, theta, th)

        nan = torch.isnan(new_theta).any(1, keepdim=True)
        conv = param_delta(new_theta, prev) < cfg.tol
        final_conv = conv & (param_delta(new_theta, pprev) < cfg.tol)
        since_thresh = since_thresh + 1
        if cfg.st_freq > 0:
            st_hit = since_thresh % cfg.st_freq == 0
        else:
            st_hit = torch.zeros_like(conv)
        # NaN lanes stop before thresholding (|NaN| > thr would zero the mask)
        tf = ~done & ~nan & ~final_conv & (conv | st_hit)
        keep = (vec_of(new_theta).abs() > cfg.threshold).to(f32)
        mask = torch.where(tf, keep * mask, mask)
        hist_len = torch.where(tf, 0, hist_len)
        n_iter = torch.where(tf, 0, n_iter)
        H_diag = torch.where(tf, 1.0, H_diag)
        prev_g = torch.where(tf, 0.0, prev_g)
        d_dir = torch.where(tf, 0.0, d_dir)
        pprev = torch.where(tf & conv, new_theta, pprev)
        since_thresh = torch.where(tf, 0, since_thresh)
        newly_done = ~done & (final_conv | nan)
        stop = torch.where(newly_done, e, stop)
        done = done | newly_done
        theta = prev = new_theta
        if bool(done.all()):
            break
    return theta, mask.reshape(lanes, d, p), stop.reshape(lanes)
