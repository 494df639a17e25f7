"""Multi-seed SINDy / EquivSINDy-c discovery sweeps through the fused L-BFGS
kernel.

A sweep is a batch of lanes, one per seed (and per dataset for the stacked
sweep): each lane draws its own subsample of the data and its own initial
parameters, is reduced to its normal equations (S = Theta^T Theta, B, q),
runs the whole L-BFGS protocol in the kernel, and is scored against the
ground truth. The JAX package's ``vmap`` over seeds is the leading lane
dimension here.

Random draws: seed s subsamples with ``torch.Generator(device).manual_seed(2s)``
and draws theta0 with ``manual_seed(2s + 1)``; they are torch draws, so the
per-seed data differ from the JAX package's. ``subsample_idx`` and ``theta0``
take external draws instead (e.g. the JAX package's, for parity checks).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.sindy import SINDyConfig
from ..ops.lbfgs_sweep import PLBFGSConfig, lbfgs_sweep
from .siged import LBFGSHParams


def eval_coefficients(coef: torch.Tensor, mask: torch.Tensor, truth: torch.Tensor):
    """Batched form/MSE scoring over leading dims: coef, mask (..., d, p),
    truth (d, p). Returns (correct_form (..., d), mse (..., d)); the MSE is
    over the truth's support."""
    mask_b = mask > 0
    coef = torch.where(mask_b, coef, 0.0)
    truth_mask = truth != 0
    correct_form = (mask_b == truth_mask).all(-1).to(torch.float32)
    tm = truth_mask.to(coef.dtype)
    mse = ((coef - truth) ** 2 * tm).sum(-1) / tm.sum(-1)
    return correct_form, mse


@dataclasses.dataclass
class SweepResult:
    Xi: np.ndarray            # (n_seeds, d, p)
    mask: np.ndarray          # (n_seeds, d, p)
    correct_form: np.ndarray  # (n_seeds, d)
    mse: np.ndarray           # (n_seeds, d)

    def results_list(self):
        """Per-seed dicts in the evaluation schema, for aggregate_results."""
        return [{
            "coefficients": self.Xi[i] * self.mask[i],
            "correct_form": self.correct_form[i],
            "mse": self.mse[i],
            "correct_form_all": np.all(self.correct_form[i] > 0),
            "mse_all": np.mean(self.mse[i]),
        } for i in range(self.Xi.shape[0])]


def _finalize(theta, mask, Mmap, d, p, truth) -> SweepResult:
    Xi = (theta @ Mmap.T if Mmap is not None else theta).reshape(-1, d, p)
    truth_t = torch.as_tensor(np.asarray(truth), dtype=torch.float32, device=Xi.device)
    cf, mse = eval_coefficients(Xi, mask, truth_t)
    return SweepResult(Xi=Xi.cpu().numpy(), mask=mask.cpu().numpy(),
                       correct_form=cf.cpu().numpy(), mse=mse.cpu().numpy())


def _generator(seed, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(2 * int(seed) + stream)


def _subsample_idx(seeds, n: int, k: int, device) -> torch.Tensor:
    """(n_seeds, k) per-seed random subsets of range(n)."""
    return torch.stack([
        torch.randperm(n, generator=_generator(s, 0, device), device=device)[:k]
        for s in seeds])


def _init_theta(seeds, n_params: int, device) -> torch.Tensor:
    """(n_seeds, n_params) standard-normal initial parameters."""
    return torch.stack([
        torch.randn(n_params, generator=_generator(s, 1, device), device=device)
        for s in seeds])


def _prep_normal_eq(cfg: SINDyConfig, k: int, x, dx, idx):
    """Per-lane subsample and normal-equation reduction: returns S (lanes, p, p),
    B (lanes, d, p), q (lanes,), n_elems (lanes,) for the (lanes, k) row
    indices ``idx``. A plain batched product, as the JAX package leaves it
    to XLA."""
    th = cfg.library(x[idx])     # (lanes, k, p)
    dxi = dx[idx]                # (lanes, k, d)
    S = th.mT @ th
    B = (th.mT @ dxi).mT.contiguous()
    q = (dxi ** 2).sum(dim=(1, 2))
    n_elems = torch.full_like(q, float(k * dx.shape[1]))
    return S, B, q, n_elems


def _kernel_setup(cfg: SINDyConfig, Q, hp: LBFGSHParams, device):
    """(kernel config, Mmap tensor or None for the identity, n_params).
    Mmap = [Q | const columns]; theta = [beta, const]."""
    d, p = cfg.latent_dim, cfg.n_terms
    n_free = None
    Mmap = None
    n_params = d * p
    if cfg.constraint:
        n_free = Q.shape[1]
        cols = [np.asarray(Q, np.float32)]
        if cfg.allow_constant:
            cc = np.zeros((d * p, d), np.float32)
            for i in range(d):
                cc[i * p, i] = 1.0
            cols.append(cc)
        elif cfg.dangling_const:
            # const stays a parameter that never reaches Xi but still feeds
            # the L1 term and the per-group convergence delta
            cols.append(np.zeros((d * p, d), np.float32))
        Mmap_np = np.concatenate(cols, axis=1)
        n_params = Mmap_np.shape[1]
        # Q from the SVD is a column-major slice; the kernel reads Mmap row-major
        Mmap = torch.as_tensor(np.ascontiguousarray(Mmap_np), device=device)
    has_const = cfg.constraint and (cfg.allow_constant or cfg.dangling_const)
    pcfg = PLBFGSConfig(
        d=d, p=p, n_params=n_params, num_epochs=hp.num_epochs,
        inner_iters=hp.inner_iters, lr=hp.lr_sindy, w_x=hp.w_sindy_x,
        w_reg=hp.w_sindy_reg, reg_l1=(hp.sindy_reg_type == "l1"),
        st_freq=hp.st_freq, threshold=hp.threshold, tol=hp.tol,
        n_beta=(n_free if has_const else None),
    )
    return pcfg, Mmap, n_params


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def sweep_sindy_lbfgs(
    cfg: SINDyConfig,
    Q: Optional[np.ndarray],
    x,
    dx,
    truth: np.ndarray,
    hp: LBFGSHParams,
    seeds: Sequence[int],
    lbfgs_subsample: float = 1.0,
    subsample_idx: Optional[np.ndarray] = None,
    theta0: Optional[np.ndarray] = None,
    device=None,
) -> SweepResult:
    """SINDy (Q None) or EquivSINDy-c discovery over ``seeds``, one kernel
    launch. x, dx: (N, d) samples. subsample_idx (n_seeds, k) and theta0
    (n_seeds, n_params) replace the per-seed torch draws when given."""
    device = resolve_device(device)
    pcfg, lanes, Mmap = stacked_lanes(cfg, Q, [x], [dx], hp, seeds, lbfgs_subsample,
                                      device, subsample_idx, theta0)
    theta, mask, _ = lbfgs_sweep(pcfg, *lanes, Mmap)
    return _finalize(theta, mask, Mmap, cfg.latent_dim, cfg.n_terms, truth)


def sweep_sindy_lbfgs_stacked(
    cfg: SINDyConfig,
    Q: Optional[np.ndarray],
    xs,
    dxs,
    truth: np.ndarray,
    hp: LBFGSHParams,
    seeds: Sequence[int],
    lbfgs_subsample: float = 1.0,
    device=None,
) -> List[SweepResult]:
    """Datasets x seeds sweep (e.g. one dataset per noise level) in ONE
    kernel launch of len(xs) * len(seeds) lanes. Each (dataset, seed) lane
    follows the per-seed protocol of ``sweep_sindy_lbfgs``, so each dataset's
    result equals its own sweep; datasets of equal N share one subsample
    draw per seed. Returns one SweepResult per dataset."""
    device = resolve_device(device)
    pcfg, lanes, Mmap = stacked_lanes(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample,
                                      device)
    theta, mask, _ = lbfgs_sweep(pcfg, *lanes, Mmap)
    n_seeds = len(seeds)
    return [_finalize(theta[i * n_seeds:(i + 1) * n_seeds],
                      mask[i * n_seeds:(i + 1) * n_seeds], Mmap,
                      cfg.latent_dim, cfg.n_terms, truth)
            for i in range(len(xs))]


def stacked_lanes(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample, device,
                  subsample_idx=None, theta0=None):
    """The kernel launch of the datasets x seeds sweep: (kernel config,
    (S, B, q, n_elems, theta0) with lane = dataset * n_seeds + seed, Mmap).
    subsample_idx (n_seeds, k) and theta0 (n_seeds, n_params), when given,
    replace the per-seed draws for every dataset."""
    xs = [_as_f32(x, device) for x in xs]
    dxs = [_as_f32(dx, device) for dx in dxs]
    n_seeds = len(seeds)
    pcfg, Mmap, n_params = _kernel_setup(cfg, Q, hp, device)
    if theta0 is None:
        th0 = _init_theta(seeds, n_params, device)
    else:
        th0 = _as_f32(theta0, device).reshape(n_seeds, n_params).contiguous()
    drawn = {}
    parts = []
    for x, dx in zip(xs, dxs):
        n = x.shape[0]
        k = int(n * lbfgs_subsample)
        if subsample_idx is not None:
            idx = torch.as_tensor(np.asarray(subsample_idx), dtype=torch.long, device=device)
            if tuple(idx.shape) != (n_seeds, k):
                raise ValueError(f"subsample_idx {tuple(idx.shape)} != ({n_seeds}, {k})")
        else:
            if n not in drawn:
                drawn[n] = _subsample_idx(seeds, n, k, device)
            idx = drawn[n]
        parts.append(_prep_normal_eq(cfg, k, x, dx, idx))
    S, B, q, ne = (torch.cat(t) for t in zip(*parts))
    return pcfg, (S, B, q, ne, th0.repeat(len(xs), 1)), Mmap
