"""Multi-seed SINDy / EquivSINDy-c discovery sweeps through the fused L-BFGS
kernel, and the direct STLSQ and weak-form (WSINDy) sweeps.

A sweep is a batch of lanes, one per seed (and per dataset for the stacked
sweep): each lane draws its own subsample of the data and its own initial
parameters, is reduced to its normal equations (S = Theta^T Theta, B, q),
runs the whole L-BFGS protocol in the kernel, and is scored against the
ground truth. The JAX package's ``vmap`` over seeds is the leading lane
dimension here. K1 runs the fixed-lr protocol only: with
``hp.linesearch`` (optax's zoom line search) the lanes run the host-stepped
fit of training/siged.py instead, on the same draws.

Random draws: seed s subsamples with ``torch.Generator(device).manual_seed(2s)``
and draws theta0 with ``manual_seed(2s + 1)``; they are torch draws, so the
per-seed data differ from the JAX package's. ``subsample_idx`` and ``theta0``
take external draws instead (e.g. the JAX package's, for parity checks).
The STLSQ sweep draws its rows the same way; the WSINDy sweep's windows are
described at ``wsindy_windows``.

Every sweep can shard its seed axis over a device mesh (parallel/mesh.py):
shard i takes the contiguous slice i of the seeds, draws and solves them on
its device (one K1 launch a shard on the L-BFGS sweeps), and the results are
gathered in seed order; each seed's draws and arithmetic are its own, so a
lane's result does not depend on the sharding. One device is a mesh of one
shard. ``n_mesh_devices`` follows the JAX package: on the L-BFGS sweeps a
mesh of that many CUDA devices when it is over 1; on STLSQ and WSINDy also 0
or None for every CUDA device when the sweep runs on the card; ``mesh``
passes an explicit ``Mesh`` instead (a device may repeat there). A seed
count the mesh does not divide runs on one device, with a message saying
so.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models.sindy import SINDyConfig, SINDyState, get_Xi, init_sindy, solve_sindy
from ..models.wsindy import make_wsindy_matrices, solve_wsindy
from ..ops.lbfgs_sweep import PLBFGSConfig, lbfgs_sweep
from ..parallel.mesh import Mesh, make_mesh, shard_sweep
from ..utils import watchdog
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


def resolve_mesh(n_mesh_devices: Optional[int], mesh: Optional[Mesh], n_seeds: int,
                 device, every_device_by_default: bool) -> Mesh:
    """The mesh a sweep of ``n_seeds`` seeds shards over: ``mesh`` when
    given, else make_mesh(n_mesh_devices) when that is over 1 (ValueError
    when the CUDA devices are fewer), else, with ``every_device_by_default``
    and a sweep on the card, every CUDA device for 0 or None; otherwise the
    one shard ``device``. A seed count the mesh does not divide runs on
    ``device`` alone (the JAX package's rule), said on stdout so that nobody
    believes the mesh is in use."""
    one = Mesh((device,))
    if mesh is None:
        n = n_mesh_devices or 0
        if n == 0 and every_device_by_default and torch.device(device).type == "cuda":
            n = torch.cuda.device_count()
        if n <= 1:
            return one
        mesh = make_mesh(n)
    if n_seeds % mesh.size:
        print(f"sweep: {n_seeds} seeds not divisible by {mesh.size} devices; "
              "running on one device")
        return one
    return mesh


def _rows(a, pos):
    """Rows ``pos`` of an optional per-seed array."""
    return None if a is None else np.asarray(a)[list(pos)]


def _by_dataset(a, n_sets: int, name: str):
    """An optional per-seed draw array as one array per dataset: an
    (n_seeds, ·) array is shared by every dataset; a list of n_sets arrays
    (or an (n_sets, n_seeds, ·) array) gives each dataset its own."""
    if a is None:
        return None
    if not isinstance(a, (list, tuple)) and np.ndim(a) == 2:
        return [np.asarray(a)] * n_sets
    a = [np.asarray(t) for t in a]
    if len(a) != n_sets:
        raise ValueError(f"{name}: {len(a)} arrays for {n_sets} datasets")
    return a


def _set_rows(a, pos):
    """Rows ``pos`` of each dataset's optional per-seed array."""
    return None if a is None else [t[list(pos)] for t in a]


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
    n_mesh_devices: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> SweepResult:
    """SINDy (Q None) or EquivSINDy-c discovery over ``seeds``, one kernel
    launch (one a shard on a mesh). x, dx: (N, d) samples. subsample_idx
    (n_seeds, k) and theta0 (n_seeds, n_params) replace the per-seed torch
    draws when given."""
    device = resolve_device(device)
    one = lambda a: None if a is None else [a]
    theta, mask, Mmap = _lbfgs_lanes(cfg, Q, [x], [dx], hp, seeds, lbfgs_subsample,
                                     resolve_mesh(n_mesh_devices, mesh, len(seeds), device,
                                                  False), one(subsample_idx), one(theta0))
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
    subsample_idx=None,
    theta0=None,
    device=None,
    n_mesh_devices: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> List[SweepResult]:
    """Datasets x seeds sweep (e.g. one dataset per noise level) in ONE
    kernel launch of len(xs) * len(seeds) lanes (one launch a shard of the
    seeds on a mesh). Each (dataset, seed) lane follows the per-seed
    protocol of ``sweep_sindy_lbfgs``, so each dataset's result equals its
    own sweep on the same draws; datasets of equal N share one subsample
    draw per seed. subsample_idx and theta0 replace the per-seed torch
    draws: one (n_seeds, k) and (n_seeds, n_params) array shared by every
    dataset, or one per dataset (an (L, n_seeds, ·) array or a list of L).
    Returns one SweepResult per dataset."""
    device = resolve_device(device)
    theta, mask, Mmap = _lbfgs_lanes(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample,
                                     resolve_mesh(n_mesh_devices, mesh, len(seeds), device,
                                                  False),
                                     _by_dataset(subsample_idx, len(xs), "subsample_idx"),
                                     _by_dataset(theta0, len(xs), "theta0"))
    n_seeds = len(seeds)
    return [_finalize(theta[i * n_seeds:(i + 1) * n_seeds],
                      mask[i * n_seeds:(i + 1) * n_seeds], Mmap,
                      cfg.latent_dim, cfg.n_terms, truth)
            for i in range(len(xs))]


def _lbfgs_lanes(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample, mesh,
                 subsample_idx=None, theta0=None):
    """(theta, mask, Mmap) of the datasets x seeds lanes: K1 for the
    fixed-lr protocol; with ``hp.linesearch`` the host-stepped fit, since
    K1 implements the fixed-lr protocol only and a line-search request must
    not silently run another optimizer. subsample_idx and theta0: None or
    one per-seed array per dataset."""
    run = _stepped_sweep if hp.linesearch else _kernel_sweep
    return run(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample, mesh, subsample_idx, theta0)


def _seed_rows(idx_cache, seeds, n, k, device, subsample_idx):
    """(n_seeds, k) row indices of a dataset of n rows: ``subsample_idx``
    when given, else the per-seed draws, shared by datasets of equal n."""
    if subsample_idx is not None:
        idx = torch.as_tensor(np.asarray(subsample_idx), dtype=torch.long, device=device)
        if tuple(idx.shape) != (len(seeds), k):
            raise ValueError(f"subsample_idx {tuple(idx.shape)} != ({len(seeds)}, {k})")
        return idx
    if n not in idx_cache:
        idx_cache[n] = _subsample_idx(seeds, n, k, device)
    return idx_cache[n]


def _stepped_sweep(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample, mesh,
                   subsample_idx=None, theta0=None):
    """(Xi flattened, mask, None) of the datasets x seeds lanes by the
    host-stepped fit (training/siged.py::train_sindy_lbfgs on the
    normal-equation loss), a shard's lanes of one dataset at a time, on the
    per-seed draws of the kernel sweep. Float64 data stay float64."""
    from .siged import _make_param_fns, train_sindy_lbfgs

    seeds = list(seeds)
    n_sets, d, p = len(xs), cfg.latent_dim, cfg.n_terms
    n_params = _make_param_fns(cfg, Q)[0]
    dtype = (torch.float64 if all(torch.as_tensor(x).dtype == torch.float64 for x in xs)
             else torch.float32)

    def run_shard(pos, dev):
        sub = [seeds[i] for i in pos]
        idx_sets, th0_sets = _set_rows(subsample_idx, pos), _set_rows(theta0, pos)
        drawn = {}
        Xis, masks = [], []
        for i, (x, dx) in enumerate(zip(xs, dxs)):
            if th0_sets is None:
                th0 = _init_theta(sub, n_params, dev).to(dtype)
            else:
                th0 = torch.as_tensor(th0_sets[i], dtype=dtype,
                                      device=dev).reshape(len(pos), n_params)
            x = torch.as_tensor(x, dtype=dtype, device=dev)
            dx = torch.as_tensor(dx, dtype=dtype, device=dev)
            idx = _seed_rows(drawn, sub, x.shape[0], int(x.shape[0] * lbfgs_subsample), dev,
                             None if idx_sets is None else idx_sets[i])
            res = train_sindy_lbfgs(cfg, Q, x[idx], dx[idx], hp, th0)
            Xis.append(res.Xi.reshape(len(pos), d * p))
            masks.append(res.mask)
        # seed axis first, so that the shards gather along it
        return torch.stack(Xis, 1), torch.stack(masks, 1)

    Xi, mask = shard_sweep(run_shard, mesh)(list(range(len(seeds))))
    return (Xi.transpose(0, 1).reshape(n_sets * len(seeds), -1),
            mask.transpose(0, 1).reshape(n_sets * len(seeds), d, p), None)


def _kernel_sweep(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample, mesh,
                  subsample_idx=None, theta0=None):
    """(theta, mask, Mmap) of the datasets x seeds lanes (lane = dataset *
    n_seeds + seed): one K1 launch a shard of the seeds on ``mesh``,
    gathered on its first device."""
    seeds = list(seeds)
    n_sets, d, p = len(xs), cfg.latent_dim, cfg.n_terms

    def run_shard(pos, dev):
        pcfg, lanes, Mmap = stacked_lanes(cfg, Q, xs, dxs, hp, [seeds[i] for i in pos],
                                          lbfgs_subsample, dev, _set_rows(subsample_idx, pos),
                                          _set_rows(theta0, pos))
        theta, mask, _ = lbfgs_sweep(pcfg, *lanes, Mmap)
        # seed axis first, so that the shards gather along it
        return (theta.reshape(n_sets, len(pos), -1).transpose(0, 1),
                mask.reshape(n_sets, len(pos), d, p).transpose(0, 1))

    theta, mask = shard_sweep(run_shard, mesh)(list(range(len(seeds))))
    watchdog.beat()
    Mmap = _kernel_setup(cfg, Q, hp, mesh.devices[0])[1]
    return (theta.transpose(0, 1).reshape(n_sets * len(seeds), -1),
            mask.transpose(0, 1).reshape(n_sets * len(seeds), d, p), Mmap)


def stacked_lanes(cfg, Q, xs, dxs, hp, seeds, lbfgs_subsample, device,
                  subsample_idx=None, theta0=None):
    """The kernel launch of the datasets x seeds sweep: (kernel config,
    (S, B, q, n_elems, theta0) with lane = dataset * n_seeds + seed, Mmap).
    subsample_idx and theta0, when given, replace the per-seed draws: a
    list of one (n_seeds, k) and one (n_seeds, n_params) array per dataset."""
    xs = [_as_f32(x, device) for x in xs]
    dxs = [_as_f32(dx, device) for dx in dxs]
    n_seeds = len(seeds)
    pcfg, Mmap, n_params = _kernel_setup(cfg, Q, hp, device)
    if theta0 is None:
        th0 = _init_theta(seeds, n_params, device).repeat(len(xs), 1)
    else:
        th0 = torch.cat([_as_f32(t, device).reshape(n_seeds, n_params) for t in theta0])
    drawn = {}
    parts = []
    for i, (x, dx) in enumerate(zip(xs, dxs)):
        k = int(x.shape[0] * lbfgs_subsample)
        idx = _seed_rows(drawn, seeds, x.shape[0], k, device,
                         None if subsample_idx is None else subsample_idx[i])
        parts.append(_prep_normal_eq(cfg, k, x, dx, idx))
    S, B, q, ne = (torch.cat(t) for t in zip(*parts))
    return pcfg, (S, B, q, ne, th0.contiguous()), Mmap


def _init_states(cfg: SINDyConfig, Q, seeds, device) -> SINDyState:
    """init_sindy of each seed (generator 2s + 1), stacked along a leading
    seed dimension (Q shared). The solvers overwrite these draws, so they
    do not reach a sweep's result."""
    sts = [init_sindy(_generator(s, 1, device), cfg, Q, device) for s in seeds]
    return SINDyState(Xi=torch.stack([st.Xi for st in sts]),
                      mask=torch.stack([st.mask for st in sts]),
                      beta=torch.stack([st.beta for st in sts]),
                      const=torch.stack([st.const for st in sts]), Q=sts[0].Q)


# rows x dims x terms (f32) that one chunk of STLSQ's batched QR may hold:
# 16 seeds of the 2,000,000-row LV system (64 MB a QR)
STLSQ_CHUNK_BYTES = 2 << 30


def sweep_sindy_stlsq(
    cfg: SINDyConfig,
    Q: Optional[np.ndarray],
    x,
    dx,
    truth: np.ndarray,
    seeds: Sequence[int],
    w_sindy_reg: float = 0.0,
    threshold: float = 5e-2,
    subsample: float = 1.0,
    max_iter: int = 5,
    subsample_idx: Optional[np.ndarray] = None,
    device=None,
    n_mesh_devices: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> SweepResult:
    """Direct STLSQ over ``seeds``: each seed's subsample of int(N *
    subsample) rows (all N, in another order, at 1.0), ``max_iter``
    iterations of the masked ridge solve and threshold. Seeds are solved in
    chunks whose batched QR fits STLSQ_CHUNK_BYTES (on each shard's device
    on a mesh). subsample_idx (n_seeds, k) replaces the per-seed torch
    draws."""
    device = resolve_device(device)
    n, d, p = len(x), cfg.latent_dim, cfg.n_terms
    k = int(n * subsample)
    seeds = list(seeds)
    if subsample_idx is not None and tuple(np.shape(subsample_idx)) != (len(seeds), k):
        raise ValueError(f"subsample_idx {np.shape(subsample_idx)} != ({len(seeds)}, {k})")

    def run_shard(pos, dev):
        xd, dxd = _as_f32(x, dev), _as_f32(dx, dev)
        sub_seeds = [seeds[i] for i in pos]
        chunk = max(1, STLSQ_CHUNK_BYTES // (4 * d * (k + p) * p))
        Xis, masks = [], []
        for lo in range(0, len(sub_seeds), chunk):
            sub = sub_seeds[lo:lo + chunk]
            if subsample_idx is None:
                idx = _subsample_idx(sub, n, k, dev)
            else:
                idx = torch.as_tensor(_rows(subsample_idx, pos[lo:lo + chunk]),
                                      dtype=torch.long, device=dev)
            state = _init_states(cfg, Q, sub, dev)
            state, _ = solve_sindy(cfg, state, xd[idx], dxd[idx], w_sindy_reg, threshold,
                                   max_iter)
            Xis.append(get_Xi(cfg, state))
            masks.append(state.mask)
        return torch.cat(Xis).reshape(len(pos), d * p), torch.cat(masks)

    mesh = resolve_mesh(n_mesh_devices, mesh, len(seeds), device, True)
    Xi, mask = shard_sweep(run_shard, mesh)(list(range(len(seeds))))
    return _finalize(Xi, mask, None, d, p, truth)


def wsindy_windows(seeds, n_ics: int, n_steps: int, w: int, subsample_rng: str = "jax"):
    """(n_seeds, 2) int64 (start, trajectory) of each seed's window of w
    steps. "ref": the reference's draws, np.random.RandomState(seed), then
    randint(0, n_steps - w) and randint(0, n_ics); "jax" (the JAX
    package's default name): the port's own draws, from a CPU
    torch.Generator seeded 2s, which are not the JAX package's (those come
    from a draws file, tools/dump_jax_draws.py)."""
    out = []
    for s in seeds:
        if subsample_rng == "ref":
            rs = np.random.RandomState(int(s))
            out.append((rs.randint(0, n_steps - w), rs.randint(0, n_ics)))
        elif subsample_rng == "jax":
            g = _generator(s, 0, "cpu")
            out.append((int(torch.randint(0, n_steps - w, (), generator=g)),
                        int(torch.randint(0, n_ics, (), generator=g))))
        else:
            raise ValueError(f"subsample_rng {subsample_rng!r}: 'jax' or 'ref'")
    return np.asarray(out, np.int64).reshape(len(out), 2)


def sweep_wsindy(
    cfg: SINDyConfig,
    x_trajs,
    dt: float,
    truth: np.ndarray,
    seeds: Sequence[int],
    w_sindy_reg: float = 0.0,
    threshold: float = 5e-2,
    num_epochs: int = 10,
    num_test_funcs: int = 50,
    subsample_rng: str = "jax",
    windows: Optional[np.ndarray] = None,
    device=None,
    n_mesh_devices: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> SweepResult:
    """WSINDy over ``seeds``, all at once (all of a shard's on a mesh): per
    seed one trajectory of x_trajs (n_ics, n_steps, dim) and a window of 80%
    of its steps, solved ``num_epochs`` times. ``windows`` (n_seeds, 2) of
    (start, trajectory) replaces the draws that ``subsample_rng`` names
    (wsindy_windows)."""
    device = resolve_device(device)
    n_ics, n_steps, _ = x_trajs.shape
    w = int(0.8 * n_steps)
    seeds = list(seeds)
    if windows is None:
        windows = wsindy_windows(seeds, n_ics, n_steps, w, subsample_rng)
    windows = np.asarray(windows)
    if windows.shape != (len(seeds), 2):
        raise ValueError(f"windows {windows.shape} != ({len(seeds)}, 2)")
    if not ((0 <= windows[:, 0]).all() and (windows[:, 0] <= n_steps - w).all()
            and (0 <= windows[:, 1]).all() and (windows[:, 1] < n_ics).all()):
        raise ValueError(f"a window lies outside {n_ics} trajectories of {n_steps} steps "
                         f"(window {w} steps)")
    d, p = cfg.latent_dim, cfg.n_terms

    def run_shard(pos, dev):
        xt = _as_f32(x_trajs, dev)
        t = torch.arange(w, dtype=torch.float32, device=dev) * dt
        mats = make_wsindy_matrices(t, float(w * dt), num_test_funcs=num_test_funcs)
        win = torch.as_tensor(_rows(windows, pos), dtype=torch.long, device=dev)
        steps = win[:, :1] + torch.arange(w, device=dev)
        traj = xt[win[:, 1:], steps]          # (seeds, w, dim)
        state = _init_states(cfg, None, [seeds[i] for i in pos], dev)
        state, _ = solve_wsindy(cfg, state, mats, traj, w_sindy_reg, threshold, num_epochs)
        return state.Xi.reshape(len(pos), d * p), state.mask

    mesh = resolve_mesh(n_mesh_devices, mesh, len(seeds), device, True)
    Xi, mask = shard_sweep(run_shard, mesh)(list(range(len(seeds))))
    return _finalize(Xi, mask, None, d, p, truth)
