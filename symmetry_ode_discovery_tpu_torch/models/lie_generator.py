"""Lie-algebra generator: representation parsing and the basis of the
learned symmetry.

The port's copy of symmetry_ode_discovery_tpu/models/lie_generator.py:
what equation discovery reads from a frozen LaLiGAN checkpoint
(``parse_repr``, ``GeneratorState``, ``get_full_basis_list``,
``get_deterministic_group_elems``, the group elements of EquivGP-r) and what
LaLiGAN training runs: the regularisers, coefficient and group-element
sampling, the random transformation of a batch and sequential thresholding.

Only the ``Li`` and ``struct_const`` of learnable blocks train
(``trainable_filter``); ``sigma`` and ``masks`` are buffers. Random draws
come from a ``torch.Generator``; ``sample_coefficient`` and
``generator_forward`` also take the draws themselves (``draw``, ``coef``),
which is how the JAX package's draws are replayed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.lie import expm, so


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One component of the representation string."""

    n_comps: int
    n_channels: int
    block_dim: int
    learnable: bool
    skew: bool  # L - L^T (the '(c,ch,d,o)' form)
    group_idx: str
    fixed_Li: Optional[np.ndarray]  # (n_channels, d, d) for fixed groups
    sigma_trainable: bool


@dataclasses.dataclass(frozen=True)
class GeneratorSpec:
    blocks: Tuple[BlockSpec, ...]
    n_dims: int
    coef_dist: str
    uniform_max: float
    sigma_init: float
    keep_center: bool
    int_param: bool
    int_param_max: int
    int_param_noise: float
    threshold: float  # gan_st_thres

    @property
    def group_ids(self) -> List[str]:
        """Unique group indices in first-appearance order."""
        seen = []
        for b in self.blocks:
            if b.group_idx not in seen:
                seen.append(b.group_idx)
        return seen


_FIXED_GROUPS = {
    "so2": (np.array([[[0.0, 1.0], [-1.0, 0.0]]], np.float32), 2),
    "sim2": (np.array([[[-0.2, 1.0], [-1.0, 0.0]]], np.float32), 2),
    "scaling2": (np.array([[[2.0, 0.0], [0.0, 1.0]]], np.float32), 2),
    "so2*r": (np.array([[[0.0, 1.0], [-1.0, 0.0]],
                        [[0.1, 0.0], [0.0, 0.1]]], np.float32), 2),
}


def parse_repr(repr_str: str, group_idx: str, **kwargs) -> GeneratorSpec:
    """Parse a representation string such as '(2,1,2)', '(1,so2)' or
    '(N,so3+1)': every parenthesised tuple is one block."""
    tuples = [tuple(e.strip() for e in m.split(",") if e.strip())
              for m in re.findall(r"\(([^()]*)\)", repr_str)]
    gidx = [g.strip() for g in group_idx.split(",")]
    if len(gidx) != len(tuples):
        raise ValueError("Number of group indices does not match number of components "
                         "in representation string.")
    blocks = []
    n_dims = 0
    for i, (r, gi) in enumerate(zip(tuples, gidx)):
        if len(r) >= 3:
            skew = False
            if len(r) == 4:
                if r[3] == "o":
                    skew = True
                else:
                    raise ValueError(f"Group {r[3]} not implemented yet.")
            n_comps, n_channels, d = int(r[0]), int(r[1]), int(r[2])
            blocks.append(BlockSpec(n_comps, n_channels, d, True, skew, gi, None, False))
            n_dims += d * n_comps
        elif len(r) == 1:
            n_comps = int(r[0])
            blocks.append(BlockSpec(1, 1, n_comps, False, False, gi,
                                    np.zeros((1, n_comps, n_comps), np.float32), True))
            n_dims += n_comps
        elif len(r) == 2:
            n_comps, gname = int(r[0]), r[1]
            if gname in _FIXED_GROUPS:
                Li, d = _FIXED_GROUPS[gname]
            elif gname == "so3":
                Li, d = so(3), 3
            elif gname == "so3+1":
                Li = np.zeros((3, 4, 4), np.float32)
                Li[:, :3, :3] = so(3)
                d = 4
            elif gname == "so4":
                Li, d = so(4), 4
            else:
                raise ValueError(f"Group {gname} not implemented yet.")
            blocks.append(BlockSpec(n_comps, Li.shape[0], d, False, False, gi,
                                    np.asarray(Li, np.float32), False))
            n_dims += d * n_comps
        else:
            raise ValueError(f"Invalid representation string at position {i}: {r}")
    by_idx = {}
    for b in blocks:
        by_idx.setdefault(b.group_idx, []).append(b.n_channels)
    for k, v in by_idx.items():
        if len(set(v)) > 1:
            raise ValueError(f"Group index {k} contains channels of different dimensions.")
    return GeneratorSpec(
        blocks=tuple(blocks), n_dims=n_dims,
        coef_dist=kwargs.get("coef_dist", "normal"),
        uniform_max=kwargs.get("uniform_max", 1.0),
        sigma_init=kwargs.get("sigma_init", 1.0),
        keep_center=kwargs.get("keep_center", False),
        int_param=kwargs.get("int_param", False),
        int_param_max=kwargs.get("int_param_max", 2),
        int_param_noise=kwargs.get("int_param_noise", 0.1),
        threshold=kwargs.get("gan_st_thres", 0.3),
    )


@dataclasses.dataclass
class GeneratorState:
    """Parameters and masks; tuples are aligned with spec.blocks."""

    Li: Tuple[torch.Tensor, ...]            # each (n_channels, d, d)
    sigma: Tuple[torch.Tensor, ...]         # each (n_channels, n_channels)
    struct_const: Tuple[torch.Tensor, ...]  # each (ch, ch, ch)
    masks: Tuple[torch.Tensor, ...]         # each (n_channels, d, d)


def init_generator(spec: GeneratorSpec, generator: torch.Generator,
                   device=None) -> GeneratorState:
    """Standard-normal Li for learnable blocks (torch draws), the fixed
    algebra for fixed groups, sigma = sigma_init * I (I for the scalar
    block), zero structure constants, all-one masks."""
    Li, sigma, struct_const, masks = [], [], [], []
    for b in spec.blocks:
        shape = (b.n_channels, b.block_dim, b.block_dim)
        if b.learnable:
            Li.append(torch.randn(shape, generator=generator,
                                  device=generator.device).to(device))
        else:
            Li.append(torch.as_tensor(b.fixed_Li, device=device))
        s0 = 1.0 if b.sigma_trainable else spec.sigma_init
        sigma.append(torch.eye(b.n_channels, device=device) * s0)
        struct_const.append(torch.zeros((b.n_channels,) * 3, device=device))
        masks.append(torch.ones(shape, device=device))
    return GeneratorState(tuple(Li), tuple(sigma), tuple(struct_const), tuple(masks))


def trainable_filter(spec: GeneratorSpec, state: GeneratorState) -> GeneratorState:
    """Which leaves of the state train: the Li and struct_const of
    learnable blocks; sigma and the masks never do."""
    return GeneratorState(
        Li=tuple(b.learnable for b in spec.blocks),
        sigma=tuple(False for _ in spec.blocks),
        struct_const=tuple(b.learnable for b in spec.blocks),
        masks=tuple(False for _ in spec.blocks))


def _effective_Li(spec: GeneratorSpec, state: GeneratorState, i: int,
                  generator: Optional[torch.Generator] = None,
                  int_round: bool = False) -> torch.Tensor:
    """f(Li) * mask: skew part for '(c,ch,d,o)' blocks, mask on learnable
    blocks. ``int_round`` (group sampling only, as in the reference) rounds
    k * (Li + noise) clipped to [-k - 0.49, k + 0.49] on learnable blocks
    under --int_param, the noise drawn from ``generator`` when given."""
    b = spec.blocks[i]
    L = state.Li[i]
    if b.skew:
        L = L - L.transpose(-1, -2)
    if int_round and b.learnable and spec.int_param:
        noise = (torch.randn(L.shape, generator=generator, device=generator.device).to(L.device)
                 * spec.int_param_noise if generator is not None else 0.0)
        k = spec.int_param_max
        L = torch.round(torch.clamp(k * (L + noise), -k - 0.49, k + 0.49))
    if b.learnable:
        L = L * state.masks[i]
    return L


def _zero(state: GeneratorState) -> torch.Tensor:
    return torch.zeros((), dtype=state.Li[0].dtype, device=state.Li[0].device)


def reg_norm(spec: GeneratorSpec, state: GeneratorState) -> torch.Tensor:
    """Sum over learnable channels of max(0, 0.5 - |f(L) * mask|^2)."""
    s = _zero(state)
    for i, b in enumerate(spec.blocks):
        if b.learnable:
            L = _effective_Li(spec, state, i)
            sq = torch.einsum("kdf,kdf->k", L, L)
            s = s + torch.clamp(0.5 - sq, min=0.0).sum()
    return s


def _normalized_Li(spec, state, i):
    L = _effective_Li(spec, state, i)
    norm = torch.einsum("kdf,kdf->k", L, L)
    return L / (torch.sqrt(norm)[:, None, None] + 1e-6)


def reg_ortho(spec: GeneratorSpec, state: GeneratorState) -> torch.Tensor:
    """Sum of the squared off-diagonal Gram entries of the normalised
    channels of each learnable block."""
    s = _zero(state)
    for i, b in enumerate(spec.blocks):
        if b.learnable:
            Ln = _normalized_Li(spec, state, i)
            gram = torch.einsum("bij,cij->bc", Ln, Ln)
            s = s + torch.square(torch.triu(gram, diagonal=1)).sum()
    return s


def reg_closure(spec: GeneratorSpec, state: GeneratorState) -> torch.Tensor:
    """Lie closure with learned structure constants: sum over channel pairs
    a < b of |[L_a, L_b] - sum_k c[a, b, k] L_k|^2 on the normalised
    channels."""
    s = _zero(state)
    for i, b in enumerate(spec.blocks):
        if not b.learnable:
            continue
        Ln = _normalized_Li(spec, state, i)
        c = state.struct_const[i]
        for a in range(b.n_channels):
            for bb in range(a + 1, b.n_channels):
                comm = Ln[a] @ Ln[bb] - Ln[bb] @ Ln[a]
                target = torch.einsum("k,kij->ij", c[a, bb], Ln)
                s = s + torch.square(comm - target).sum()
    return s


def sample_coefficient(spec: GeneratorSpec, generator: Optional[torch.Generator],
                       batch_size: int, n_channels: int, sigma: torch.Tensor,
                       activated_channel: Optional[int] = None,
                       draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(batch, n_channels) coefficients of one group index. The amplitude of
    every coef_dist mode is sigma (the reference binds it there; uniform_max
    never reaches sampling): normal draws @ sigma; uniform u * 2 sigma -
    sigma with u in [0, 1) (a broadcast that holds at one channel); the
    integer grid, integers in [-b, b) with b = floor(|sigma[0, 0]|).
    ``draw`` replaces the generator's draw (the standard normal, the uniform
    u or the integers). A generator's draw (float32) is cast to sigma's
    dtype, so that a float64 run draws what the float32 run does."""
    shape = (batch_size, n_channels)
    dev = sigma.device

    def rand(fn, **kw):
        if draw is not None:
            return draw.to(dev)
        return fn(size=shape, generator=generator, device=generator.device,
                  **kw).to(device=dev, dtype=sigma.dtype)

    if spec.coef_dist == "normal":
        z = rand(torch.randn) @ sigma
    elif spec.coef_dist == "uniform":
        z = rand(torch.rand) * 2 * sigma - sigma
    elif spec.coef_dist == "uniform_int_grid":
        bound = int(torch.floor(sigma.reshape(-1)[0].abs()))
        z = rand(lambda **kw: torch.randint(-bound, bound, **kw)).to(sigma.dtype)
    else:
        raise ValueError(f"Unknown coef_dist: {spec.coef_dist}")
    if activated_channel is not None:
        onehot = torch.zeros((n_channels,), dtype=z.dtype, device=dev)
        onehot[activated_channel] = 1.0
        z = z * onehot[None, :]
    return z


def sample_group_element(spec: GeneratorSpec, state: GeneratorState,
                         generator: Optional[torch.Generator], batch_size: int,
                         activated_channel: Optional[int] = None,
                         coef=None) -> torch.Tensor:
    """Random block-diagonal group element (batch, n_dims, n_dims): one
    coefficient draw per distinct group index (``coef[k]`` replacing the
    draw of the k-th of spec.group_ids), shared across its blocks, each block
    exp(sum_j z_j L_j) by ops.lie.expm."""
    z_dict = {}
    for k, gi in enumerate(spec.group_ids):
        i = next(j for j, b in enumerate(spec.blocks) if b.group_idx == gi)
        z_dict[gi] = sample_coefficient(spec, generator, batch_size, spec.blocks[i].n_channels,
                                        state.sigma[i], activated_channel,
                                        None if coef is None else coef[k])
    L0 = state.Li[0]
    g = torch.zeros((batch_size, spec.n_dims, spec.n_dims), dtype=L0.dtype, device=L0.device)
    start = 0
    for i, b in enumerate(spec.blocks):
        L = _effective_Li(spec, state, i, generator, int_round=True)
        g_z = expm(torch.einsum("bj,jkl->bkl", z_dict[b.group_idx], L))
        for _ in range(b.n_comps):
            end = start + b.block_dim
            g[:, start:end, start:end] = g_z
            start = end
    return g


def generator_forward(spec: GeneratorSpec, state: GeneratorState,
                      generator: Optional[torch.Generator], x: torch.Tensor,
                      activated_channel: Optional[int] = None, coef=None,
                      dp=None) -> torch.Tensor:
    """A random group element applied to each row of x (batch, *, n_dims),
    about the batch mean unless keep_center; ``coef`` as for
    sample_group_element. With ``dp`` (parallel/dp.DataParallel) x is this
    rank's slice of the global batch: the mean is the global batch's, and
    the group elements are drawn for the whole global batch (``coef`` its
    draws), this rank's rows taken, so every rank's generator stays in
    step and each row gets the draw it gets on one device."""
    dims = tuple(range(x.ndim - 1))
    if not spec.keep_center:
        x_mean = (x.mean(dim=dims, keepdim=True) if dp is None
                  else dp.mean(x, dim=dims, keepdim=True))
        x = x - x_mean
    shape = x.shape
    xb = x.reshape(shape[0], -1)
    n = shape[0] if dp is None else shape[0] * dp.world
    g = sample_group_element(spec, state, generator, n, activated_channel, coef)
    if dp is not None:
        g = g[dp.rows(n)]
    xt = torch.einsum("bij,bj->bi", g, xb).reshape(shape)
    if not spec.keep_center:
        xt = xt + x_mean
    return xt


def get_full_basis_list(spec: GeneratorSpec, state: GeneratorState,
                        split_channel: bool = True) -> List[torch.Tensor]:
    """Block-diagonal basis elements on the full latent space, grouped by
    group index: one (n_dims, n_dims) matrix per channel (split_channel), or
    one (ch, n_dims, n_dims) stack per group index."""
    start = 0
    per_group = {gi: [] for gi in spec.group_ids}
    for i, b in enumerate(spec.blocks):
        L = _effective_Li(spec, state, i)
        v = torch.zeros((b.n_channels, spec.n_dims, spec.n_dims), dtype=L.dtype,
                        device=L.device)
        for _ in range(b.n_comps):
            end = start + b.block_dim
            v[:, start:end, start:end] = L
            start = end
        per_group[b.group_idx].append(v)
    out = []
    for gi in spec.group_ids:
        tot = sum(per_group[gi])
        if split_channel:
            out.extend([tot[c] for c in range(tot.shape[0])])
        else:
            out.append(tot)
    return out


def get_deterministic_group_elems(spec: GeneratorSpec, state: GeneratorState,
                                  split_channel: bool = False,
                                  scale: float = 1.0) -> List[torch.Tensor]:
    """Deterministic group elements exp(sigma * L * scale) for the reversed
    symmetry penalty, one per basis element: sigma is each group's first
    block's (per channel with split_channel)."""
    basis = get_full_basis_list(spec, state, split_channel=split_channel)
    sigmas = []
    for gi in spec.group_ids:
        i = next(j for j, b in enumerate(spec.blocks) if b.group_idx == gi)
        sigmas.append(state.sigma[i])
    if split_channel:
        sigmas = [s[c, c] for s in sigmas for c in range(s.shape[0])]
    g_list = []
    for sigma, L in zip(sigmas, basis):
        if L.ndim == 3:
            for c in range(L.shape[0]):
                g_list.append(torch.linalg.matrix_exp(sigma[c, c] * L[c] * scale))
        else:
            g_list.append(torch.linalg.matrix_exp(sigma * L * scale))
    return g_list


def infinitesimal_transform(spec: GeneratorSpec, state: GeneratorState, x: torch.Tensor,
                            L_idx: int) -> torch.Tensor:
    """L @ x for the L_idx-th full-basis element, about the batch mean
    unless keep_center."""
    if not spec.keep_center:
        x = x - x.mean(dim=tuple(range(x.ndim - 1)), keepdim=True)
    shape = x.shape
    L = get_full_basis_list(spec, state)[L_idx]
    return torch.einsum("ij,bj->bi", L, x.reshape(shape[0], -1)).reshape(shape)


def set_threshold(spec: GeneratorSpec, state: GeneratorState,
                  threshold: float) -> GeneratorState:
    """Sequential thresholding: a learnable entry stays when |f(Li)| exceeds
    ``threshold`` times its channel's largest and its mask was set."""
    new_masks = []
    for i, b in enumerate(spec.blocks):
        if not b.learnable:
            new_masks.append(state.masks[i])
            continue
        L = state.Li[i].detach()
        if b.skew:
            L = L - L.transpose(-1, -2)
        max_ch = L.abs().amax(dim=(1, 2), keepdim=True)
        m = ((L.abs() > threshold * max_ch) & (state.masks[i] > 0)).to(state.masks[i].dtype)
        new_masks.append(m)
    return dataclasses.replace(state, masks=tuple(new_masks))


def getLi(spec: GeneratorSpec, state: GeneratorState) -> List[torch.Tensor]:
    """One (channels, n_dims, n_dims) basis stack per group index."""
    return get_full_basis_list(spec, state, split_channel=False)
