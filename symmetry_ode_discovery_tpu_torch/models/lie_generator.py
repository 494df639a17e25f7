"""Lie-algebra generator: representation parsing and the basis of the
learned symmetry.

The port's copy of the parts of symmetry_ode_discovery_tpu/models/
lie_generator.py that equation discovery reads from a frozen LaLiGAN
checkpoint: ``BlockSpec``, ``GeneratorSpec``, ``parse_repr``,
``GeneratorState``, ``init_generator``, ``_effective_Li``,
``get_full_basis_list`` and ``get_deterministic_group_elems`` (the group
elements of EquivGP-r). Group sampling, the regularisers and thresholding
belong to LaLiGAN training and are still to port.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import numpy as np
import torch


def so(n: int) -> np.ndarray:
    """so(n) basis (n(n-1)/2, n, n): for each i, each j < i, L[i, j] = 1 and
    L[j, i] = -1."""
    L = np.zeros((n * (n - 1) // 2, n, n), dtype=np.float32)
    k = 0
    for i in range(n):
        for j in range(i):
            L[k, i, j] = 1.0
            L[k, j, i] = -1.0
            k += 1
    return L


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


def _effective_Li(spec: GeneratorSpec, state: GeneratorState, i: int) -> torch.Tensor:
    """f(Li) * mask: skew part for '(c,ch,d,o)' blocks, mask on learnable
    blocks (no integer rounding: that applies only when sampling)."""
    b = spec.blocks[i]
    L = state.Li[i]
    if b.skew:
        L = L - L.transpose(-1, -2)
    if b.learnable:
        L = L * state.masks[i]
    return L


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
