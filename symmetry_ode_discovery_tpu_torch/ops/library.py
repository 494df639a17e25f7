"""SINDy function library Theta(x) on tensors.

Term order, which the ground-truth tables depend on:

    [const, z_0..z_{n-1},
     z_i*z_j (i<=j),            if poly_order > 1
     z_i*z_j*z_k (i<=j<=k),     if poly_order > 2
     sin(z_0)..sin(z_{n-1}),    if include_sine
     exp(z_0)..exp(z_{n-1})]    if include_exp

Each monomial of order <= 3 is the product of three entries of the augmented
vector [1, z_0..z_{n-1}], picked by a precomputed index table, multiplied in
the same order as the JAX package's library.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


def poly_index_table(dim: int, poly_order: int) -> np.ndarray:
    """Index table (n_poly_terms, 3) into [1, z_0..z_{n-1}]: index 0 is the
    constant 1, index i+1 is z_i."""
    rows: List[Tuple[int, int, int]] = [(0, 0, 0)]
    for i in range(dim):
        rows.append((i + 1, 0, 0))
    if poly_order > 1:
        for i in range(dim):
            for j in range(i, dim):
                rows.append((i + 1, j + 1, 0))
    if poly_order > 2:
        for i in range(dim):
            for j in range(i, dim):
                for k in range(j, dim):
                    rows.append((i + 1, j + 1, k + 1))
    return np.asarray(rows, dtype=np.int32)


def poly_exponent_table(dim: int, poly_order: int) -> np.ndarray:
    """Exponent matrix E (n_poly_terms, dim): term t = prod_d z_d ** E[t, d]."""
    idx = poly_index_table(dim, poly_order)
    E = np.zeros((idx.shape[0], dim), dtype=np.int32)
    for t, row in enumerate(idx):
        for a in row:
            if a > 0:
                E[t, a - 1] += 1
    return E


@dataclasses.dataclass(frozen=True)
class FunctionLibrary:
    """Description of the SINDy basis; calling it evaluates Theta(x)."""

    dim: int
    poly_order: int = 2
    include_sine: bool = False
    include_exp: bool = False

    @property
    def n_poly_terms(self) -> int:
        n = self.dim + 1
        if self.poly_order > 1:
            n += self.dim * (self.dim + 1) // 2
        if self.poly_order > 2:
            n += (self.dim ** 3 + 3 * self.dim ** 2 + 2 * self.dim) // 6
        return n

    @property
    def n_terms(self) -> int:
        n = self.n_poly_terms
        if self.include_sine:
            n += self.dim
        if self.include_exp:
            n += self.dim
        return n

    def index_table(self) -> np.ndarray:
        return poly_index_table(self.dim, self.poly_order)

    def exponent_table(self) -> np.ndarray:
        return poly_exponent_table(self.dim, self.poly_order)

    def _factors(self, x: torch.Tensor, fill: float):
        """The three factors of every monomial: entries of [fill, x_0..x_{n-1}],
        picked by products with one-hot selection matrices (exact for finite
        entries); their backward is a product too, where a gather's would sum
        with atomics in a different order on every run."""
        idx = torch.as_tensor(self.index_table(), dtype=torch.long, device=x.device)
        aug = torch.cat([torch.full_like(x[..., :1], fill), x], dim=-1)
        eye = torch.eye(self.dim + 1, dtype=x.dtype, device=x.device)
        return [aug @ eye[:, idx[:, k]] for k in range(3)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluate Theta(x): (..., dim) -> (..., n_terms)."""
        a0, a1, a2 = self._factors(x, 1.0)
        blocks = [a0 * a1 * a2]
        if self.include_sine:
            blocks.append(torch.sin(x))
        if self.include_exp:
            blocks.append(torch.exp(x))
        return torch.cat(blocks, dim=-1)

    def jvp(self, x: torch.Tensor, t: torch.Tensor):
        """(Theta(x), dTheta(x)[t]): the library and its derivative along t,
        by the product rule in the order autodiff of ``__call__`` applies it
        ((t0 a1 + a0 t1) a2 + (a0 a1) t2), as explicit tensor operations."""
        a0, a1, a2 = self._factors(x, 1.0)
        t0, t1, t2 = self._factors(t, 0.0)
        a01 = a0 * a1
        blocks, tangents = [a01 * a2], [(t0 * a1 + a0 * t1) * a2 + a01 * t2]
        if self.include_sine:
            blocks.append(torch.sin(x))
            tangents.append(t * torch.cos(x))
        if self.include_exp:
            e = torch.exp(x)
            blocks.append(e)
            tangents.append(t * e)
        return torch.cat(blocks, dim=-1), torch.cat(tangents, dim=-1)

    def term_names(self, var: str = "z") -> List[str]:
        """Term names in library order, for printing equations."""
        names = ["1"]
        d = self.dim
        for i in range(d):
            names.append(f"{var}{i}")
        if self.poly_order > 1:
            for i in range(d):
                for j in range(i, d):
                    names.append(f"{var}{i}*{var}{j}")
        if self.poly_order > 2:
            for i in range(d):
                for j in range(i, d):
                    for k in range(j, d):
                        names.append(f"{var}{i}*{var}{j}*{var}{k}")
        if self.include_sine:
            for i in range(d):
                names.append(f"sin({var}{i})")
        if self.include_exp:
            for i in range(d):
                names.append(f"exp({var}{i})")
        return names
