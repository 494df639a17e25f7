"""Reading a LaLiGAN checkpoint directory (autoencoder.npz, generator.npz,
generator_mask.npz in the JAX package's flat-key layout) into nested dicts
of float32 tensors, with no code of the program."""

from __future__ import annotations

import os

import numpy as np
import torch


def _nest(flat: dict) -> dict:
    """{"['params']/['encoder']/['Dense_0']/['kernel']": a} -> nested dicts;
    an all-digit key part becomes an int."""
    out: dict = {}
    for key, value in flat.items():
        parts = [p.strip("[]'\"") for p in key.split("/")]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(int(p) if p.isdigit() else p, {})
        last = parts[-1]
        node[int(last) if last.isdigit() else last] = value
    return out


def _tensors(node, device):
    if isinstance(node, dict):
        return {k: _tensors(v, device) for k, v in node.items()}
    return torch.tensor(np.asarray(node, dtype=np.float32), device=device)


def load(directory: str, device) -> dict:
    """{"autoencoder": {"params": ..., "batch_stats": ...}, "generator": {"Li":
    {0: ...}, "sigma": ..., "struct_const": ...}, "generator_mask": {0: ...}}."""
    out = {}
    for name in ("autoencoder", "generator", "generator_mask"):
        path = os.path.join(directory, f"{name}.npz")
        with np.load(path, allow_pickle=False) as z:
            out[name] = _tensors(_nest({k: z[k] for k in z.files}), device)
    return out
