"""Checkpoints as .npz archives: the LaLiGAN artifacts in the JAX package's
layout, and full training-state snapshots for --resume.

The port's copy of symmetry_ode_discovery_tpu/utils/checkpoint.py. A tree
(dicts, lists and tuples of tensors or arrays) is stored one array per leaf
under the JAX package's key of that leaf: "['params']/['encoder']/['Dense_0']/
['kernel']" for dict keys, "[0]" for sequence indices. So ``save_laligan``
writes autoencoder.npz, discriminator.npz, generator.npz and
generator_mask.npz that the JAX package's ``load_laligan`` reads, and
``convert.laligan_from_npz`` reads them back; ``save_regressor`` writes the
joint SINDy regression's regressor.npz (keys "['Xi']" and "['mask']", the
JAX CLI's), which the JAX package's ``load_pytree`` and ``load_regressor``
read. Every function takes the root
directory (``root``, default saved_models), which the CLI sets from
--save_root.

Snapshots (train_state_epNNNNN.npz) hold the trainer's state, its torch
generators' states, the metric history, the held-out metric and the EMA.
Unlike the JAX package's ``best_train_state``, a NaN held-out metric never
counts as the best.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Optional

import numpy as np
import torch

_HIST = "__hist__/"
_VAL_KEY = "__valmetric__"
_EMA = "__ema__/"
_SNAPSHOT = re.compile(r"train_state_ep(\d+)\.npz")


def _key(k) -> str:
    return f"[{k}]" if isinstance(k, int) else f"['{k}']"


def _leaves(tree: Any, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (_key(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (_key(i),))
    else:
        yield "/".join(prefix) or "_root", tree


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def flatten(tree: Any) -> dict:
    """{JAX-style key: numpy array} of every leaf of ``tree``."""
    return {k: _np(v) for k, v in _leaves(tree)}


def save_pytree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten(tree))


def _fill(like: Any, data, prefix=()):
    if isinstance(like, dict):
        return type(like)((k, _fill(v, data, prefix + (_key(k),))) for k, v in like.items())
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, data, prefix + (_key(i),)) for i, v in enumerate(like))
    key = "/".join(prefix) or "_root"
    if key not in data.files:
        raise KeyError(f"checkpoint missing key {key}")
    arr = data[key]
    if tuple(np.shape(arr)) != tuple(np.shape(_np(like))):
        raise ValueError(f"shape mismatch for {key}: checkpoint {np.shape(arr)} vs "
                         f"model {tuple(np.shape(_np(like)))}")
    if isinstance(like, torch.Tensor):
        # (ascontiguousarray makes a 0-d array 1-d)
        return torch.as_tensor(np.ascontiguousarray(arr).reshape(arr.shape)).to(like.dtype)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def load_pytree(path: str, like: Any) -> Any:
    """The tree saved at ``path`` in the structure of ``like`` (leaves
    replaced, shapes checked, dtypes as like's; tensors on the CPU)."""
    with np.load(path, allow_pickle=False) as data:
        return _fill(like, data)


def save_train_state(path: str, state: Any, history=(), val_metric: Optional[float] = None,
                     ema_ae=None) -> None:
    """A full training snapshot: ``state`` (any tree), the metric history
    (a metric missing from an epoch round-trips as NaN), the held-out metric
    (lower is better) and the EMA parameters when there are any."""
    flat = flatten(state)
    if val_metric is not None:
        flat[_VAL_KEY] = np.asarray(float(val_metric), np.float64)
    for k in sorted({k for h in history for k in h}):
        flat[_HIST + k] = np.asarray([h.get(k, float("nan")) for h in history], np.float64)
    for i, t in enumerate(ema_ae or ()):
        flat[f"{_EMA}{i}"] = _np(t)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_train_state(path: str, like: Any):
    """(state, history, extra) saved by save_train_state; ``like`` gives the
    state's structure. ``extra`` holds "ema_ae" (a list of tensors, or None
    when the snapshot has no EMA) and "val_metric" (or None)."""
    state = load_pytree(path, like)
    with np.load(path, allow_pickle=False) as data:
        hist_keys = sorted(k for k in data.files if k.startswith(_HIST))
        n = len(data[hist_keys[0]]) if hist_keys else 0
        history = [{k[len(_HIST):]: float(data[k][i]) for k in hist_keys} for i in range(n)]
        ema_keys = sorted((k for k in data.files if k.startswith(_EMA)),
                          key=lambda k: int(k[len(_EMA):]))
        ema = [torch.as_tensor(data[k]) for k in ema_keys] or None
        val = float(data[_VAL_KEY]) if _VAL_KEY in data.files else None
    return state, history, {"ema_ae": ema, "val_metric": val}


def train_state_path(save_dir: str, epochs_done: int, root: str = "saved_models") -> str:
    return os.path.join(root, save_dir, f"train_state_ep{epochs_done:05d}.npz")


def _snapshots(save_dir: str, root: str):
    d = os.path.join(root, save_dir)
    if not os.path.isdir(d):
        return d, []
    return d, sorted((int(m.group(1)), f) for f in os.listdir(d)
                     if (m := _SNAPSHOT.fullmatch(f)))


def latest_train_state(save_dir: str, root: str = "saved_models"):
    """(path, epochs_done) of the newest snapshot under root/save_dir, or
    None."""
    d, snaps = _snapshots(save_dir, root)
    return (os.path.join(d, snaps[-1][1]), snaps[-1][0]) if snaps else None


def snapshot_val_metric(path: str):
    """The held-out metric recorded with a snapshot, or None."""
    with np.load(path, allow_pickle=False) as z:
        return float(z[_VAL_KEY]) if _VAL_KEY in z.files else None


def best_train_state(save_dir: str, root: str = "saved_models"):
    """(path, epoch, val_metric) of the snapshot with the lowest finite
    held-out metric under root/save_dir, or None. A NaN metric is never the
    best (the JAX package's comparison keeps a first NaN for good)."""
    d, snaps = _snapshots(save_dir, root)
    best = None
    for ep, f in snaps:
        v = snapshot_val_metric(os.path.join(d, f))
        if v is not None and math.isfinite(v) and (best is None or v < best[2]):
            best = (os.path.join(d, f), ep, v)
    return best


def prune_train_states(save_dir: str, keep: int, root: str = "saved_models") -> None:
    """Delete all snapshots but the newest ``keep`` and the best by held-out
    metric; keep <= 0 keeps everything."""
    if keep <= 0:
        return
    d, snaps = _snapshots(save_dir, root)
    protect = {f for _, f in snaps[-keep:]}
    best = best_train_state(save_dir, root)
    if best is not None:
        protect.add(os.path.basename(best[0]))
    for _, f in snaps:
        if f not in protect:
            os.remove(os.path.join(d, f))


def save_laligan(save_dir: str, trainer, root: str = "saved_models") -> str:
    """autoencoder.npz, discriminator.npz, generator.npz and
    generator_mask.npz of ``trainer`` (training.lassi.LassiTrainer) under
    root/save_dir, in the JAX package's layout; returns the directory."""
    from ..convert import lassi_to_jax

    d = os.path.join(root, save_dir)
    tree = lassi_to_jax(trainer.ae.state_dict(), trainer.disc.state_dict(), trainer.g_state)
    save_pytree(os.path.join(d, "autoencoder.npz"),
                {"params": tree["ae"], "batch_stats": tree["batch_stats"]})
    save_pytree(os.path.join(d, "discriminator.npz"), tree["d"])
    g = tree["g"]
    save_pytree(os.path.join(d, "generator.npz"),
                {"Li": g["Li"], "sigma": g["sigma"], "struct_const": g["struct_const"]})
    save_pytree(os.path.join(d, "generator_mask.npz"), g["masks"])
    return d


def save_regressor(directory: str, Xi, mask) -> str:
    """regressor.npz under ``directory``: the joint regression's Xi and mask
    (d, p), float32, in the JAX CLI's layout; returns its path."""
    path = os.path.join(directory, "regressor.npz")
    save_pytree(path, {"Xi": _np(Xi).astype(np.float32), "mask": _np(mask).astype(np.float32)})
    return path


def load_regressor(path: str, device=None) -> tuple:
    """(Xi, mask) float32 tensors on ``device`` (default the CPU) from a
    regressor.npz (a directory holding one, or the file)."""
    if os.path.isdir(path):
        path = os.path.join(path, "regressor.npz")
    with np.load(path, allow_pickle=False) as z:
        return tuple(torch.as_tensor(z[f"['{k}']"], device=device) for k in ("Xi", "mask"))


def load_laligan(load_dir: str, root: str = "saved_models", device=None):
    """(autoencoder state_dict, GeneratorState) of the LaLiGAN artifacts
    under root/load_dir (convert.laligan_from_npz; the discriminator is not
    read, as the JAX package's load_laligan does not restore it)."""
    from ..convert import laligan_from_npz

    return laligan_from_npz(os.path.join(root, load_dir), device)
