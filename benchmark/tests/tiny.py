"""Cells at a size the CPU runs in seconds: the committed cells' files with
the widths cut (hidden 16, two layers), short trajectories, few lanes and a
small batch, and a random LaLiGAN checkpoint in the JAX package's layout."""

from __future__ import annotations

import copy
import os

import numpy as np

from benchmark import harness

HIDDEN, LAYERS = 16, 2
SWEEP, LALIGAN = "eqsindy_r.lv99.chunk50", "laligan.lv99.b8192"


def write_checkpoint(directory, seed: int = 0, hidden: int = HIDDEN, layers: int = LAYERS):
    """autoencoder.npz, generator.npz and generator_mask.npz of a random
    trained-looking LaLiGAN (repr (2,1,2), latent 2) under ``directory``."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    ae = {}
    dims = [2] + [hidden] * layers
    for k, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ae[f"['params']/['encoder']/['Dense_{k}']/['kernel']"] = f32(a, b) / np.sqrt(a)
        ae[f"['params']/['encoder']/['Dense_{k}']/['bias']"] = 0.1 * f32(b)
        ae[f"['params']/['encoder']/['BatchNorm_{k}']/['scale']"] = 1 + 0.1 * f32(b)
        ae[f"['params']/['encoder']/['BatchNorm_{k}']/['bias']"] = 0.1 * f32(b)
        ae[f"['batch_stats']/['encoder']/['BatchNorm_{k}']/['mean']"] = 0.1 * f32(b)
        ae[f"['batch_stats']/['encoder']/['BatchNorm_{k}']/['var']"] = 1 + 0.1 * f32(b) ** 2
    ae["['params']/['encoder']/['OrthoDense_0']/['V']"] = f32(hidden, 2)
    ae["['params']/['encoder']/['OrthoDense_0']/['bias']"] = 0.1 * f32(2)
    ae["['params']/['encoder']/['bn_final']/['scale']"] = 1 + 0.1 * f32(2)
    ae["['params']/['encoder']/['bn_final']/['bias']"] = 0.1 * f32(2)
    ae["['batch_stats']/['encoder']/['bn_final']/['mean']"] = 0.1 * f32(2)
    ae["['batch_stats']/['encoder']/['bn_final']/['var']"] = 1 + 0.1 * f32(2) ** 2
    dims = [2] + [hidden] * layers + [2]
    for k, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ae[f"['params']/['decoder']/['Dense_{k}']/['kernel']"] = f32(a, b) / np.sqrt(a)
        ae[f"['params']/['decoder']/['Dense_{k}']/['bias']"] = 0.1 * f32(b)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "autoencoder.npz"), **ae)
    np.savez(os.path.join(directory, "generator.npz"), **{
        "['Li']/[0]": np.array([[[0.0, 1.0], [-1.0, 0.1]]], np.float32) + 0.1 * f32(1, 2, 2),
        "['sigma']/[0]": np.ones((1, 1), np.float32),
        "['struct_const']/[0]": np.zeros((1, 1, 1), np.float32)})
    np.savez(os.path.join(directory, "generator_mask.npz"), **{"[0]": np.ones((1, 2, 2), np.float32)})


def cell(name: str, tmp_path=None) -> dict:
    """The committed cell ``name`` cut to the CPU's size; the sweep's
    checkpoint written under ``tmp_path``."""
    c = copy.deepcopy(harness.cell(name))
    cfg = c["config"]
    cfg["argv"] = cfg["argv"] + ["--hidden_dim", str(HIDDEN), "--n_layers", str(LAYERS)]
    cfg["data"].update(n_ics=4, num_steps=600)
    if name == SWEEP:
        root = os.path.join(str(tmp_path), "ckpt")
        write_checkpoint(os.path.join(root, "laligan-noise99-lv"))
        cfg["checkpoint_root"] = root
        c["traffic"]["seed_chunk"] = 6
    else:
        c["traffic"]["batch_size"] = 256
    return c
