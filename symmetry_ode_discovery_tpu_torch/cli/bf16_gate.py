"""The bf16 gate of K2/K3 on LaLiGAN checkpoints of the flagship's
architecture (5 x 512), on the card.

    python -m symmetry_ode_discovery_tpu_torch.cli.bf16_gate \
        --ckpt saved_models/laligan-noise99-lv-s44 [--ckpt <dir> ...]

For each checkpoint: one EquivSINDy-r closure's inputs (4 seeds x 20,000
rows of the LV noise-0.99 train split, cached or generated), the four K2/K3
functions in bf16 against their bf16 plain versions (smoke_setup.k23_phase),
and one JSON line with each function's flip rows (rows gated by a forward
mask that differs from the plain chain's) as a share of the rows, beside
chip_smoke.py's gate of 0.1% (``over_gate`` lists the functions beyond it;
the encoder's forward is continuous in its masks and has no row gate). The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", action="append", required=True,
                    help="a checkpoint directory (autoencoder.npz, generator.npz, "
                         "generator_mask.npz); repeat for more")
    a = ap.parse_args(argv)
    from .. import resolve_device
    from ..data.datasets import load_or_generate
    from ..smoke_setup import bf16_gate_phase

    dev = resolve_device(None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    x, _ = load_or_generate("lv", "train", 0.99, "gp", device=dev)
    x = x.reshape(-1, 2)
    for ckpt in a.ckpt:
        bf16_gate_phase(dev, x, ckpt, lambda rec: print(json.dumps(rec), flush=True))


if __name__ == "__main__":
    main()
