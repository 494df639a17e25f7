"""Per-seed masks and coefficients of two run directories, the repository's
bar between two implementations of a sweep: masks equal per seed, and
coefficients within 1e-3 where they are.

    python -m symmetry_ode_discovery_tpu_torch.cli.compare_coefs <dir> --ref <dir> --seeds 0-49

Reads each directory's seed<N>.npz (the evaluation schema: ``coefficients``
is Xi * mask, so a seed's mask is where its coefficients are nonzero) and
prints one JSON line: the seeds compared, those whose masks are equal and
those whose are not, the largest |coefficient difference| over the seeds
whose masks are equal, and whether it is within --atol. Exits 1 when a seed
file is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def parse_seeds(text: str) -> list:
    """'0-49' or '0,3,7' -> a list of seeds."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def compare(run_dir: str, ref_dir: str, seeds, atol: float = 1e-3) -> dict:
    same, differ, max_diff = [], [], 0.0
    for s in seeds:
        with np.load(os.path.join(run_dir, f"seed{s}.npz")) as z:
            a = np.asarray(z["coefficients"], np.float64)
        with np.load(os.path.join(ref_dir, f"seed{s}.npz")) as z:
            b = np.asarray(z["coefficients"], np.float64)
        if np.array_equal(a != 0, b != 0):
            same.append(s)
            max_diff = max(max_diff, float(np.abs(a - b).max()))
        else:
            differ.append(s)
    return {"dir": run_dir, "ref": ref_dir, "seeds": len(seeds), "masks_equal": len(same),
            "mask_differ_seeds": differ, "max_coef_diff": max_diff if same else None,
            "within_atol": bool(same) and max_diff <= atol, "atol": atol}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--ref", required=True)
    ap.add_argument("--seeds", default="0-49")
    ap.add_argument("--atol", type=float, default=1e-3)
    a = ap.parse_args(argv)
    try:
        out = compare(a.run_dir, a.ref, parse_seeds(a.seeds), a.atol)
    except FileNotFoundError as e:
        print(f"compare_coefs: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
