#!/usr/bin/env python3
"""Outcome counts of per-seed eval npz directories, and their per-seed
agreement with a reference directory.

    python3 compare_evals.py <dir> [--ref <reference dir>] [--seeds 0-49]

Prints one JSON object: for <dir> (and the reference) the joint, eq0 and eq1
successes (correct_form per equation) and the seeds of joint success; with
--ref, the seeds whose joint outcome, and whose per-equation outcomes, are
the same in both. Reads numpy files only.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _seeds(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def outcomes(directory: str, seeds):
    """(len(seeds), d) correct_form array of the seeds' npz files."""
    cf = []
    for s in seeds:
        with np.load(os.path.join(directory, f"seed{s}.npz")) as z:
            cf.append(np.asarray(z["correct_form"]) > 0)
    return np.stack(cf)


def counts(cf, seeds) -> dict:
    joint = cf.all(axis=1)
    out = {"seeds": len(seeds), "joint": int(joint.sum())}
    out.update({f"eq{i}": int(cf[:, i].sum()) for i in range(cf.shape[1])})
    out["joint_seeds"] = [s for s, j in zip(seeds, joint) if j]
    return out


def compare(directory: str, ref: str | None, seeds) -> dict:
    cf = outcomes(directory, seeds)
    out = {"dir": directory, **counts(cf, seeds)}
    if ref is not None:
        cf_ref = outcomes(ref, seeds)
        out["ref"] = {"dir": ref, **counts(cf_ref, seeds)}
        out["joint_agree"] = int((cf.all(1) == cf_ref.all(1)).sum())
        out["all_equations_agree"] = int((cf == cf_ref).all(1).sum())
        out["joint_differ_seeds"] = [s for s, a, b in zip(seeds, cf.all(1), cf_ref.all(1))
                                     if a != b]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dir")
    parser.add_argument("--ref", default=None)
    parser.add_argument("--seeds", default="0-49")
    opts = parser.parse_args(argv)
    res = compare(opts.dir, opts.ref, _seeds(opts.seeds))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
