"""The readings that a cell's limits are set from, in one process: for each
seed the program's first call (or first steps) against the plain reference
(the lower readings), the control (the reference itself computed with TF32,
the nearest precision below the configuration's float32, put in the
program's place), and each planted fault of faults.py. The benchmark's own
runs do not run this.

    python3 benchmark/control.py --workload <cell> --sound 1-12 --control 1-3 \
        --faults 1-3 [--out <file.jsonl>]

Seeds are lists and ranges (``1,5,9-12``); a control or fault seed is read
beside its sound reading, so it has to be a sound seed too. Each reading is
one JSON line: the seed, the kind (sound, control or a fault's name), the
cell's compared numbers and the driver's further readings (``readings``).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sound", type=seeds, required=True)
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--faults", type=seeds, default=[])
    p.add_argument("--out")
    opts = p.parse_args(argv)

    import torch

    from benchmark import faults, harness

    cell = harness.cell(opts.workload)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = harness.load_module(cell["driver"])
    kind_of = cell["traffic"]["driver"]

    def emit(seed, kind, got):
        line = json.dumps({"workload": opts.workload, "seed": seed, "kind": kind, **got})
        print(line, flush=True)
        if opts.out:
            with open(opts.out, "a") as f:
                f.write(line + "\n")

    for seed in opts.sound:
        prog = driver.first_program(cell, seed, device)
        torch.cuda.empty_cache()
        ref = driver.reference(cell, seed, prog, device)
        emit(seed, "sound", driver.readings(prog, ref))
        if seed in opts.control:
            ctrl = driver.reference(cell, seed, prog, device, tf32=True)
            emit(seed, "control_tf32", driver.readings(ctrl, ref))
        if seed in opts.faults:
            for kind in faults.KINDS[kind_of]:
                with faults.plant(kind_of, kind):
                    bad = driver.first_program(cell, seed, device)
                emit(seed, kind, driver.readings(bad, ref))
                del bad
                torch.cuda.empty_cache()
        del prog, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
