"""The SASS of a kernel source's entries in this tree's build and in another
build of the same source, side by side.

    python -m symmetry_ode_discovery_tpu_torch.cli.kernel_sass --other <source.cu> \\
        [--out DIR]

The other copy is recognised by its file name, as in cli/kernel_ab.py
(lbfgs_sweep.cu, symmpen.cu, lbfgs_dir.cu or tape_eval.cu), and both copies
are built with this tree's flags for that source. Both libraries are
disassembled with cuobjdump -sass. Prints one JSON line: for each side and
kernel entry, its instruction count and the count of each opcode (the
mnemonic up to its first '.'); for each entry both builds have, whether the
two instruction sequences are the same (operands included, branch targets
as written; addresses, encodings and comments dropped) and, where they are
not, how many instructions of each side lie outside the blocks they share.
With --out, each side's SASS of each entry goes to DIR/<side>_<entry>.sass
for reading.
"""

import argparse
import collections
import difflib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def sass_entries(library):
    """{kernel entry: [its SASS instructions as text]} of a built library."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = m[1]
            out[entry] = []
            continue
        m = INSN.search(line)
        if entry and m:
            out[entry].append(m[1])
    return out


def opcode(insn):
    """The mnemonic of one instruction, without its predicate and modifiers."""
    words = insn.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def compare(this, other):
    """Per side and entry: instruction count and opcode counts; per shared
    entry: equal sequences, or each side's instructions outside the
    matching blocks."""
    rec = {"entries": {}, "same": {}}
    for side, entries in (("this", this), ("other", other)):
        for name, insns in entries.items():
            rec["entries"].setdefault(side, {})[name] = {
                "instructions": len(insns),
                "opcodes": dict(sorted(collections.Counter(map(opcode, insns)).items()))}
    for name in sorted(set(this) & set(other)):
        a, b = this[name], other[name]
        if a == b:
            rec["same"][name] = True
            continue
        matched = sum(m.size for m in difflib.SequenceMatcher(None, a, b,
                                                              autojunk=False).get_matching_blocks())
        rec["same"][name] = {"this_unmatched": len(a) - matched,
                             "other_unmatched": len(b) - matched}
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="another copy of one kernel source")
    parser.add_argument("--out", help="write each side's SASS per entry under this directory")
    opts = parser.parse_args(argv)
    from symmetry_ode_discovery_tpu_torch.cli.kernel_ab import other_build
    from symmetry_ode_discovery_tpu_torch.ops import _nvcc

    mod, other = other_build(opts.other)
    _nvcc.build_all([mod.KERNEL, other])
    sides = {"this": sass_entries(mod.KERNEL.info["path"]),
             "other": sass_entries(other.info["path"])}
    if opts.out:
        out = Path(opts.out)
        out.mkdir(parents=True, exist_ok=True)
        for side, entries in sides.items():
            for name, insns in entries.items():
                (out / f"{side}_{name}.sass").write_text("\n".join(insns) + "\n")
    print(json.dumps({"source": Path(opts.other).name, **compare(sides["this"], sides["other"])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
