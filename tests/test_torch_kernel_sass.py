"""cli/kernel_sass.py on the CPU: its reading of cuobjdump -sass output
(the card's disassembler does not run here, so the text is hand-written in
cuobjdump's layout) and its comparison of two builds' entries."""

import subprocess

from symmetry_ode_discovery_tpu_torch.cli import kernel_sass

SASS = """
        code for sm_90a
                Function : _Z16tape_eval_kernelILb1EEvPKiS1_
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   HADD2.BF16_V2 R4, R4, R5 ;  /* 0x0000000504047230 */
                                                               /* 0x000fe20000200800 */
        /*0020*/               @P0 HMUL2.BF16_V2 R6, R6, R7 ;  /* 0x0000000706067232 */
                                                               /* 0x000fe20000200800 */
        /*0030*/              @!P1 BRA 0x10 ;                  /* 0x0000000000009947 */
                                                               /* 0x000fea0003800000 */
                Function : _Z16tape_grad_kernelPKiS0_
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                      /* 0x000000000000794d */
"""


def test_sass_entries_and_opcodes(monkeypatch):
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 0, stdout=SASS))
    entries = kernel_sass.sass_entries("lib.so")
    assert list(entries) == ["_Z16tape_eval_kernelILb1EEvPKiS1_", "_Z16tape_grad_kernelPKiS0_"]
    k5 = entries["_Z16tape_eval_kernelILb1EEvPKiS1_"]
    assert k5 == ["LDC R1, c[0x0][0x28]", "HADD2.BF16_V2 R4, R4, R5",
                  "@P0 HMUL2.BF16_V2 R6, R6, R7", "@!P1 BRA 0x10"]
    assert [kernel_sass.opcode(i) for i in k5] == ["LDC", "HADD2", "HMUL2", "BRA"]
    assert entries["_Z16tape_grad_kernelPKiS0_"] == ["LDC R1, c[0x0][0x28]", "EXIT"]


def test_compare_marks_equal_and_differing_entries():
    this = {"a": ["X R1", "Y R2", "Z R3"], "b": ["EXIT"], "only_this": ["EXIT"]}
    other = {"a": ["X R1", "W R2", "W R4", "Z R3"], "b": ["EXIT"]}
    rec = kernel_sass.compare(this, other)
    assert rec["same"] == {"a": {"this_unmatched": 1, "other_unmatched": 2}, "b": True}
    assert rec["entries"]["this"]["a"] == {"instructions": 3,
                                           "opcodes": {"X": 1, "Y": 1, "Z": 1}}
    assert rec["entries"]["other"]["a"]["opcodes"] == {"W": 2, "X": 1, "Z": 1}
    assert "only_this" in rec["entries"]["this"] and "only_this" not in rec["same"]
