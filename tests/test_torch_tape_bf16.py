"""K5's bf16 mode on the CPU: the port's plain interpreter on bf16 rows and
constants (symgp/tape.py eval_tapes_plain, the plain version of K5 in
bf16) against the JAX package's interpreter (symgp/tape.py eval_tapes) and
its Pallas kernel in interpret mode (symgp/pallas_eval.py
eval_tapes_pallas), both on bf16 X and consts, the reference's fitness
dtype.

Tolerances: tapes of +, -, *, /, neg and the leaves: bit for bit (each
step is one operation on bf16 values, computed in f32 and rounded to bf16
on every side, which gives the correctly rounded bf16 result). Tapes with
exp, sin or cos: at least 99.9% of the elements bit-equal (ATen's and XLA's
f32 exp, sin and cos may differ by an ulp, which the rounding to bf16
nearly always absorbs). NaN matches NaN.

Subnormals: XLA's CPU backend flushes subnormal inputs and results to zero
(so does the TPU), while PyTorch, on the CPU and on the card, and K5
follow IEEE. The hand-built trap tapes (smoke_setup.k5_trap_population) reach
bf16 subnormals, so they are held to the JAX interpreters bit for bit with
the CPU's flush-to-zero on during the plain evaluation (which then flushes
exactly as XLA does), and, with it off, each packed operation of K5's bf16
mode (+, -, *, neg) and the per-element division is held bit for bit to a
numpy reference of IEEE f32 arithmetic rounded to bf16, subnormals
included: the semantics K5 keeps on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu.symgp import pallas_eval as jp
from symmetry_ode_discovery_tpu.symgp import tape as jt

from symmetry_ode_discovery_tpu_torch.ops import tape_eval
from symmetry_ode_discovery_tpu_torch.symgp import tape as tt

from symmetry_ode_discovery_tpu_torch.smoke_setup import (K5_TRAP_ROWS, k5_trap_population,
                                                           k5_trap_rows)
from test_torch_tape import HAND, SPECS, _population, _tape

TRANSCENDENTAL_SHARE = 0.999  # elements bit-equal where exp, sin or cos run


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _plain_bf16(pop, X, table, D=16):
    ops, args, consts = (torch.as_tensor(a)[None] for a in pop)
    return tt.eval_tapes_plain(ops, args, consts.to(torch.bfloat16),
                               torch.as_tensor(X)[None].to(torch.bfloat16), D, table)[0]


def _jax_bf16(pop, X, table, D=16):
    ops, args, consts = (jnp.asarray(a) for a in pop)
    Xb, cb = jnp.asarray(X).astype(jnp.bfloat16), consts.astype(jnp.bfloat16)
    return (jt.eval_tapes(ops, args, cb, Xb, D, op_table=table),
            jp.eval_tapes_pallas(ops, args, cb, Xb, D, op_table=table, interpret=True))


def _share_bit_equal(got, want):
    """The share of elements of the bf16 tensor ``got`` whose bits equal the
    bf16 jax array ``want``'s (NaN matching NaN)."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.view(torch.int16).numpy()
    w = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16))
    nan = np.isnan(got.float().numpy()) & np.isnan(np.asarray(want, np.float32))
    return float(((g == w) | nan).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_bf16_matches_jax_interpreters(name, seed):
    pop, n_vars, table = _population(name, seed)
    X = np.random.default_rng(10 + seed).uniform(-2, 2, (150, n_vars)).astype(np.float32)
    got = _plain_bf16(pop, X, table)
    for want in _jax_bf16(pop, X, table):
        share = _share_bit_equal(got, want)
        if name == "arith":
            assert share == 1.0
        else:
            assert share >= TRANSCENDENTAL_SHARE, share


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_built_tapes_bf16(case):
    """The hand-built edge cases of tests/test_torch_tape.py in bf16: safe
    division at 0 and below bf16(1e-9), the exp clip, an inf parked under
    the stack pointer, overflow to NaN, underflowing reads."""
    pop = _tape(HAND[case])
    X = np.random.default_rng(2).uniform(-2, 2, (33, 2)).astype(np.float32)
    X[0] = 0.0
    got = _plain_bf16(pop, X, None)
    transcendental = any(op in (tt.EXP, tt.SIN, tt.COS) for op, _, _ in HAND[case])
    for want in _jax_bf16(pop, X, None):
        share = _share_bit_equal(got, want)
        assert share >= (TRANSCENDENTAL_SHARE if transcendental else 1.0), share
    if case == "overflow":
        assert torch.isnan(got).all()
    elif case == "all_pad":
        assert not got.any()
    else:
        assert torch.isfinite(got).all()


def test_bf16_steps_round_each_result():
    """Each step's result is the bf16 rounding of the f32 operation on the
    bf16 operands: x0 * c then + x1, step by step against torch's own bf16
    arithmetic, and the constants cast to X's dtype as the reference's
    eval_tapes casts them."""
    pop = _tape([(tt.VAR, 0, 0.0), (tt.CONST, 0, 1.2345678), (tt.MUL, 0, 0.0),
                 (tt.VAR, 1, 0.0), (tt.ADD, 0, 0.0)])
    X = np.random.default_rng(3).uniform(-2, 2, (64, 2)).astype(np.float32)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    want = Xb[:, 0] * torch.tensor(1.2345678, dtype=torch.bfloat16) + Xb[:, 1]
    got = tt.eval_tapes_plain(*(torch.as_tensor(a)[None] for a in pop), Xb[None])[0, 0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_eval_tapes_cpu_path_runs_bf16():
    """tape_eval.eval_tapes on bf16 CPU tensors is the plain version in bf16
    (forward only: its output is bf16, as K5's on the card)."""
    pop, n_vars, table = _population("lv", 4)
    X = np.random.default_rng(4).uniform(-2, 2, (100, n_vars)).astype(np.float32)
    ops, args, consts = (torch.as_tensor(a)[None] for a in pop)
    Xb = torch.as_tensor(X)[None].to(torch.bfloat16)
    out = tape_eval.eval_tapes(ops, args, consts.to(torch.bfloat16), Xb, 16, table)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, _plain_bf16(pop, X, table)[None])
    with pytest.raises(ValueError, match="cuda"):
        tape_eval.eval_tapes_kernel(ops.int(), args.int(), consts.to(torch.bfloat16), Xb)


BF16_MIN_NORMAL = 2.0 ** -126


def _flushed_plain_bf16(pop, X, table, D=16):
    """_plain_bf16 on one thread with the CPU's flush-to-zero (and
    denormals-are-zero) on, as XLA's CPU backend computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        return _plain_bf16(pop, X, table, D)
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


@pytest.mark.parametrize("rows", K5_TRAP_ROWS)
def test_trap_tapes_bf16_match_jax_flushed(rows):
    """The trap tapes on ``rows`` rows reaching -0, subnormals, +-inf and
    NaN: the plain version in bf16, flushing as XLA does, against the JAX
    interpreter and the Pallas kernel in interpret mode, bit for bit (the
    transcendental tapes at TRANSCENDENTAL_SHARE); the overflow tape NaN on
    every row."""
    names, *pop = k5_trap_population()
    X = k5_trap_rows(rows)
    got = _flushed_plain_bf16(pop, X, None)
    transcendental = np.isin(pop[0], (tt.EXP, tt.SIN, tt.COS)).any(axis=1)
    for want in _jax_bf16(pop, X, None):
        exact = ~transcendental
        assert _share_bit_equal(got[exact], want[exact]) == 1.0
        share = _share_bit_equal(got[transcendental], want[transcendental])
        assert share >= TRANSCENDENTAL_SHARE, share
    assert torch.isnan(got[names.index("overflow")]).all()


def _bf16_bits(f):
    """float32 numpy array -> the uint16 bits of its bf16 rounding (to
    nearest, ties to even, subnormals kept, NaN as 0x7fc0)."""
    u = f.view(np.uint32).astype(np.uint64)
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(f), np.uint16(0x7FC0), bits)


def _canonical(bits):
    return np.where(bits == 0x8000, np.uint16(0), bits)


def test_bf16_ops_ieee_on_trap_rows():
    """Each packed operation of K5's bf16 mode (b + a, b - a, b * a, -a, in
    both operand orders) and its per-element division on the trap rows:
    the plain version in bf16 (IEEE, no flush) against numpy's f32
    operation on the bf16 operands, rounded to bf16 and -0 made +0, bit for
    bit; the rows reach subnormal results, products that round to 0, +-inf
    and NaN."""
    n = 4096
    X = k5_trap_rows(n, seed=5)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    a0, a1 = (np.where(v == 0, np.float32(0), v)  # an input reads as +0
              for v in Xb.float().numpy().T)
    V0, V1 = (tt.VAR, 0, 0.0), (tt.VAR, 1, 0.0)
    cases = {
        "add": ([V0, V1, (tt.ADD, 0, 0.0)], lambda: a0 + a1),
        "sub": ([V0, V1, (tt.SUB, 0, 0.0)], lambda: a0 - a1),
        "sub_swapped": ([V1, V0, (tt.SUB, 0, 0.0)], lambda: a1 - a0),
        "mul": ([V0, V1, (tt.MUL, 0, 0.0)], lambda: a0 * a1),
        "div": ([V0, V1, (tt.DIV, 0, 0.0)],
                lambda: np.where(np.abs(a1) > np.float32(1e-9), a0 / a1, np.float32(1))),
        "div_swapped": ([V1, V0, (tt.DIV, 0, 0.0)],
                        lambda: np.where(np.abs(a0) > np.float32(1e-9), a1 / a0, np.float32(1))),
        "neg": ([V0, (tt.NEG, 0, 0.0)], lambda: -a0),
        "var": ([V1], lambda: a1),
    }
    reached = dict(subnormal=0, rounds_to_zero=0, inf=0, nan=0)
    for name, (slots, ref) in cases.items():
        got = _plain_bf16(_tape(slots), X, None)[0]
        with np.errstate(all="ignore"):
            exact = ref().astype(np.float32)
        want = _canonical(_bf16_bits(exact))
        g = got.view(torch.int16).numpy().view(np.uint16)
        nan = np.isnan(got.float().numpy()) & np.isnan(exact)
        assert ((g == want) | nan).all(), (name, int((~((g == want) | nan)).sum()))
        w = got.float().numpy()
        reached["subnormal"] += int(((w != 0) & (np.abs(w) < BF16_MIN_NORMAL)).sum())
        reached["rounds_to_zero"] += int(((w == 0) & (exact != 0)).sum())
        reached["inf"] += int(np.isinf(w).sum())
        reached["nan"] += int(np.isnan(w).sum())
    assert all(reached.values()), reached
