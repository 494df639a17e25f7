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
