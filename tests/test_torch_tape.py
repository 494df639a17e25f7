"""The GP tape interpreter of the port (symgp/tape.py eval_tapes_plain, the
plain version of K5; autograd through it, the plain version of K6) against
the JAX package's interpreter (symgp/tape.py eval_tapes), its Pallas
kernels in interpret mode (symgp/pallas_eval.py) and jax.grad, on
populations and data made from numpy seeds; and the tape utilities.

Tolerances:
- forward, tapes over +, -, *, / and neg: bit for bit (both do the same
  IEEE f32 operations in the same order, NaN where the reference has NaN);
- forward, tapes with exp, sin or cos: max |diff| per tape within 1e-5 of
  that tape's output scale (max |y| over the rows). ATen's and XLA's expf,
  sinf and cosf differ by an ulp on some inputs, and nested exps and
  cancellation (exp(a) - exp(b)) amplify that ulp to a few 1e-6 of the
  scale;
- constant gradient: within 1e-5 of the sum over rows of |gbar * d pred /
  d const| per slot, the scale that bounds rounding in a row sum. Division
  by a variable near 0 makes rows cancel, so the gradient's own magnitude
  is no bound (one tape of the every-op population lies 1.2e-5 of its own
  largest slot from jax.grad, 6e-7 of the population's).
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

ARITH = (tt.ADD, tt.SUB, tt.MUL, tt.DIV, tt.NEG)
EVERY_OP = tuple(range(3, 11))
SPECS = {
    # name: (binary ops, unary ops, n_vars, max_len, op table)
    "lv": ((tt.ADD, tt.SUB, tt.MUL), (tt.EXP,), 2, 25, (tt.ADD, tt.SUB, tt.MUL, tt.EXP)),
    "arith": ((tt.ADD, tt.SUB, tt.MUL, tt.DIV), (tt.NEG,), 3, 32, ARITH),
    "every_op": ((tt.ADD, tt.SUB, tt.MUL, tt.DIV), (tt.EXP, tt.SIN, tt.COS, tt.NEG), 3, 32,
                 None),
}


@pytest.fixture(autouse=True)
def _few_threads():
    """Small tensors on a few threads: the suite runs several workers on
    one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _population(name, seed, P=96):
    bins, uns, n_vars, max_len, table = SPECS[name]
    spec = jt.TapeSpec(n_vars=n_vars, max_len=max_len, binary_ops=bins, unary_ops=uns)
    return jt.random_population(np.random.default_rng(seed), spec, P), n_vars, table


def _plain(pop, X, table, D=16):
    return tt.eval_tapes_plain(*[torch.as_tensor(a)[None] for a in pop],
                               torch.as_tensor(X)[None], D, table)[0].numpy()


def _jax(pop, X, table, D=16):
    J = [jnp.asarray(a) for a in pop]
    return (np.asarray(jt.eval_tapes(*J, jnp.asarray(X), D, op_table=table)),
            np.asarray(jp.eval_tapes_pallas(*J, jnp.asarray(X), D, op_table=table,
                                            interpret=True)))


def _assert_scale_close(got, want, rtol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = np.max(np.where(ok, np.abs(want), 0.0), axis=-1, keepdims=True)
    diff = np.where(ok, np.abs(got - want), 0.0)
    assert np.all(diff <= rtol * scale), float(np.max(diff / np.maximum(scale, 1e-30)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_interpreter_matches_jax(name):
    pop, n_vars, table = _population(name, 0)
    X = np.random.default_rng(1).uniform(-2, 2, (150, n_vars)).astype(np.float32)
    got = _plain(pop, X, table)
    want, want_pallas = _jax(pop, X, table)
    for ref in (want, want_pallas):
        if name == "arith":
            np.testing.assert_array_equal(got, ref)
        else:
            _assert_scale_close(got, ref, 1e-5)


def _tape(slots, L=40):
    """[(op, arg, const), ...] -> one (1, L) tape padded with PAD."""
    ops, args, consts = (np.zeros((1, L), np.int32), np.zeros((1, L), np.int32),
                         np.zeros((1, L), np.float32))
    for i, (op, arg, c) in enumerate(slots):
        ops[0, i], args[0, i], consts[0, i] = op, arg, c
    return ops, args, consts


V0, V1 = (tt.VAR, 0, 0.0), (tt.VAR, 1, 0.0)


def _c(v):
    return (tt.CONST, 0, v)


def _op(code):
    return (code, 0, 0.0)


HAND = {
    # a 17th leaf pushed with the stack full: NaN
    "overflow": [V0] * 17 + [_op(tt.ADD)] * 16,
    "depth_16_ok": [V0] * 16 + [_op(tt.ADD)] * 15,
    "safe_div_zero": [V0, _c(0.0), _op(tt.DIV)],
    "safe_div_tiny": [V0, _c(1e-10), _op(tt.DIV), V1, _op(tt.ADD)],
    "exp_clip_high": [_c(100.0), _op(tt.EXP), V0, _op(tt.MUL)],
    "exp_clip_low": [_c(-100.0), _op(tt.EXP), V1, _op(tt.ADD)],
    # 1e30 * 1e30 = inf at slot 2, then 1 / inf = 0 pops it: the inf stays
    # parked in slot 2 while slot 0 is read
    "inf_parked": [V0, _c(1.0), _c(1e30), _c(1e30), _op(tt.MUL), _op(tt.DIV), _op(tt.ADD)],
    "all_pad": [],
    "neg_sin_cos": [V0, _op(tt.NEG), _op(tt.SIN), V1, _op(tt.COS), _op(tt.MUL)],
    # binary and unary ops at sp 0: both operands read slot 0, never written
    # yet (0), and write it; then a binary op at sp 1 reads slot 0 twice
    "underflow_sp0": [_op(tt.MUL), _op(tt.NEG), V0, _c(1.5), _op(tt.SUB), _op(tt.MUL),
                      _op(tt.EXP)],
    # a binary op at sp 1 (both operands are one value) and a unary op at sp 0
    "underflow_sp1": [V0, _c(1.5), _op(tt.MUL), _op(tt.MUL), _op(tt.NEG)],
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_built_tapes(case):
    pop = _tape(HAND[case])
    X = np.random.default_rng(2).uniform(-2, 2, (33, 2)).astype(np.float32)
    X[0] = 0.0
    got = _plain(pop, X, None)
    want, want_pallas = _jax(pop, X, None)
    for ref in (want, want_pallas):
        _assert_scale_close(got, ref, 1e-6)
    if case == "overflow":
        assert np.isnan(got).all()
    elif case == "all_pad":
        assert not got.any()
    else:
        assert np.isfinite(got).all()
    if case == "safe_div_zero":
        np.testing.assert_array_equal(got[0], 1.0)
    if case == "exp_clip_high":
        clipped = torch.exp(torch.tensor(40.0)) * torch.as_tensor(X[:, 0])
        np.testing.assert_array_equal(got[0], clipped.numpy())


@pytest.mark.parametrize("case", ["underflow_sp0", "underflow_sp1", "safe_div_tiny",
                                  "exp_clip_high", "neg_sin_cos"])
def test_hand_built_tape_gradients(case):
    """Autograd of the plain interpreter against the JAX Pallas gradient
    kernel (interpret mode) and jax.grad of the JAX interpreter on the
    hand-built tapes; in the underflowing ones one value is both operands
    of a binary op, so both partials reach its producer."""
    pop = _tape(HAND[case])
    X = np.random.default_rng(3).uniform(-2, 2, (33, 2)).astype(np.float32)
    gbar = np.random.default_rng(4).standard_normal((1, 33)).astype(np.float32)
    J = [jnp.asarray(a) for a in pop]
    Xj, gj = jnp.asarray(X), jnp.asarray(gbar)
    want_k = np.asarray(jp.eval_tapes_pallas_grad(*J, Xj, gj, 16, interpret=True))
    want_g = np.asarray(jax.grad(lambda c: jnp.sum(gj * jt.eval_tapes(J[0], J[1], c, Xj, 16)))(
        J[2]))
    got = tape_eval.eval_tapes_grad_plain(*[torch.as_tensor(a)[None] for a in pop],
                                          torch.as_tensor(X)[None], torch.as_tensor(gbar)[None],
                                          16)[0].numpy()
    for want in (want_k, want_g):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.isfinite(got).all() and not got[pop[0] != tt.CONST].any()
    if case.startswith("underflow"):
        assert got.any()


# A live opcode outside the op table: VAR x0, CONST 3, the opcode, ADD, then
# * 0.5. The XLA interpreter takes its arity from jnp.asarray(ARITY)[op] (a
# negative opcode wraps once, then the index clamps) and its result is 0;
# -1 has NEG's arity there, so x0 survives (the Pallas kernel pushes 0
# instead, a fault of the reference).
ODD = {
    "op_-12": (-12, None),
    "op_-1": (-1, None),
    "op_11": (11, None),
    "op_12": (12, None),
    "sub_outside_table": (tt.SUB, (tt.ADD, tt.MUL, tt.EXP)),
    "sin_outside_table": (tt.SIN, (tt.ADD, tt.MUL, tt.EXP)),
}


@pytest.mark.parametrize("case", sorted(ODD))
def test_out_of_table_opcodes_match_xla_interpreter(case):
    code, table = ODD[case]
    pop = _tape([V0, _c(3.0), (code, 0, 0.0), _op(tt.ADD), _c(0.5), _op(tt.MUL)], L=10)
    X = np.random.default_rng(5).uniform(-2, 2, (40, 2)).astype(np.float32)
    gbar = np.random.default_rng(6).standard_normal((1, 40)).astype(np.float32)
    J = [jnp.asarray(a) for a in pop]
    Xj, gj = jnp.asarray(X), jnp.asarray(gbar)
    want = np.asarray(jt.eval_tapes(*J, Xj, 16, op_table=table))
    want_g = np.asarray(jax.grad(lambda c: jnp.sum(
        gj * jt.eval_tapes(J[0], J[1], c, Xj, 16, op_table=table)))(J[2]))
    T = [torch.as_tensor(a)[None] for a in pop]
    got = tt.eval_tapes_plain(*T, torch.as_tensor(X)[None], 16, table)[0].numpy()
    np.testing.assert_array_equal(got, want)
    got_g = tape_eval.eval_tapes_grad_plain(*T, torch.as_tensor(X)[None],
                                            torch.as_tensor(gbar)[None], 16, table)[0].numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6 * np.abs(want_g).max())


@pytest.mark.parametrize("name", ["lv", "every_op"])
def test_constant_gradient_matches_jax(name):
    """Autograd of the plain interpreter (K6's plain version) against the
    JAX Pallas gradient kernel (interpret mode) and jax.grad of the JAX
    interpreter, for d sum(gbar * eval) / d consts."""
    pop, n_vars, table = _population(name, 3, P=64)
    X = np.random.default_rng(4).uniform(-2, 2, (150, n_vars)).astype(np.float32)
    gbar = np.random.default_rng(5).standard_normal((64, 150)).astype(np.float32)
    J = [jnp.asarray(a) for a in pop]
    Xj, gj = jnp.asarray(X), jnp.asarray(gbar)
    want_k = np.asarray(jp.eval_tapes_pallas_grad(*J, Xj, gj, 16, op_table=table,
                                                  interpret=True))
    want_g = np.asarray(jax.grad(lambda c: jnp.sum(
        gj * jt.eval_tapes(J[0], J[1], c, Xj, 16, op_table=table)))(J[2]))
    T = [torch.as_tensor(a)[None] for a in pop]
    got = tape_eval.eval_tapes_grad_plain(*T, torch.as_tensor(X)[None],
                                          torch.as_tensor(gbar)[None], 16, table)[0].numpy()
    # the Function's backward on CPU tensors is the same plain gradient
    c = T[2].clone().requires_grad_(True)
    pred = tape_eval.eval_tapes(T[0], T[1], c, torch.as_tensor(X)[None], 16, table)
    (g_fn,) = torch.autograd.grad(pred, c, torch.as_tensor(gbar)[None])
    np.testing.assert_array_equal(g_fn[0].numpy(), got)
    # per-row contributions: each row as a unit of its own
    N = X.shape[0]
    rows = tape_eval.eval_tapes_grad_plain(
        *[t.expand(N, -1, -1) for t in T], torch.as_tensor(X)[:, None],
        torch.as_tensor(gbar.T)[..., None].contiguous(), 16, table).numpy()
    scale = np.abs(rows).sum(0)
    for want in (want_k, want_g):
        assert np.all(np.abs(got - want) <= 1e-5 * scale), \
            float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))
    assert not got[pop[0] != tt.CONST].any()


def test_gradient_padded_rows_no_nan_poisoning():
    """The reference's padded-rows case: a tape finite on the real rows and
    inf at x = 0; the plain gradient sees the real rows only and stays
    finite, as jax.grad does."""
    slots = [V0, _c(35.0), _op(tt.ADD), _op(tt.EXP)] * 1 + [
        V0, _c(35.0), _op(tt.ADD), _op(tt.EXP), _op(tt.MUL)] * 3
    pop = _tape(slots, L=20)
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-31.0, -29.0, 100), rng.standard_normal(100)],
                 axis=1).astype(np.float32)
    y = rng.standard_normal((1, 100)).astype(np.float32)
    table = (tt.ADD, tt.MUL, tt.EXP)
    T = [torch.as_tensor(a)[None] for a in pop]
    got = tape_eval.eval_tapes_grad_plain(*T, torch.as_tensor(X)[None],
                                          torch.as_tensor(y)[None], 8, table)[0].numpy()
    J = [jnp.asarray(a) for a in pop]
    want = np.asarray(jax.grad(lambda c: jnp.sum(
        jt.eval_tapes(J[0], J[1], c, jnp.asarray(X), 8, op_table=table) * y))(J[2]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_plain_chunking_changes_nothing():
    pop, n_vars, table = _population("every_op", 6, P=50)
    X = np.random.default_rng(7).uniform(-2, 2, (3, 40, n_vars)).astype(np.float32)
    T = [torch.as_tensor(np.stack([a] * 3)) for a in pop]
    whole = tt.eval_tapes_plain(*T, torch.as_tensor(X), 16, table)
    parts = tt.eval_tapes_plain(*T, torch.as_tensor(X), 16, table, max_elems=3 * 16 * 40 * 7)
    np.testing.assert_array_equal(whole.numpy(), parts.numpy())
    for u in range(3):  # each unit on its own rows
        np.testing.assert_array_equal(whole[u].numpy(), _plain(pop, X[u], table))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tape_utilities_match_jax(seed):
    bins, uns, n_vars, max_len, _ = SPECS["every_op"]
    jspec = jt.TapeSpec(n_vars=n_vars, max_len=max_len, binary_ops=bins, unary_ops=uns)
    tspec = tt.TapeSpec(n_vars=n_vars, max_len=max_len, binary_ops=bins, unary_ops=uns)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    pj = jt.random_population(rj, jspec, 200)
    pt = tt.random_population(rt, tspec, 200)
    for a, b in zip(pj, pt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert rj.integers(2 ** 63) == rt.integers(2 ** 63)  # the generators agree after
    np.testing.assert_array_equal(jt.tape_length(pj[0]), tt.tape_length(pt[0]))
    np.testing.assert_array_equal(jt.tape_valid(pj[0]), tt.tape_valid(pt[0]))
    assert tt.tape_valid(pt[0]).all()
    assert ([jt.tape_to_string(*r) for r in zip(*pj)]
            == [tt.tape_to_string(*r) for r in zip(*pt)])
    from symmetry_ode_discovery_tpu.symgp.evolve import subtree_span as j_span

    from symmetry_ode_discovery_tpu_torch.symgp.evolve import subtree_span
    for t in range(20):
        tape = tuple(a[t] for a in pt)
        assert [subtree_span(tape[0], i) for i in range(int(tt.tape_length(tape[0])))] == \
            [j_span(tape[0], i) for i in range(int(tt.tape_length(tape[0])))]
        assert jt.random_tape(np.random.default_rng(t), jspec, 9)[0].tolist() == \
            tt.random_tape(np.random.default_rng(t), tspec, 9)[0].tolist()
        assert tt.tape_to_string(*tape) == jt.tape_to_string(*tape)
