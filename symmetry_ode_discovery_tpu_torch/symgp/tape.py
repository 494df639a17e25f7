"""Expression tapes: fixed-size postfix programs and their plain PyTorch
interpreter.

The port's copy of symmetry_ode_discovery_tpu/symgp/tape.py. A population is
three arrays of one shape (P, L):

    ops:    int32 opcodes (0 = PAD, a no-op)
    args:   int32 variable indices (VAR slots) / unused otherwise
    consts: float32 constant values (CONST slots)

The host-side helpers (random tapes, validity, length, printing) are numpy
and draw from a ``np.random.Generator`` exactly as the JAX package does, so
both packages grow the same population from the same generator state.
``eval_tapes_plain`` is the one-hot stack machine of the JAX package's
``eval_tapes`` in torch, batched over a leading unit axis: the plain version
of kernel K5 (ops/tape_eval.py), and through autograd that of K6.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

# opcodes
PAD, CONST, VAR, ADD, SUB, MUL, DIV, EXP, SIN, COS, NEG = range(11)
ARITY = np.array([0, 0, 0, 2, 2, 2, 2, 1, 1, 1, 1], dtype=np.int32)
OP_NAMES = ["pad", "const", "var", "+", "-", "*", "/", "exp", "sin", "cos", "neg"]
ALL_OPS = tuple(range(3, 11))


@dataclasses.dataclass(frozen=True)
class TapeSpec:
    """The GP search space: variables, tape length, stack depth, operators
    and the range of fresh constants."""

    n_vars: int
    max_len: int = 32
    stack_depth: int = 16
    binary_ops: Tuple[int, ...] = (ADD, SUB, MUL)
    unary_ops: Tuple[int, ...] = ()
    const_range: float = 2.0


def spec_op_table(spec: TapeSpec) -> Tuple[int, ...]:
    """The opcodes a TapeSpec's search space can emit."""
    return tuple(spec.binary_ops) + tuple(spec.unary_ops)


def op_table_codes(op_table=None) -> Tuple[int, ...]:
    """PAD, CONST, VAR and then the non-leaf opcodes of ``op_table`` (every
    non-leaf opcode when None): the opcodes whose results the interpreter
    computes. A live opcode outside the table yields 0."""
    if op_table is None:
        op_table = ALL_OPS
    return (PAD, CONST, VAR) + tuple(o for o in op_table if o not in (PAD, CONST, VAR))


def _safe_div(num, den):
    # a Python scalar takes the tensor's dtype, as the reference's weakly
    # typed 1e-9 does: in bf16 the bound is bf16(1e-9)
    ok = den.abs() > 1e-9
    return torch.where(ok, num / torch.where(ok, den, 1.0), 1.0)


def _op_result(code, a, b, cval, var_val):
    if code == PAD:
        return torch.zeros_like(a)
    if code == CONST:
        return cval.expand_as(a)
    if code == VAR:
        return var_val
    if code == ADD:
        return b + a
    if code == SUB:
        return b - a
    if code == MUL:
        return b * a
    if code == DIV:
        return _safe_div(b, a)
    if code == EXP:
        return torch.exp(torch.clamp(a, -40.0, 40.0))
    if code == SIN:
        return torch.sin(a)
    if code == COS:
        return torch.cos(a)
    return -a  # NEG


def _eval_chunk(ops, args, consts, XT, D, table):
    """(U, p, L) tapes on XT (U, n_vars, N) -> (U, p, N)."""
    U, p, L = ops.shape
    N = XT.shape[-1]
    arity_t = torch.as_tensor(ARITY, dtype=torch.int64, device=ops.device)
    pos = torch.arange(D, device=ops.device)[:, None]  # (D, 1)
    stack = XT.new_zeros((U, p, D, N))
    sp = torch.zeros((U, p), dtype=torch.int64, device=ops.device)
    bad = torch.zeros((U, p), dtype=torch.bool, device=ops.device)
    n_vars = XT.shape[1]
    for l in range(L):
        op = ops[:, :, l]
        # the reference's jnp.asarray(ARITY)[op]: a negative opcode wraps
        # once, then the index clamps into the table
        arity = arity_t[torch.where(op < 0, op + len(ARITY), op).clamp(0, len(ARITY) - 1)]
        i1 = (sp - 1).clamp(0, D - 1)
        i2 = (sp - 2).clamp(0, D - 1)
        # where-mask + sum (NOT a mask multiply): 0 * inf would turn a
        # non-finite value parked in an unselected slot into NaN
        a = torch.where(pos == i1[..., None, None], stack, 0.0).sum(-2)
        b = torch.where(pos == i2[..., None, None], stack, 0.0).sum(-2)
        arg = args[:, :, l].clamp(0, n_vars - 1)
        var_val = torch.gather(XT, 1, arg[..., None].expand(U, p, N))
        cval = consts[:, :, l, None]
        res = _op_result(table[0], a, b, cval, var_val)
        for code in table[1:]:
            res = torch.where((op == code)[..., None], _op_result(code, a, b, cval, var_val), res)
        live = op != PAD
        delta = torch.where(live, 1 - arity, 0)
        write_idx = (sp - arity).clamp(0, D - 1)
        wmask = (pos == write_idx[..., None, None]) & live[..., None, None]
        stack = torch.where(wmask, res[:, :, None, :], stack)
        # a leaf push with the stack already full clobbers the top slot
        bad = bad | (live & (arity == 0) & (sp >= D))
        sp = (sp + delta).clamp(0, D)
    i_out = (sp - 1).clamp(0, D - 1)
    out = torch.where(pos == i_out[..., None, None], stack, 0.0).sum(-2)
    return torch.where(bad[..., None], torch.nan, out)


def eval_tapes_plain(ops: torch.Tensor, args: torch.Tensor, consts: torch.Tensor,
                     X: torch.Tensor, stack_depth: int = 16, op_table=None,
                     max_elems: int = 1 << 27) -> torch.Tensor:
    """Evaluate populations of tapes on data, one population per unit.

    ops/args: (U, P, L) integers; consts (U, P, L) float32; X (U, N, n_vars).
    Returns (U, P, N) predictions. The stack and every operation run in
    X's dtype, the constants cast to it, as the reference's ``eval_tapes``
    and ``eval_tapes_pallas`` do on bf16 X (each step rounded to bf16).
    Follows the JAX package's ``eval_tapes`` step for step: every stack read and write is a where-mask over the D
    slots then a sum; DIV is safe (1 where |den| <= 1e-9); EXP clips its
    operand to [-40, 40]; a leaf pushed with the stack full (sp >= D) makes
    the tape's output NaN; PAD is a no-op; a live opcode outside
    ``op_table`` yields 0, with the arity ``ARITY[op]`` has under the
    reference's indexing (a negative opcode wraps once, then clamps into
    [0, 10]). Differentiable in ``consts``. The population is
    walked in chunks of tapes so that the (U, p, D, N) stack stays under
    ``max_elems`` elements; tapes are independent, so chunking changes no
    number."""
    if ops.shape != args.shape or ops.shape != consts.shape or ops.ndim != 3:
        raise ValueError(f"ops, args, consts must be one (U, P, L) shape, got "
                         f"{tuple(ops.shape)}, {tuple(args.shape)}, {tuple(consts.shape)}")
    U, P, _ = ops.shape
    if X.ndim != 3 or X.shape[0] != U:
        raise ValueError(f"X must be (U={U}, N, n_vars), got {tuple(X.shape)}")
    D = stack_depth
    table = op_table_codes(op_table)
    ops, args = ops.long(), args.long()
    consts = consts.to(X.dtype)
    XT = X.transpose(1, 2)
    chunk = max(1, min(P, max_elems // max(1, U * D * X.shape[1])))
    outs = [_eval_chunk(ops[:, s:s + chunk], args[:, s:s + chunk], consts[:, s:s + chunk],
                        XT, D, table) for s in range(0, P, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def eval_population(population, X: torch.Tensor, spec: TapeSpec) -> torch.Tensor:
    """(P, N) predictions of a population (ops, args, consts (P, L)) on the
    rows X (N, n_vars): K5 (ops/tape_eval.py) when X lies on the card, its
    plain version when it lies on the CPU."""
    from ..ops.tape_eval import eval_tapes

    ops, args, consts = (torch.as_tensor(np.asarray(a), dtype=dt, device=X.device)[None]
                         .contiguous() for a, dt in zip(population, (torch.int32, torch.int32,
                                                                     X.dtype)))
    with torch.no_grad():
        return eval_tapes(ops, args, consts, X[None].contiguous(), spec.stack_depth)[0]


def tape_valid(ops: np.ndarray) -> np.ndarray:
    """(P, L) -> (P,) bool: postfix well-formedness: the running stack depth
    stays >= arity at each op and ends at exactly 1 (ignoring trailing PAD),
    and no opcode follows a PAD."""
    P, L = ops.shape
    depth = np.zeros(P, dtype=np.int64)
    ok = np.ones(P, dtype=bool)
    for i in range(L):
        op = ops[:, i]
        is_pad = op == PAD
        ar = ARITY[op]
        ok &= is_pad | (depth >= ar)
        depth = np.where(is_pad, depth, depth - ar + 1)
    ok &= depth == 1
    for p in range(P):
        nz = np.nonzero(ops[p] != PAD)[0]
        if nz.size and (ops[p][: nz[-1] + 1] == PAD).any():
            ok[p] = False
    return ok


def random_tape(rng: np.random.Generator, spec: TapeSpec, target_len: int):
    """Grow a random postfix program of approximately target_len slots."""
    target_len = min(target_len, spec.max_len)
    ops, args, consts = [], [], []
    depth = 0
    while len(ops) < target_len:
        remaining = target_len - len(ops)
        choices = []
        if depth >= 1 and remaining >= 1:
            choices += [o for o in spec.unary_ops]
        if depth >= 2:
            choices += [o for o in spec.binary_ops] * 2
        if depth < remaining:  # room to push leaves
            choices += [CONST, VAR, VAR]
        if not choices:
            break
        op = int(rng.choice(choices))
        ops.append(op)
        if op == VAR:
            args.append(int(rng.integers(spec.n_vars)))
            consts.append(0.0)
            depth += 1
        elif op == CONST:
            args.append(0)
            consts.append(float(rng.uniform(-spec.const_range, spec.const_range)))
            depth += 1
        else:
            args.append(0)
            consts.append(0.0)
            depth -= ARITY[op] - 1
        if depth == 1 and rng.random() < 0.3:
            break
    # close the program: reduce depth to 1 with binary ops
    while depth > 1 and len(ops) < spec.max_len:
        op = int(rng.choice(list(spec.binary_ops)))
        ops.append(op)
        args.append(0)
        consts.append(0.0)
        depth -= 1
    if depth != 1:
        # fall back to a single leaf
        ops, args, consts = [VAR], [int(rng.integers(spec.n_vars))], [0.0]
    pad = spec.max_len - len(ops)
    return (np.array(ops + [PAD] * pad, np.int32),
            np.array(args + [0] * pad, np.int32),
            np.array(consts + [0.0] * pad, np.float32))


def random_population(rng: np.random.Generator, spec: TapeSpec, pop_size: int,
                      mean_len: int = 8):
    rows = [random_tape(rng, spec, max(1, int(rng.integers(1, 2 * mean_len))))
            for _ in range(pop_size)]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.stack([r[2] for r in rows]))


def tape_length(ops: np.ndarray) -> np.ndarray:
    """(..., L) -> (...,) number of non-PAD slots (the complexity measure)."""
    return (ops != PAD).sum(axis=-1)


def tape_to_string(op_row: np.ndarray, arg_row: np.ndarray, const_row: np.ndarray,
                   var_names: List[str] | None = None) -> str:
    """Postfix -> infix string: constants as ``:.4g``, NEG as ``(-a)`` so
    that sympy parses it (the form projector, symgp/eval_gp.py)."""
    stack: List[str] = []
    for op, arg, c in zip(op_row, arg_row, const_row):
        op = int(op)
        if op == PAD:
            continue
        if op == CONST:
            stack.append(f"{float(c):.4g}")
        elif op == VAR:
            stack.append(var_names[int(arg)] if var_names else f"x{int(arg)}")
        elif op in (ADD, SUB, MUL, DIV):
            if len(stack) < 2:
                return "<invalid>"
            a = stack.pop()
            b = stack.pop()
            stack.append(f"({b} {OP_NAMES[op]} {a})")
        else:  # unary
            if len(stack) < 1:
                return "<invalid>"
            a = stack.pop()
            stack.append(f"(-{a})" if op == NEG else f"{OP_NAMES[op]}({a})")
    return stack[-1] if len(stack) == 1 else "<invalid>"


def tape_to_sympy(op_row, arg_row, const_row, var_names=None):
    """Postfix -> sympy expression (exact-form checks). Raises ValueError on
    a malformed tape (operand underflow or several roots), where
    tape_to_string prints '<invalid>'."""
    import sympy as sp

    stack = []
    for op, arg, c in zip(op_row, arg_row, const_row):
        op = int(op)
        if op == PAD:
            continue
        if op != CONST and op != VAR and len(stack) < ARITY[op]:
            raise ValueError("malformed tape: operand underflow")
        if op == CONST:
            stack.append(sp.Float(float(c)))
        elif op == VAR:
            name = var_names[int(arg)] if var_names else f"x{int(arg)}"
            stack.append(sp.Symbol(name))
        elif op in (ADD, SUB, MUL, DIV):
            a = stack.pop()
            b = stack.pop()
            stack.append({ADD: b + a, SUB: b - a, MUL: b * a, DIV: b / a}[op])
        elif op == EXP:
            stack.append(sp.exp(stack.pop()))
        elif op == SIN:
            stack.append(sp.sin(stack.pop()))
        elif op == COS:
            stack.append(sp.cos(stack.pop()))
        elif op == NEG:
            stack.append(-stack.pop())
    if len(stack) != 1:
        raise ValueError("malformed tape: expected exactly one root")
    return stack[-1]
