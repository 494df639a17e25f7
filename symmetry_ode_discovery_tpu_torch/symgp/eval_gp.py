"""Form evaluation of GP-discovered equations against the ground truth.

The port's copy of symmetry_ode_discovery_tpu/symgp/eval_gp.py (numpy and
sympy). An expression string is expanded with sympy and projected onto the
task's SINDy library (ops/library.py term order); any term outside the
library makes the form wrong. The projected coefficients are thresholded
and scored by evaluation/eval_eq.py, so GP rows aggregate with the same
tooling as every other method.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..evaluation.eval_eq import eval_sindy_coefficients, sindy_truth
from ..ops.library import FunctionLibrary

# task -> library construction matching the discovery configs
_TASK_LIB = {
    "dosc": dict(poly_order=2),
    "growth": dict(poly_order=2),
    "lv": dict(poly_order=2, include_exp=True),
    "selkov": dict(poly_order=3),
}


def expr_to_library_coeffs(expr_str: str, task: str,
                           atol: float = 1e-10) -> Tuple[Optional[np.ndarray], bool]:
    """Project one expression onto the task library.

    Returns (coef_row (n_terms,), in_library). in_library is False when the
    expanded expression holds any term outside the library span (e.g.
    exp(0.3*x0), x0*exp(x1), sin, division remnants).
    """
    import sympy as sp

    lib = FunctionLibrary(2, **_TASK_LIB[task])
    x0, x1 = sp.symbols("x0 x1")
    try:
        expr = sp.expand(sp.sympify(expr_str))
    except (sp.SympifyError, TypeError, ZeroDivisionError):
        return None, False

    gens = [x0, x1]
    use_exp = _TASK_LIB[task].get("include_exp", False)
    if use_exp:
        gens += [sp.exp(x0), sp.exp(x1)]
    try:
        poly = sp.Poly(expr, *gens)
    except sp.PolynomialError:
        return None, False

    # exponent tuple -> library index; exp terms follow the polynomial terms
    # (no shipped task combines sine with this projector)
    assert not _TASK_LIB[task].get("include_sine", False), (
        "sine library terms are not handled by the GP form projector")
    E = lib.exponent_table()           # (n_poly, 2)
    n_poly = E.shape[0]
    table = {}
    for t in range(n_poly):
        table[(int(E[t, 0]), int(E[t, 1]), 0, 0)] = t
    if use_exp:
        table[(0, 0, 1, 0)] = n_poly       # exp(x0)
        table[(0, 0, 0, 1)] = n_poly + 1   # exp(x1)

    coef = np.zeros(lib.n_terms)
    for monom, c in poly.terms():
        key = tuple(int(m) for m in monom) + (0,) * (4 - len(monom))
        c = complex(c)
        if abs(c.imag) > atol:
            return None, False
        if key not in table:
            if abs(c.real) > atol:
                return None, False
            continue
        coef[table[key]] = c.real
    return coef, True


def eval_gp_equations(eqs: List[str], task: str, threshold: float = 0.05):
    """Evaluate a system of per-dimension expressions like a SINDy result.

    Coefficients at or below ``threshold`` are dropped. Off-library forms
    score correct_form = 0 with a support guaranteed to mismatch. Returns the
    eval_sindy_coefficients dict plus 'in_library' per dimension.
    """
    truth = sindy_truth[task]
    d, p = truth.shape
    coefs = np.zeros((d, p))
    in_lib = np.zeros(d, bool)
    for i, e in enumerate(eqs[:d]):
        row, ok = expr_to_library_coeffs(e, task)
        if ok:
            coefs[i] = row
            in_lib[i] = True
    mask = (np.abs(coefs) > threshold).astype(float)
    coefs = coefs * mask
    for i in range(d):
        if not in_lib[i]:
            mask[i] = 1.0 - (np.abs(truth[i]) > 0)  # guaranteed support mismatch
    res = eval_sindy_coefficients(coefs, mask, truth)
    res["in_library"] = in_lib
    return res
