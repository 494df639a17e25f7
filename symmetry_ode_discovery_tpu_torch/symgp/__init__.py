"""The GP engine: fixed-length postfix expression tapes, their evaluation
(ops/tape_eval.py, kernels K5 and K6), host breeding (csrc/evolve.cpp),
constant optimisation, multi-seed sweeps and form scoring."""

from .evolve import GPConfig, symbolic_regression
from .tape import TapeSpec, eval_population, random_population, tape_to_string

__all__ = ["TapeSpec", "random_population", "eval_population", "tape_to_string", "GPConfig",
           "symbolic_regression"]
