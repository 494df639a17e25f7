"""The GP engine: fixed-length postfix expression tapes, their evaluation
(ops/tape_eval.py, kernels K5 and K6), host breeding (csrc/evolve.cpp),
constant optimisation, multi-seed sweeps and form scoring."""
