"""The EquivGP-r LV golden's first seed (tests/test_golden.py:162-194) on
the port's CPU path: population 256, 18 generations, the golden's 384 rows
of LV noise 0.4, g(x) and J_g(x) of the laligan-noise99-lv checkpoint from
the JAX package's precompute, fed to both packages. The seed's best tapes
and verdicts must equal the JAX package's (test_torch_golden.py::_gp_golden).
A file of its own, so that the suite's workers run it beside
test_torch_golden.py: the port's CPU tape evaluator takes about 100 s for
the seed on two threads.
"""

from test_torch_golden import _few_threads, _gp_golden  # noqa: F401 (a fixture)


def test_golden_gp_symm_lv_first_seed_matches_jax():
    cf = _gp_golden("equivgp_r", [0])
    assert cf.shape == (1, 2)
