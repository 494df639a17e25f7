"""The port's symmetry-selection table (cli/symmetry_selection.py) against
the functions the repository's tools/symmetry_selection.py calls in the JAX
package, on the CPU.

- The criteria (the truth-equivariance penalty symmreg_r, the displacement
  through _group_transform and get_deterministic_group_elems at scale 0.01,
  discrim over the five wrong fields, sep over plain SINDy's wrong
  solutions, the AE reconstruction, reg_closure / reg_ortho / reg_norm) on
  the tracked laligan-noise99-lv and -s44 checkpoints, 512 points drawn from
  a numpy seed: within 1e-5 relative in float32, and within 1e-9 in float64
  against the JAX functions under jax.enable_x64 (the regularisers, exactly
  0 on these checkpoints, within 1e-7 absolute).
- spearman and downstream against the tool's own functions (the tests may
  import tools/; the port may not).
- The CLI end to end on two checkpoints with --device cpu: the 4096
  held-out points of a val array made from a numpy seed, the table's
  layout, the JSON line, and s44's float32 criteria but the two ratios
  (held above on 512 points) within 1e-5 relative of
  the JAX functions' under jax.enable_x64 (the penalty is the mean square
  of a difference of nearly equal terms: on these points the JAX package's
  own float32 penalty lies up to 1.5e-4 from its float64 one, the port's
  within 1.1e-6).
"""

import json
import os

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.cli import symmetry_selection as sel
from symmetry_ode_discovery_tpu_torch.models import lie_generator as lg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "saved_models")
RESULTS = os.path.join(REPO, "eval_results")
CKPTS = ["laligan-noise99-lv", "laligan-noise99-lv-s44"]
KEYS = ("pen", "disp", "discr", "sep", "recon", "closure", "ortho", "norm")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain_coefs():
    """Three of plain SINDy's wrong solutions from the tracked sweep."""
    coefs = sel.plain_wrong_coefficients(RESULTS)
    assert len(coefs) >= 3
    return coefs[:3]


def _points(n, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 2)).astype(np.float32)


def _jax_criteria(name, xs, plain_coefs, x64=False, ratios=True):
    """The tool's criteria (tools/symmetry_selection.py:128-214) through the
    JAX package's functions, in float64 under jax.enable_x64 with ``x64``;
    without ``ratios`` no discrim or sep (their fields' penalties)."""
    import jax
    import jax.numpy as jnp

    from symmetry_ode_discovery_tpu.cli.main import build_models
    from symmetry_ode_discovery_tpu.models import lie_generator as jlg
    from symmetry_ode_discovery_tpu.models.lie_generator import get_deterministic_group_elems
    from symmetry_ode_discovery_tpu.training.symmreg import _group_transform, symmreg_r
    from symmetry_ode_discovery_tpu.utils import checkpoint as jckpt
    from symmetry_ode_discovery_tpu.utils.config import get_args as jget_args
    from tools.symmetry_selection import truth_h

    args = dict(vars(jget_args(["--config", sel.CONFIG, "--load_laligan", name])), input_dim=2)
    ae_def, gspec, _ = build_models(args)
    k = jax.random.PRNGKey(0)
    params, bstats = ae_def.init(k)
    bundle = {"ae": params, "d": {}, "g": jlg.init_generator(k, gspec)}
    bundle, bstats = jckpt.load_laligan(name, bundle, bstats, root=CKPT)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), t)
        p, bs, g_state = cast(bundle["ae"]), cast(bstats), cast(bundle["g"])
        xj = jnp.asarray(xs, dt)
        pen_of = lambda h: float(symmreg_r(ae_def, p, bs, gspec, g_state, xj, h))
        pen = pen_of(truth_h)
        disp = sum(float(jnp.mean((_group_transform(ae_def, p, bs, g, xj, normalize="global",
                                                    z_mean=None) - xj) ** 2))
                   for g in get_deterministic_group_elems(gspec, g_state, scale=0.01))
        out = {"pen": pen, "disp": disp,
               "closure": float(jlg.reg_closure(gspec, g_state)),
               "ortho": float(jlg.reg_ortho(gspec, g_state)),
               "norm": float(jlg.reg_norm(gspec, g_state))}
        z, _ = ae_def.encode(p, bs, xj)
        xr = ae_def.decode(p, z)
        out["recon"] = float(jnp.mean((xr - xj) ** 2) / jnp.mean(xj ** 2))
        if not ratios:
            return out
        A, _, _, _ = np.linalg.lstsq(np.asarray(xj), np.asarray(truth_h(xj)), rcond=None)
        wrongs = [lambda x: truth_h(x)[:, ::-1], lambda x: -truth_h(x),
                  lambda x: x @ jnp.asarray(A), lambda x: 1.5 * truth_h(x),
                  lambda x: truth_h(x) + 0.5 * x]
        out["discr"] = pen / float(np.median([pen_of(w) for w in wrongs]))

        def field_of(C):
            Cj = jnp.asarray(C, jnp.float32)
            return lambda x: jnp.stack(
                [jnp.ones_like(x[:, 0]), x[:, 0], x[:, 1], x[:, 0] ** 2, x[:, 0] * x[:, 1],
                 x[:, 1] ** 2, jnp.exp(x[:, 0]), jnp.exp(x[:, 1])], axis=1) @ Cj.T
        out["sep"] = float(np.median([pen_of(field_of(C)) for C in plain_coefs])) / pen
        return out


def _port_criteria(name, xs, plain_coefs, dtype=torch.float32):
    ae, spec, g_state = sel.load_model(name, CKPT, "cpu")
    if dtype == torch.float64:
        ae = ae.double()
        g_state = lg.GeneratorState(**{f: tuple(t.double() for t in getattr(g_state, f))
                                       for f in ("Li", "sigma", "struct_const", "masks")})
    return sel.criteria(ae, spec, g_state, torch.as_tensor(xs, dtype=dtype), plain_coefs)


def _assert_close(got, want, rtol, reg_atol):
    assert set(want) <= set(KEYS) and {"pen", "disp", "recon"} <= set(want)
    for k in want:
        if k in ("closure", "ortho", "norm"):
            assert abs(got[k] - want[k]) <= reg_atol + rtol * abs(want[k]), (k, got[k], want[k])
        else:
            assert abs(got[k] - want[k]) <= rtol * abs(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("name", CKPTS)
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_criteria_match_jax(name, dtype, plain_coefs):
    xs = _points(512, seed=1)
    f64 = dtype == "f64"
    want = _jax_criteria(name, xs.astype(np.float64) if f64 else xs, plain_coefs, x64=f64)
    got = _port_criteria(name, xs, plain_coefs, torch.float64 if f64 else torch.float32)
    _assert_close(got, want, 1e-9 if f64 else 1e-5, 1e-7)
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("case", range(4))
def test_spearman_matches_the_tool(case):
    from tools.symmetry_selection import spearman

    rng = np.random.default_rng(case)
    a = rng.integers(0, 4, 10).astype(float) if case % 2 else rng.normal(size=10)
    b = rng.integers(0, 5, 10).astype(float)
    assert sel.spearman(a, b) == spearman(a, b)
    assert sel.spearman(a, a) == pytest.approx(1.0)
    assert np.isnan(sel.spearman(a, np.ones(10))) and np.isnan(spearman(a, np.ones(10)))


def test_downstream_matches_the_tool(monkeypatch):
    """Every tracked checkpoint's downstream counts, and a directory with
    too few seeds skipped, as the tool's function (which reads
    eval_results/ under the working directory) gives them."""
    import tools.symmetry_selection as tool

    monkeypatch.chdir(REPO)
    names = sel.discover_ckpts(CKPT)
    assert names[0] == "laligan-noise99-lv" and len(names) == 10
    assert {tool.CKPTS[sel.tag_of(n)][0] for n in names} == set(names)
    for name in names:
        dirs = sel.sweep_dirs(name)
        assert dirs == tool.CKPTS[sel.tag_of(name)][1]
        assert sel.downstream(dirs, RESULTS) == tool.downstream(dirs)
    assert sel.downstream(["symreg25-noise99-lv-s46"], RESULTS, 26) == (None,) * 6


def test_cli_end_to_end_on_two_checkpoints(tmp_path, capsys):
    """The CLI on the CPU: a results root holding two of plain SINDy's wrong
    seeds and the two checkpoints' downstream sweeps (symlinks to the
    tracked ones), a val array of 2 x 2100 points from a numpy seed; the
    s44 row against the JAX functions'."""
    root = tmp_path / "results"
    (root / sel.PLAIN_SWEEP).mkdir(parents=True)
    wrong = [s for s in range(50) if not np.all(np.load(os.path.join(
        RESULTS, sel.PLAIN_SWEEP, f"seed{s}.npz"))["correct_form"] > 0)]
    for s in wrong[:2]:
        name = f"seed{s}.npz"
        os.symlink(os.path.join(RESULTS, sel.PLAIN_SWEEP, name), root / sel.PLAIN_SWEEP / name)
    for d in ("symreg2-noise99-lv", "symreg2-noise99-lv-s44"):
        os.symlink(os.path.join(RESULTS, d), root / d)
    val = np.random.default_rng(3).uniform(-1.0, 1.0, (2, 2100, 2)).astype(np.float32)
    np.save(tmp_path / "val.npy", val)
    out = sel.main(["--val_x", str(tmp_path / "val.npy"), "--ckpts", ",".join(CKPTS),
                    "--ckpt_root", CKPT, "--results_root", str(root), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("held-out: lv val noise99, 4096 points; E||h*||^2 = ")
    assert lines[1].split()[:3] == ["ckpt", "truth-equiv", "disp"]
    assert lines[2].startswith("s43 ") and "symreg2-noise99-lv: 22/50 45/22 (10/25)" in lines[2]
    assert lines[3].startswith("s44 ") and "symreg2-noise99-lv-s44: 9/50 18/20 (5/25)" in lines[3]
    assert len(lines) == 5 and out["spearman"] is None  # two checkpoints: no ranks
    tail = json.loads(lines[-1])
    assert tail["device"] == "cpu" and [r["ckpt"] for r in tail["rows"]] == ["s43", "s44"]
    plain = sel.plain_wrong_coefficients(str(root))
    assert len(plain) == 2 and all(np.isfinite(v) for v in out["rows"][0].values()
                                   if isinstance(v, float))
    want = _jax_criteria(CKPTS[1], sel.held_out(val).astype(np.float64), plain, x64=True,
                         ratios=False)
    _assert_close(out["rows"][1], want, 1e-5, 1e-7)


def test_rank_statistics_of_the_run(monkeypatch):
    """run()'s Spearman values over the checkpoints with a sweep: the
    tool's spearman of each criterion against joint@25, and NaN for a
    criterion that is NaN on some row (sep without plain SINDy's sweep)."""
    from tools.symmetry_selection import spearman

    names = sel.discover_ckpts(CKPT)
    rng = np.random.default_rng(5)
    fake = {n: dict(zip(KEYS, rng.normal(size=len(KEYS)))) for n in names}
    fake[names[3]]["sep"] = float("nan")
    monkeypatch.setattr(sel, "load_model", lambda name, root, dev: (name, None, None))
    monkeypatch.setattr(sel, "criteria", lambda ae, spec, g, xs, plain: dict(fake[ae]))
    out = sel.run(_points(5000), ckpt_root=CKPT, results_root=RESULTS, device="cpu")
    assert [r["name"] for r in out["rows"]] == names and out["n_ranked"] == 10
    y = [r["joint25"] for r in out["rows"]]
    for key in ("pen", "disp", "discr", "recon"):
        assert out["spearman"][key] == spearman([fake[n][key] for n in names], y)
    assert np.isnan(out["spearman"]["sep"])
