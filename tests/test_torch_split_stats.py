"""cli/split_stats.py on the CPU: the statistics against a numpy
recomputation, and the whole comparison on two 1000-step trajectories with a
reference split that is the port's own, so both columns must agree."""

import os

import numpy as np
import pytest
import torch

from symmetry_ode_discovery_tpu_torch.cli.split_stats import compare, split_stats
from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS
from symmetry_ode_discovery_tpu_torch.utils.config import get_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = {"n_ics": 2, "num_steps": 1000}  # the split is 200 x 10000


def test_split_stats_matches_numpy():
    rng = np.random.default_rng(0)
    xc = rng.uniform(-1.0, 1.0, (500, 2))
    dxc = rng.standard_normal((500, 2))
    x = xc + 0.1 * rng.standard_normal(xc.shape)
    dx = dxc + 0.2 * rng.standard_normal(dxc.shape)
    f = SYSTEMS["lv"].f
    got = split_stats(*(torch.as_tensor(a, dtype=torch.float32) for a in (x, dx, xc, dxc)), f)
    rms = lambda a: np.sqrt(np.mean(a ** 2, axis=0))
    fx = f(torch.as_tensor(x, dtype=torch.float32)).numpy()
    want = {"x_err": rms(x - xc) / xc.std(0, ddof=1),
            "dx_err": rms(dx - dxc) / rms(dxc),
            "eq_err": rms(dx - fx) / rms(dxc)}
    assert got["rows"] == 500 and "ae_err" not in got
    for k, v in want.items():  # float32 against float64
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_compare_with_own_split_as_reference(tmp_path):
    torch.manual_seed(0)
    args = vars(get_args(["--config", "lv/noise99_eq_isymreg.cfg"]))
    out = compare(dict(args), device="cpu", ckpt_root=os.path.join(REPO, "saved_models"),
                  **CUT)
    port = out["port"]
    assert port["rows"] == 2 * 1000
    # noise 0.99 of the signal's spread, smoothed: well below the noise, above zero
    assert all(0.0 < e < 0.99 for e in port["x_err"])
    assert all(np.isfinite(port[k]).all() for k in ("dx_err", "eq_err", "ae_err"))
    # the same draws written as a reference split give the same statistics
    from symmetry_ode_discovery_tpu_torch.data.generate import gen_data
    from symmetry_ode_discovery_tpu_torch.data.datasets import cache_seed

    lv = SYSTEMS["lv"]
    for level, smooth, tag in ((0.99, "gp", ""), (0.0, None, "-clean")):
        gen = torch.Generator().manual_seed(cache_seed("train", 0.99))
        x, dx = gen_data(lv, gen, noise=level, smoothing=smooth, device="cpu", **CUT)
        np.save(tmp_path / f"lv-train-noise99-gp{tag}-x.npy", x.numpy())
        np.save(tmp_path / f"lv-train-noise99-gp{tag}-dx.npy", dx.numpy())
    out = compare(dict(args), ref_dir=str(tmp_path), device="cpu",
                  ckpt_root=os.path.join(REPO, "saved_models"), **CUT)
    for k in ("x_err", "dx_err", "eq_err", "ae_err"):
        assert out["ref"][k] == pytest.approx(out["port"][k], rel=1e-6), k
