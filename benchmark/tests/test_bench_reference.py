"""The plain reference against the port on the CPU at a tiny width: the
trajectories bit for bit, the EquivSINDy-r closure's penalty and gradient,
and one LaLiGAN batch step from the same weights, batch and draw."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import checkpoint as ref_ckpt
from benchmark.reference import data as ref_data
from benchmark.reference import eqsindy as ref_eqsindy
from benchmark.reference import lassi as ref_lassi
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_trajectories_bit_for_bit():
    from symmetry_ode_discovery_tpu_torch.data.generate import gen_data
    from symmetry_ode_discovery_tpu_torch.data.systems import SYSTEMS

    d = dict(tiny.cell(tiny.LALIGAN)["config"]["data"])
    x, dx = gen_data(SYSTEMS["lv"], torch.Generator().manual_seed(11), n_ics=d["n_ics"],
                     dt=d["dt"], num_steps=d["num_steps"], subsample_rate=1, noise=d["noise"],
                     smoothing="gp", gp_sigma_in=d["gp_sigma_in"], device=CPU)
    rx, rdx = ref_data.trajectories(d, 11, CPU)
    assert torch.equal(x, rx) and torch.equal(dx, rdx)
    from symmetry_ode_discovery_tpu_torch.data.datasets import MTODEDataset

    w = MTODEDataset(x, dx, interval=d["interval"]).materialize()[0]
    assert torch.equal(w, ref_data.windows(rx, 2, d["interval"]))


def test_closure_penalty_and_gradient(tmp_path):
    drv = harness.load_module(harness.HERE / "drivers" / "eqsindy_sweep.py")
    cell = tiny.cell(tiny.SWEEP, tmp_path)
    sw = drv.Sweep(cell, 3, CPU)
    x, dx, ctx = sw.carry["x"], sw.carry["dx"], sw.carry["srctx"]
    lib, hp = sw.fit["cfg"].library, sw.hp
    th = sw.theta0.clone().requires_grad_(True)
    with torch.enable_grad():
        XiM = th.reshape(sw.lanes, sw.d, sw.p)
        pen = sw.fit["sym_reg_fn"](XiM, x, ctx)
        mse = ((lib(x) @ XiM.mT - dx) ** 2).mean(dim=(1, 2))
        loss = hp.w_sindy_x * mse + hp.w_sym_reg * pen + hp.w_sindy_reg * th.abs().sum(-1)
        (g,) = torch.autograd.grad(loss.sum(), th)
    args = drv.program_args(cell["config"])
    ck = ref_ckpt.load(f"{cell['config']['checkpoint_root']}/laligan-noise99-lv", CPU)
    clo = ref_eqsindy.Closure(ck, args)
    mask = torch.ones_like(XiM)
    r_loss, r_pen, r_g = clo.value_and_grad(sw.theta0, mask, x, dx, clo.prep(x))
    np.testing.assert_allclose(pen.detach(), r_pen, rtol=1e-5)
    np.testing.assert_allclose(loss.detach(), r_loss, rtol=1e-5)
    np.testing.assert_allclose(g, r_g, rtol=1e-4, atol=1e-6 * float(r_g.abs().max()))


def test_lassi_step():
    drv = harness.load_module(harness.HERE / "drivers" / "lassi_train.py")
    cell = tiny.cell(tiny.LALIGAN)
    tr = drv.Training(cell, 5, CPU)  # the first steps run in set-up
    args = tr.args
    P = drv.init_weights(args, tr.weights_seed, CPU)
    ref = ref_lassi.Lassi(args)
    opt = ref.fresh_opt(P)
    x = ref_data.windows(ref_data.trajectories(cell["config"]["data"], tr.data_seed, CPU)[0],
                         2, cell["config"]["data"]["interval"])
    for s in range(drv.WARM_STEPS):
        loss, grads = ref.step(P, opt, x[tr.warm["rows"][s]], tr.warm["coef"][s])
        assert float(loss) == pytest.approx(float(tr.warm["loss"][s]), rel=1e-5)
        if s == 0:
            g_med = torch.stack([g.norm() for g in grads.values()]).median()
            moved = {n for n, g in grads.items() if g.norm() >= 1e-3 * g_med}
    for name, p, _, _ in tr.leaves:
        if name in moved:
            want = P[name].T if name.endswith(".kernel") else P[name]
            np.testing.assert_allclose(p.detach(), want, atol=1e-6)
