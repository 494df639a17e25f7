"""Faults planted in the program, underneath a run, for the checks that the
comparison catches each fault a cell can have: a step that returns its
state unchanged; half of the batch left out, the mean taken over the rest;
an answer altered where it is produced, and, where a step answers for many
lanes, in one lane alone. (No cell spans chips, so none can lose an
exchange between them.) Each is a context manager that patches one
function of the port and restores it."""

from __future__ import annotations

import contextlib

import torch

KINDS = {"eqsindy_sweep": ("unchanged", "half_batch", "altered", "altered_lane"),
         "lassi_train": ("unchanged", "half_batch", "altered")}


@contextlib.contextmanager
def patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def sweep(kind: str):
    """A fault of the EquivSINDy-r stepper: its step drops the epoch's
    result; its penalty sees half of each lane's rows; its penalty comes out
    1% high, in every lane or in the first lane of each call."""
    from symmetry_ode_discovery_tpu_torch.cli import main
    from symmetry_ode_discovery_tpu_torch.training import siged

    if kind == "unchanged":
        real = siged.make_lbfgs_stepper

        def make(*a, **k):
            init, step, extract = real(*a, **k)

            def step_unchanged(carry, epoch):
                step(carry, epoch)
                return carry

            return init, step_unchanged, extract

        return patched(siged, "make_lbfgs_stepper", make)
    real_fit = main.build_fit

    def build_fit(*a, **k):
        fit = real_fit(*a, **k)
        fn = fit["sym_reg_fn"]
        if kind == "half_batch":
            def broken(XiM, x, ctx):
                h = x.shape[1] // 2
                return fn(XiM, x[:, :h], {"z_x": ctx["z_x"][:, :h],
                                          "v_xs": ctx["v_xs"][:, :, :h]})
        elif kind == "altered":
            def broken(XiM, x, ctx):
                return fn(XiM, x, ctx) * 1.01
        elif kind == "altered_lane":
            def broken(XiM, x, ctx):
                pen = fn(XiM, x, ctx)
                scale = torch.ones_like(pen)
                scale[0] = 1.01
                return pen * scale
        else:
            raise ValueError(f"unknown fault {kind!r}")
        broken.wants_coefs = True
        fit["sym_reg_fn"] = broken
        return fit

    return patched(main, "build_fit", build_fit)


def lassi(kind: str):
    """A fault of LaLiGAN's batch step: no Adam update; the step on half of
    the batch; the gradient of the autoencoder's first kernel 1% off as the
    backward hands it to Adam."""
    from symmetry_ode_discovery_tpu_torch.training.lassi import LassiTrainer

    real = LassiTrainer.step

    def step(self, x, generator=None, coef=None, dx=None, is_last=False):
        if kind == "unchanged":
            _, m, _ = self._loss(x, generator, coef, True, dx, is_last)
            return {k: v.detach() for k, v in m.items()}
        if kind == "half_batch":
            h = x.shape[0] // 2
            return real(self, x[:h], generator, None if coef is None else [c[:h] for c in coef],
                        None if dx is None else dx[:h], is_last)
        if kind == "altered":
            loss, m, _ = self._loss(x, generator, coef, True, dx, is_last)
            groups = {name: o.params for name, o in self.opt.items()}
            flat = [p for ps in groups.values() for p in ps]
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
            grads[0] = grads[0] * 1.01
            k = 0
            for name, ps in groups.items():
                self.opt[name].step(grads[k:k + len(ps)])
                k += len(ps)
            return {key: v.detach() for key, v in m.items()}
        raise ValueError(f"unknown fault {kind!r}")

    return patched(LassiTrainer, "step", step)


def plant(driver: str, kind: str):
    if kind not in KINDS[driver]:
        raise ValueError(f"{driver} has no fault {kind!r}")
    return {"eqsindy_sweep": sweep, "lassi_train": lassi}[driver](kind)
