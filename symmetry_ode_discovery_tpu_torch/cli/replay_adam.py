"""Replay of the JAX package's Adam trainer on the port: the dump of
``tools/dump_jax_draws.py --adam`` (the JAX trainer's init, each epoch's
permutation and rows, its parameters, mask and mean loss components after
each epoch, in float32 and float64) fed through the port's
training/siged_adam.py as the port's CLI builds it.

    python -m symmetry_ode_discovery_tpu_torch.cli.replay_adam \
        --draws build/chip_data/adam-noise20-selkov.npz [--float64] [--device cpu]

Prints one JSON line: per epoch the largest relative difference of the
loss components and the parameters' relative difference (Frobenius) from
the dump's run of the same precision, and the masks; and the rule
(float32): epoch 0's components within 1e-5 relative, the parameters
after the last epoch within 1e-3, the final mask equal. The checkpoint of
the dump's config is read from saved_models/ under the working directory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device

COMPONENT_REL = 1e-5   # epoch 0's loss components
PARAMS_REL = 1e-3      # the parameters after the last epoch


def replay(path: str, float64: bool = False, device=None, ckpt_root: str = "saved_models"):
    from ..models.lie_generator import GeneratorState
    from ..training.siged_adam import train_siged_adam
    from ..utils.config import get_args
    from .main import build_adam_trainer, build_fit

    device = resolve_device(device)
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    epochs = d["perm"].shape[1]
    argv = (["--config", str(d["config"]), "--sindy_optimizer", "adam", "--seed",
             str(int(d["seeds"][0])), "--num_epochs", str(epochs)] + [str(a) for a in d["extra"]])
    args = vars(get_args(argv))
    fit = build_fit(args, train_data=(d["x"], d["dx"]), device=device, ckpt_root=ckpt_root)
    dtype = torch.float64 if float64 else torch.float32
    x, dx = fit["x"].to(dtype), fit["dx"].to(dtype)
    if float64:
        fit["ae"] = fit["ae"].to(dtype)
        gs = fit["g_state"]
        fit["g_state"] = GeneratorState(*(tuple(t.to(dtype) for t in getattr(gs, f))
                                          for f in ("Li", "sigma", "struct_const", "masks")))
    tr = build_adam_trainer(args, fit)
    tag = "64" if float64 else ""
    want_p, want_m = d[f"params{tag}"], d[f"mask{tag}"]
    names = sorted(k.split("/", 1)[1] for k in d if k.startswith(f"epoch{tag}/"))
    rows = []

    def hook(e, theta, mask, metrics):
        p = theta.detach().double().cpu().numpy()
        rows.append({
            "epoch": e,
            "components_max_rel": max(abs(metrics[k] - d[f"epoch{tag}/{k}"][e])
                                      / max(abs(d[f"epoch{tag}/{k}"][e]), 1e-30) for k in names),
            "params_rel": float(np.linalg.norm(p - want_p[e]) / np.linalg.norm(want_p[e])),
            "mask_equal": bool(np.array_equal(mask.cpu().numpy(), want_m[e]))})

    t0 = time.perf_counter()
    train_siged_adam(tr, x, dx, theta0=torch.as_tensor(d["theta0"][0].reshape(-1)),
                     perms=d["perm"][0], epoch_hook=hook)
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec = {"draws": path, "float64": float64, "device": str(device), "rows": int(x.shape[0]),
           "epochs": epochs, "seconds": time.perf_counter() - t0, "per_epoch": rows,
           "rule": {"component_rel": COMPONENT_REL, "params_rel": PARAMS_REL}}
    rec["rule_met"] = bool(rows[0]["components_max_rel"] <= COMPONENT_REL
                           and rows[-1]["params_rel"] <= PARAMS_REL and rows[-1]["mask_equal"])
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", required=True)
    ap.add_argument("--float64", action="store_true",
                    help="replay in float64 against the dump's float64 run")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    return replay(a.draws, a.float64, a.device)


if __name__ == "__main__":
    main()
