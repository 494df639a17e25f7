"""Conversion of the JAX package's parameters (as numpy arrays) and of its
LaLiGAN checkpoint files into the port's tensors, and of a LaLiGAN trained by
the port back into the JAX package's layout (``lassi_to_jax``).

Nothing here imports JAX: a JAX array or state is read through
``np.asarray`` on its fields. Both packages store Q in the row-major vec(Xi)
convention and theta as [beta, const], so conversion is a change of
container, dtype and device; these functions pin that layout down.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from . import resolve_device
from .models.sindy import SINDyState

_STATE_FIELDS = ("Xi", "mask", "beta", "const", "Q")


def _f32(a, device, dtype=torch.float32) -> torch.Tensor:
    # a row-major copy: JAX arrays read through np.asarray are read-only, and
    # Q from the SVD is a column-major slice (float32 unless dtype says)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.tensor(np.ascontiguousarray(a, dtype=np_dtype), device=device).to(dtype)


def sindy_state(jax_state, device=None) -> SINDyState:
    """The port's SINDyState from the JAX package's (Xi, mask, beta, const, Q
    fields), such that the port's get_Xi equals the JAX one."""
    device = resolve_device(device)
    return SINDyState(**{f: _f32(getattr(jax_state, f), device) for f in _STATE_FIELDS})


def q_matrix(Q, device=None) -> torch.Tensor:
    """Q (d*p, r), row-major vec(Xi) convention, as float32."""
    Q = _f32(Q, resolve_device(device))
    if Q.ndim != 2:
        raise ValueError(f"Q must be 2-D, got shape {tuple(Q.shape)}")
    return Q


def theta0(th0, device=None) -> torch.Tensor:
    """Initial parameters (lanes, n_params) = [beta, const] per lane, as float32."""
    th0 = _f32(th0, resolve_device(device))
    if th0.ndim != 2:
        raise ValueError(f"theta0 must be (lanes, n_params), got {tuple(th0.shape)}")
    return th0


def _nest(flat: dict) -> dict:
    """{"['params']/['encoder']/['Dense_0']/['kernel']": a, ...} (the JAX
    checkpoint's flat keys) -> nested dicts; list indices '[0]' become ints."""
    out: dict = {}
    for key, value in flat.items():
        parts = [p.strip("[]'\"") for p in key.split("/")]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(int(p) if p.isdigit() else p, {})
        last = parts[-1]
        node[int(last) if last.isdigit() else last] = value
    return out


def _tuple_of(node: dict, device) -> tuple:
    return tuple(_f32(node[i], device) for i in range(len(node)))


def _encoder_from_jax(enc: dict, ebs: dict, prefix: str, device, dtype) -> dict:
    """One EncoderMLP's flax subtree as state_dict entries under ``prefix``."""
    sd = {}
    n_layers = sum(1 for k in enc if k.startswith("Dense_"))
    ortho = "OrthoDense_0" in enc
    if not ortho:
        n_layers -= 1  # the last Dense is the latent layer
    for k in range(n_layers):
        sd[f"{prefix}dense.{k}.weight"] = _f32(np.asarray(enc[f"Dense_{k}"]["kernel"]).T,
                                               device, dtype)
        sd[f"{prefix}dense.{k}.bias"] = _f32(enc[f"Dense_{k}"]["bias"], device, dtype)
    bn_names = [(f"BatchNorm_{k}", f"{prefix}bn.{k}") for k in range(n_layers)]
    bn_names.append(("bn_final", f"{prefix}bn_final"))
    for flax_name, name in bn_names:
        if flax_name not in enc:
            continue
        sd[f"{name}.weight"] = _f32(enc[flax_name]["scale"], device, dtype)
        sd[f"{name}.bias"] = _f32(enc[flax_name]["bias"], device, dtype)
        sd[f"{name}.running_mean"] = _f32(ebs[flax_name]["mean"], device, dtype)
        sd[f"{name}.running_var"] = _f32(ebs[flax_name]["var"], device, dtype)
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    if ortho:
        sd[f"{prefix}out.V"] = _f32(enc["OrthoDense_0"]["V"], device, dtype)
        sd[f"{prefix}out.bias"] = _f32(enc["OrthoDense_0"]["bias"], device, dtype)
    else:
        sd[f"{prefix}out.weight"] = _f32(np.asarray(enc[f"Dense_{n_layers}"]["kernel"]).T,
                                         device, dtype)
        sd[f"{prefix}out.bias"] = _f32(enc[f"Dense_{n_layers}"]["bias"], device, dtype)
    return sd


def _decoder_from_jax(dec: dict, prefix: str, device, dtype) -> dict:
    sd = {}
    for k in range(sum(1 for k in dec if k.startswith("Dense_"))):
        sd[f"{prefix}dense.{k}.weight"] = _f32(np.asarray(dec[f"Dense_{k}"]["kernel"]).T,
                                               device, dtype)
        sd[f"{prefix}dense.{k}.bias"] = _f32(dec[f"Dense_{k}"]["bias"], device, dtype)
    return sd


_HALVES = ("model1", "model2")  # the submodules of ae_arch 'mlp_split'


def autoencoder_from_jax(params: dict, batch_stats: dict, device=None,
                         dtype=torch.float32) -> dict:
    """The JAX package's autoencoder parameters and BatchNorm statistics
    (nested dicts of numpy arrays, flax names) as a ``state_dict`` of the
    port's ``AutoEncoder`` (ae_arch 'mlp', or 'mlp_split' with its halves
    ``model1`` and ``model2``). Dense kernels (in, out) become Linear
    weights (out, in); OrthoDense's V stays (in, out). Floats become
    ``dtype``."""
    device = resolve_device(device)
    enc, dec = params["encoder"], params["decoder"]
    ebs = batch_stats.get("encoder", {})
    if "model1" in enc:
        sd = {}
        for h in _HALVES:
            sd.update(_encoder_from_jax(enc[h], ebs.get(h, {}), f"encoder.{h}.", device, dtype))
            sd.update(_decoder_from_jax(dec[h], f"decoder.{h}.", device, dtype))
        return sd
    return dict(_encoder_from_jax(enc, ebs, "encoder.", device, dtype),
                **_decoder_from_jax(dec, "decoder.", device, dtype))


def laligan_from_npz(directory, device=None):
    """(autoencoder state_dict, GeneratorState) from a JAX LaLiGAN checkpoint
    directory holding autoencoder.npz, generator.npz and generator_mask.npz
    (the discriminator is not read: equation discovery does not use it).
    Raises FileNotFoundError when a file is missing."""
    from .models.lie_generator import GeneratorState

    device = resolve_device(device)
    trees = {}
    for name in ("autoencoder", "generator", "generator_mask"):
        path = os.path.join(directory, f"{name}.npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"LaLiGAN checkpoint file missing: {path}")
        with np.load(path, allow_pickle=False) as z:
            trees[name] = _nest({k: z[k] for k in z.files})
    ae = trees["autoencoder"]
    sd = autoencoder_from_jax(ae["params"], ae["batch_stats"], device)
    g = trees["generator"]
    g_state = GeneratorState(
        Li=_tuple_of(g["Li"], device), sigma=_tuple_of(g["sigma"], device),
        struct_const=_tuple_of(g["struct_const"], device),
        masks=_tuple_of(trees["generator_mask"], device))
    return sd, g_state


def _encoder_to_jax(a: dict, prefix: str) -> tuple:
    enc, ebs = {}, {}
    n_layers = sum(1 for k in a if re.fullmatch(re.escape(prefix) + r"dense\.\d+\.weight", k))
    for k in range(n_layers):
        enc[f"Dense_{k}"] = {"kernel": a[f"{prefix}dense.{k}.weight"].T.copy(),
                             "bias": a[f"{prefix}dense.{k}.bias"]}
    bn_names = [(f"BatchNorm_{k}", f"{prefix}bn.{k}") for k in range(n_layers)]
    bn_names.append(("bn_final", f"{prefix}bn_final"))
    for flax_name, name in bn_names:
        if f"{name}.weight" not in a:
            continue
        enc[flax_name] = {"scale": a[f"{name}.weight"], "bias": a[f"{name}.bias"]}
        ebs[flax_name] = {"mean": a[f"{name}.running_mean"], "var": a[f"{name}.running_var"]}
    if f"{prefix}out.V" in a:
        enc["OrthoDense_0"] = {"V": a[f"{prefix}out.V"], "bias": a[f"{prefix}out.bias"]}
    else:
        enc[f"Dense_{n_layers}"] = {"kernel": a[f"{prefix}out.weight"].T.copy(),
                                    "bias": a[f"{prefix}out.bias"]}
    return enc, ebs


def _decoder_to_jax(a: dict, prefix: str) -> dict:
    n = sum(1 for k in a if re.fullmatch(re.escape(prefix) + r"dense\.\d+\.weight", k))
    return {f"Dense_{k}": {"kernel": a[f"{prefix}dense.{k}.weight"].T.copy(),
                           "bias": a[f"{prefix}dense.{k}.bias"]} for k in range(n)}


def autoencoder_to_jax(sd: dict) -> tuple:
    """(params, batch_stats), nested dicts of numpy arrays with flax's names,
    of the port's AutoEncoder state_dict (ae_arch 'mlp' or 'mlp_split'):
    the inverse of ``autoencoder_from_jax``."""
    a = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    if any(k.startswith("encoder.model1.") for k in a):
        enc, ebs, dec = {}, {}, {}
        for h in _HALVES:
            enc[h], bs = _encoder_to_jax(a, f"encoder.{h}.")
            if bs:
                ebs[h] = bs
            dec[h] = _decoder_to_jax(a, f"decoder.{h}.")
    else:
        (enc, ebs), dec = _encoder_to_jax(a, "encoder."), _decoder_to_jax(a, "decoder.")
    return {"encoder": enc, "decoder": dec}, {"encoder": ebs}


def discriminator_from_jax(params: dict, device=None, dtype=torch.float32) -> dict:
    """The JAX package's Discriminator parameters (Dense_0 ... Dense_n) as a
    state_dict of the port's Discriminator (floats in ``dtype``)."""
    device = resolve_device(device)
    sd = {}
    for k in range(sum(1 for name in params if name.startswith("Dense_"))):
        sd[f"dense.{k}.weight"] = _f32(np.asarray(params[f"Dense_{k}"]["kernel"]).T, device,
                                       dtype)
        sd[f"dense.{k}.bias"] = _f32(params[f"Dense_{k}"]["bias"], device, dtype)
    if "Embed_0" in params:
        sd["embed.weight"] = _f32(params["Embed_0"]["embedding"], device, dtype)
    return sd


def discriminator_to_jax(sd: dict) -> dict:
    a = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    out = {f"Dense_{k}": {"kernel": a[f"dense.{k}.weight"].T.copy(), "bias": a[f"dense.{k}.bias"]}
           for k in range(sum(1 for k in a if re.fullmatch(r"dense\.\d+\.weight", k)))}
    if "embed.weight" in a:
        out["Embed_0"] = {"embedding": a["embed.weight"]}
    return out


_SINDY_CARRY = ("Xi", "mask", "resid", "Q", "L_prev")


def lassi_from_jax(bundle: dict, batch_stats: dict, device=None,
                   dtype=torch.float32, sindy_carry: dict = None) -> tuple:
    """(autoencoder state_dict, discriminator state_dict, GeneratorState) of
    the JAX package's LaLiGAN trainer state: ``bundle`` {"ae", "d", "g"} as
    LassiTrainer.init returns it (g a GeneratorState with Li, sigma,
    struct_const and masks, or a dict of them) and the autoencoder's batch
    statistics, read as numpy arrays; floats become ``dtype``. Given the
    joint SINDy state's ``sindy_carry``, a fourth item: the port's sindy
    state, a dict of tensors with "Xi" (the Adam branch's bundle["sindy"]
    ["Xi"], else the carry's), "mask", and on the least-squares branch
    "resid", and "Q" and "L_prev" under the constraint."""
    from .models.lie_generator import GeneratorState

    device = resolve_device(device)
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in t.items()}
    ae_sd = autoencoder_from_jax(tree(bundle["ae"]), tree(batch_stats), device, dtype)
    d_sd = discriminator_from_jax(tree(bundle["d"]), device, dtype)
    g = bundle["g"]
    field = (lambda f: g[f]) if isinstance(g, dict) else (lambda f: getattr(g, f))
    g_state = GeneratorState(**{f: tuple(_f32(a, device, dtype) for a in field(f))
                                for f in ("Li", "sigma", "struct_const", "masks")})
    if sindy_carry is None:
        return ae_sd, d_sd, g_state
    sindy = {k: _f32(np.asarray(sindy_carry[k]), device, dtype) for k in _SINDY_CARRY
             if k in sindy_carry}
    if "sindy" in bundle:
        sindy["Xi"] = _f32(np.asarray(bundle["sindy"]["Xi"]), device, dtype)
    return ae_sd, d_sd, g_state, sindy


def lassi_to_jax(ae_sd: dict, disc_sd: dict, g_state, sindy: dict = None,
                 sindy_adam: bool = False) -> dict:
    """The JAX package's layout of a LaLiGAN: {"ae": params, "batch_stats",
    "d": discriminator params, "g": {"Li", "sigma", "struct_const",
    "masks"} (tuples of arrays)}, numpy arrays throughout. Given the port's
    sindy state, also "sindy_carry" (the carry's fields) and, on the Adam
    branch (``sindy_adam``), "sindy": {"Xi"} (the bundle's parameter, which
    the carry then does not hold)."""
    params, bstats = autoencoder_to_jax(ae_sd)
    g = {f: tuple(t.detach().cpu().numpy() for t in getattr(g_state, f))
         for f in ("Li", "sigma", "struct_const", "masks")}
    out = {"ae": params, "batch_stats": bstats, "d": discriminator_to_jax(disc_sd), "g": g}
    if sindy is not None:
        carry = {k: v.detach().cpu().numpy() for k, v in sindy.items()}
        if sindy_adam:
            out["sindy"] = {"Xi": carry.pop("Xi")}
        out["sindy_carry"] = carry
    return out
