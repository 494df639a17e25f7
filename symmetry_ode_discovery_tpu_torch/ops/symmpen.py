"""Frozen-autoencoder chains of the EquivSINDy-r penalty: folding, the CUDA
kernels (csrc/symmpen.cu) and their plain PyTorch versions.

The port's counterpart of symmetry_ode_discovery_tpu/ops/pallas_symmpen.py.
With the autoencoder frozen and ReLU activations, every chain the penalty
needs is a masked matrix chain:

  encoder      z = A_K(relu(... relu(A_0 x)))      (eval-mode BatchNorm, the
               orthogonal latent layer's QR factor and the global z-mean folded
               into plain (W, b) pairs once)
  its VJP      cx = ((cz W_K^T) . m_{K-1}) W_{K-1}^T ...
  decoder JVP  v = t_K W_K, t_{k+1} = m_k . (t_k W_k), m_k = [p_k > 0] from
               the primal chain p_k = a_k W_k + b_k
  its VJP      cu = ((cv W_K^T) . m_{K-1}) W_{K-1}^T ...;  cz = 0 (the masks
               are piecewise constant, as ReLU autodiff gives)

``enc_apply`` (K2) and ``dec_jvp`` (K3) are ``torch.autograd.Function``s
whose forward and backward are kernels for CUDA tensors and the plain
versions for CPU tensors; ``enc_apply_plain`` and ``dec_jvp_plain`` are the
same functions with the plain versions on any device. Each forward returns
the ReLU masks of its primal chain beside its output and autograd keeps them
as the residual; the backward runs only the masked transpose chain on them
(the JAX package keeps x and recomputes the masks). The kernels take any
hidden width up to MAX_HIDDEN = 512 (512 for the LV checkpoint, 128 for
selkov), the same width in every hidden layer; a wider chain raises.

Two compute dtypes, as the JAX kernels' ``dtype`` (``make_enc_apply``,
``make_dec_jvp``): float32 (no TF32), and bfloat16, which rounds where the
JAX bodies round (``_chain_fwd``, ``_mask_bwd``, ``_dec_jvp_kernel``): the
input, every folded weight, the activation after each ReLU, the tangent
after each mask and the cotangent before each hop are bf16; the bias add,
the masks [p > 0] of the f32 pre-activation, the accumulation and the
outputs are f32. A bf16 x bf16 product is exact in f32, so the plain
versions multiply the rounded values in f32 (an f32 product in k order) and
only the summation parts them from the kernels, which sum every bf16
product on the tensor cores, as the reference's jnp.dot(bf16, bf16,
preferred_element_type=f32) sums on the MXU: in their order and with their
rounding. So a bf16 forward kernel flips the odd mask whose pre-activation
lies within rounding of 0, and the tangent and backward rows that mask gates
move with it; ``mask_flips`` finds those rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from ..models.mlp import ortho_weight
from ._nvcc import CSRC, Kernel

SOURCE = CSRC / "symmpen.cu"
MAX_HIDDEN = 512   # the widest hidden layer the kernels take
TILE_WIDTHS = (128, 256, 512)   # the kernel's tile widths (a template parameter)
MAX_LAYERS = 10    # weight matrices
MAX_FEATURES = 8   # input and output features
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL = Kernel(SOURCE, NVCC_FLAGS, {
    "symmpen_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                       ctypes.c_int),
    "symmpen_row_tile": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "symmpen_cluster": ([], ctypes.c_int)})

MODES = {"enc_fwd": 0, "dec_jvp": 1, "enc_bwd": 2, "dec_jvp_bwd": 2}
DTYPES = (torch.float32, torch.bfloat16)
# Kernel launches through enc_apply / dec_jvp, by function and dtype (bf16
# launches under <function>_bf16; the plain path does not count). K2 is
# enc_fwd + enc_bwd, K3 dec_jvp + dec_jvp_bwd.
launches = {name + suffix: 0 for suffix in ("", "_bf16") for name in MODES}


def launch_key(kind: str, dtype=torch.float32) -> str:
    """The ``launches`` key of a kernel function (a key of MODES) in ``dtype``."""
    return kind if dtype == torch.float32 else kind + "_bf16"


@dataclasses.dataclass(frozen=True)
class FoldedMLP:
    """A frozen x -> A_K(relu(... relu(A_0 x + b_0) ...)) + b_K chain.

    Ws[k] is (d_k, d_{k+1}), the JAX package's layout; WTs[k] is its
    transpose, contiguous, for the kernels' backward products. ReLU follows
    every layer but the last. float32 tensors on one device. The bf16
    copies the plain versions and the kernels read are made once, at first
    use (``rounded``, ``padded_bf16``)."""

    Ws: Tuple[torch.Tensor, ...]
    bs: Tuple[torch.Tensor, ...]
    WTs: Tuple[torch.Tensor, ...]
    _cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def make(cls, Ws, bs):
        Ws = tuple(w.detach().to(torch.float32).contiguous() for w in Ws)
        bs = tuple(b.detach().to(torch.float32).contiguous() for b in bs)
        return cls(Ws, bs, tuple(w.T.contiguous() for w in Ws))

    @property
    def n_relu(self) -> int:
        return len(self.Ws) - 1

    @property
    def d_in(self) -> int:
        return self.Ws[0].shape[0]

    @property
    def d_out(self) -> int:
        return self.Ws[-1].shape[1]

    @property
    def hidden(self) -> int:
        return self.Ws[0].shape[1]

    def rounded(self, dtype):
        """(Ws, WTs) as the chain in ``dtype`` multiplies them: the f32
        weights themselves, or rounded to bf16 and held in f32."""
        if dtype == torch.float32:
            return self.Ws, self.WTs
        if "rounded" not in self._cache:
            Ws = tuple(w.to(dtype).float() for w in self.Ws)
            self._cache["rounded"] = (Ws, tuple(w.T.contiguous() for w in Ws))
        return self._cache["rounded"]

    def padded_bf16(self, W: int):
        """(Ws, WTs, bs) for the bf16 kernel of tile width W: every hidden
        width zero-padded to W (16-byte rows at any width), the weights bf16,
        the biases f32. Padded columns stay exactly 0 through the chain."""
        key = ("padded", W)
        if key not in self._cache:
            K = len(self.Ws) - 1
            Ws, bs = [], []
            for k, (w, b) in enumerate(zip(self.Ws, self.bs)):
                r = W if k > 0 else w.shape[0]
                c = W if k < K else w.shape[1]
                p = w.new_zeros((r, c))
                p[:w.shape[0], :w.shape[1]] = w
                Ws.append(p.to(torch.bfloat16))
                if k < K:
                    b = torch.cat([b, b.new_zeros(W - b.shape[0])])
                bs.append(b.contiguous())
            self._cache[key] = (tuple(Ws), tuple(w.T.contiguous() for w in Ws), tuple(bs))
        return self._cache[key]


def _bn_affine(bn):
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


def _require_relu(ae):
    if ae.cfg.ae_arch != "mlp":
        raise ValueError("the fused penalty chains require ae_arch 'mlp'")
    if ae.cfg.activation != "ReLU":
        raise ValueError("the fused penalty chains require ReLU activation")


@torch.no_grad()
def fold_encoder(ae, z_mean=None) -> FoldedMLP:
    """The eval-mode encoder of ``ae`` (models.autoencoder.AutoEncoder) as a
    plain chain: BatchNorm affines folded into the preceding layer, the
    orthogonal factor evaluated once, z_mean subtracted in the last bias."""
    _require_relu(ae)
    enc = ae.encoder
    Ws, bs = [], []
    for k, layer in enumerate(enc.dense):
        W, b = layer.weight.T, layer.bias
        if enc.bn is not None:
            s, t = _bn_affine(enc.bn[k])
            W, b = W * s[None, :], b * s + t
        Ws.append(W)
        bs.append(b)
    if hasattr(enc.out, "V"):
        W = ortho_weight(enc.out.V)
    else:
        W = enc.out.weight.T
    b = enc.out.bias
    if enc.bn_final is not None:
        s, t = _bn_affine(enc.bn_final)
        W, b = W * s[None, :], b * s + t
    if z_mean is not None:
        b = b - z_mean
    Ws.append(W)
    bs.append(b)
    return FoldedMLP.make(Ws, bs)


@torch.no_grad()
def fold_decoder(ae) -> FoldedMLP:
    """The decoder is already a plain chain."""
    _require_relu(ae)
    return FoldedMLP.make([l.weight.T for l in ae.decoder.dense],
                          [l.bias for l in ae.decoder.dense])


def mlp_ref(folded: FoldedMLP, x: torch.Tensor) -> torch.Tensor:
    """The folded chain by plain autograd-able operations."""
    h = x
    for k, (W, b) in enumerate(zip(folded.Ws, folded.bs)):
        h = h @ W + b
        if k < folded.n_relu:
            h = torch.relu(h)
    return h


# ---- plain versions: the kernels' arithmetic with torch.matmul ----
#
# The forward functions return (output, masks) and the backward functions take
# the masks, as the kernels do: the plain masks are a tuple of (rows, width)
# bool tensors, one per hidden layer; the kernels' are one packed buffer
# (``unpack_masks``). ``dtype`` is the compute dtype (DTYPES); inputs and
# outputs are float32 in both.

def _check_dtype(dtype):
    if dtype not in DTYPES:
        raise ValueError(f"the symmpen chains compute in float32 or bfloat16, not {dtype}")


def _round(t, dtype):
    """t rounded to ``dtype`` and held in f32 (t itself in f32)."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _chain_fwd_plain(f: FoldedMLP, x, dtype=torch.float32):
    """(output, masks) of the chain."""
    _check_dtype(dtype)
    Ws, _ = f.rounded(dtype)
    h, masks = _round(x, dtype), []
    for k, (W, b) in enumerate(zip(Ws, f.bs)):
        p = h @ W + b
        if k < f.n_relu:
            masks.append(p > 0.0)
            h = _round(torch.relu(p), dtype)
        else:
            h = p
    return h, tuple(masks)


def _mask_bwd_plain(f: FoldedMLP, masks, c, dtype=torch.float32):
    _check_dtype(dtype)
    _, WTs = f.rounded(dtype)
    g = _round(c, dtype) @ WTs[-1]
    for k in range(f.n_relu - 1, -1, -1):
        g = torch.where(masks[k], g, 0.0)
        g = _round(g, dtype) @ WTs[k]
    return g


def enc_fwd_plain(f: FoldedMLP, x, dtype=torch.float32):
    """(z, masks) of the encoder chain at x."""
    return _chain_fwd_plain(f, x, dtype)


def enc_bwd_plain(f: FoldedMLP, masks, cz, dtype=torch.float32):
    """cx, the encoder's VJP of cz with the forward's masks."""
    return _mask_bwd_plain(f, masks, cz, dtype)


def dec_jvp_fwd_plain(f: FoldedMLP, z, u, dtype=torch.float32):
    """(v, masks): v = J_dec(z) u and the decoder's masks at z."""
    _check_dtype(dtype)
    Ws, _ = f.rounded(dtype)
    a, t, masks = _round(z, dtype), _round(u, dtype), []
    for k, (W, b) in enumerate(zip(Ws, f.bs)):
        p = a @ W + b
        tq = t @ W
        if k < f.n_relu:
            m = p > 0.0
            masks.append(m)
            a = _round(torch.relu(p), dtype)
            t = _round(torch.where(m, tq, 0.0), dtype)
        else:
            t = tq
    return t, tuple(masks)


def dec_jvp_bwd_plain(f: FoldedMLP, masks, cv, dtype=torch.float32):
    """cu, the JVP's VJP in u of cv with the forward's masks."""
    return _mask_bwd_plain(f, masks, cv, dtype)


# ---- kernels ----

def tile_width(hidden: int) -> int:
    """The kernel's tile width for a hidden width: 128, 256 or 512."""
    return next(w for w in TILE_WIDTHS if hidden <= w)


def row_tile(kind: str, hidden: int) -> int:
    """Data rows one CTA of ``kind`` (a key of MODES) takes at this hidden
    width, as the kernel's launcher computes them (builds the kernel)."""
    return KERNEL.lib().symmpen_row_tile(tile_width(hidden), MODES[kind])


def unpack_masks(packed, hidden: int):
    """The kernels' mask buffer, (hidden layers, rows, W / 8) uint8, as bools
    (hidden layers, rows, hidden). A row holds W / 16 little-endian 16-bit
    words; bit j of word g is column (j // 4) * (W / 4) + 4 g + j % 4."""
    n, rows, nbytes = packed.shape
    W = 8 * nbytes
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = ((packed[..., None] >> shifts) & 1).reshape(n, rows, W).bool()
    g = torch.arange(W // 16, device=packed.device)[:, None]
    j = torch.arange(16, device=packed.device)[None, :]
    cols = ((j // 4) * (W // 4) + 4 * g + j % 4).reshape(-1)
    out = torch.empty_like(bits)
    out[..., cols] = bits
    return out[..., :hidden]


def mask_flips(f: FoldedMLP, x, masks, rel=1e-4, dtype=torch.float32):
    """(flip rows, bits differing, unexplained): forward masks of the chain
    in ``dtype`` at x (bools, one (rows, hidden) plane per hidden layer, as
    the plain forwards return them or ``unpack_masks`` gives them) against
    the plain chain's [p > 0]. A row is a flip row (a bool per row) when its
    masks differ in any layer: the tangent and backward rows it gates may
    move by the flipped units' share of them. A differing bit is unexplained
    when |p| exceeds ``rel`` of sum_k |a_k W_kc| + |b_c|, the sum of |terms|
    behind p (two f32 summation orders, and the rounding of earlier layers,
    leave less than that; in bf16 a summation order can move an earlier
    layer's activation by one bf16 step, 2^-8 of it)."""
    Ws, _ = f.rounded(dtype)
    a = _round(x, dtype)
    rows, flips, unexplained = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device), 0, 0
    for k in range(f.n_relu):
        p = a @ Ws[k] + f.bs[k]
        scale = a.abs() @ Ws[k].abs() + f.bs[k].abs()
        differ = masks[k] != (p > 0.0)
        rows |= differ.any(dim=1)
        flips += int(differ.sum())
        unexplained += int((differ & (p.abs() > rel * scale)).sum())
        a = _round(torch.relu(p), dtype)
    return rows, flips, unexplained


def mask_agreement(f: FoldedMLP, x, packed, rel=1e-4, dtype=torch.float32):
    """(bits differing, unexplained) of the kernels' packed masks
    (``mask_flips``)."""
    return mask_flips(f, x, unpack_masks(packed, f.hidden), rel, dtype)[1:]


def _check_rows(name, x, width, device):
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got {x.dtype} on {x.device}")
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"{name} must be (rows, {width}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptrs(ts):
    return (ctypes.c_uint64 * len(ts))(*[t.data_ptr() for t in ts])


def check_chain(f: FoldedMLP):
    """Raise unless the kernels take this chain's shapes."""
    n_w = len(f.Ws)
    if not 2 <= n_w <= MAX_LAYERS:
        raise ValueError(f"the kernels take 2 to {MAX_LAYERS} layers, got {n_w}")
    widths = {int(w.shape[1]) for w in f.Ws[:-1]}
    if len(widths) != 1:
        raise ValueError(f"the kernels take one hidden width for every layer, got {sorted(widths)}")
    if not 1 <= f.hidden <= MAX_HIDDEN:
        raise ValueError(f"the kernels take hidden widths up to {MAX_HIDDEN}, got {f.hidden}")
    if not (1 <= f.d_in <= MAX_FEATURES and 1 <= f.d_out <= MAX_FEATURES):
        raise ValueError(f"the kernels take 1 to {MAX_FEATURES} input and output features")


def _launch(kind: str, f: FoldedMLP, in0, in1=None, masks=None, dtype=torch.float32):
    """One kernel launch of ``kind`` (a key of MODES) in ``dtype`` over the
    rows of in0. The forward kinds return (output, masks), the backward kinds
    the output and read ``masks``. In bf16 the kernel reads the chain's
    padded bf16 copy (``FoldedMLP.padded_bf16``)."""
    device = in0.device
    if device.type != "cuda":
        raise ValueError(f"the symmpen kernels run on cuda, not {device}")
    _check_dtype(dtype)
    check_chain(f)
    n_w = len(f.Ws)
    W = tile_width(f.hidden)
    bf16 = dtype == torch.bfloat16
    Ws, WTs, bs = f.padded_bf16(W) if bf16 else (f.Ws, f.WTs, f.bs)
    for t in Ws + WTs + bs:
        if t.device != device:
            raise ValueError(f"folded weights are on {t.device}, inputs on {device}")
        if t.data_ptr() % 16:
            raise ValueError("folded weights must be 16-byte aligned")
    mode = MODES[kind]
    rows = in0.shape[0]
    _check_rows("input", in0, f.d_out if mode == 2 else f.d_in, device)
    if mode == 1:
        _check_rows("second input", in1, f.d_in, device)
    shape = (f.n_relu, rows, W // 8)
    if mode == 2:
        if not (isinstance(masks, torch.Tensor) and masks.device == device
                and masks.dtype == torch.uint8 and tuple(masks.shape) == shape
                and masks.is_contiguous()):
            got = (f"{masks.dtype} {tuple(masks.shape)} on {masks.device}"
                   if isinstance(masks, torch.Tensor) else type(masks).__name__)
            raise ValueError(f"masks must be the forward kernel's contiguous uint8 {shape} "
                             f"on {device}, got {got}")
    else:
        masks = torch.empty(shape, dtype=torch.uint8, device=device)
    out = torch.empty((rows, f.d_in if mode == 2 else f.d_out), dtype=torch.float32,
                      device=device)
    if rows:
        lib = KERNEL.lib()
        with torch.cuda.device(device):
            rc = lib.symmpen_launch(mode, in0.data_ptr(), 0 if in1 is None else in1.data_ptr(),
                                    out.data_ptr(), masks.data_ptr(), rows, _ptrs(Ws),
                                    _ptrs(WTs), _ptrs(bs), n_w, f.d_in, f.d_out, f.hidden, W,
                                    int(bf16), torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"symmpen kernel ({launch_key(kind, dtype)}) launch failed: "
                               f"CUDA error {rc}")
        launches[launch_key(kind, dtype)] += 1
    return out if mode == 2 else (out, masks)


def enc_fwd_kernel(f, x, dtype=torch.float32):
    """(z, packed masks)."""
    return _launch("enc_fwd", f, x, dtype=dtype)


def enc_bwd_kernel(f, masks, cz, dtype=torch.float32):
    return _launch("enc_bwd", f, cz, masks=masks, dtype=dtype)


def dec_jvp_fwd_kernel(f, z, u, dtype=torch.float32):
    """(v, packed masks of the decoder at z)."""
    return _launch("dec_jvp", f, z, u, dtype=dtype)


def dec_jvp_bwd_kernel(f, masks, cv, dtype=torch.float32):
    return _launch("dec_jvp_bwd", f, cv, masks=masks, dtype=dtype)


_PLAIN = (enc_fwd_plain, enc_bwd_plain, dec_jvp_fwd_plain, dec_jvp_bwd_plain)
_KERNELS = (enc_fwd_kernel, enc_bwd_kernel, dec_jvp_fwd_kernel, dec_jvp_bwd_kernel)


def _impl(x, plain, dtype):
    """The plain versions when asked for or for CPU tensors, else the
    kernels; in ``dtype``."""
    fns = _PLAIN if plain or x.device.type == "cpu" else _KERNELS
    _check_dtype(dtype)
    return fns if dtype == torch.float32 else tuple(functools.partial(fn, dtype=dtype)
                                                    for fn in fns)


def _save_masks(ctx, masks):
    """Keep the forward's masks (a tuple of bool tensors or the packed
    buffer) for the backward. Under no_grad autograd keeps no ctx, so they
    are freed with the forward."""
    ctx.packed = isinstance(masks, torch.Tensor)
    ctx.save_for_backward(*((masks,) if ctx.packed else masks))


def _saved_masks(ctx):
    return ctx.saved_tensors[0] if ctx.packed else ctx.saved_tensors


class _EncApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, folded, plain, dtype):
        ctx.folded, ctx.impl = folded, _impl(x, plain, dtype)
        z, masks = ctx.impl[0](folded, x.contiguous())
        _save_masks(ctx, masks)
        return z

    @staticmethod
    def backward(ctx, cz):
        return ctx.impl[1](ctx.folded, _saved_masks(ctx), cz.contiguous()), None, None, None


class _DecJvp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, u, folded, plain, dtype):
        ctx.folded, ctx.impl = folded, _impl(z, plain, dtype)
        v, masks = ctx.impl[2](folded, z.contiguous(), u.contiguous())
        _save_masks(ctx, masks)
        return v

    @staticmethod
    def backward(ctx, cv):
        cu = ctx.impl[3](ctx.folded, _saved_masks(ctx), cv.contiguous())
        return torch.zeros_like(cu), cu, None, None, None


def enc_apply(folded: FoldedMLP, x, dtype=torch.float32):
    """z = encoder chain(x) computed in ``dtype``, x (rows, d_in) f32 ->
    (rows, d_out) f32; K2 on CUDA tensors. Differentiable in x (the backward
    reads the forward's masks)."""
    return _EncApply.apply(x, folded, False, dtype)


def enc_apply_plain(folded: FoldedMLP, x, dtype=torch.float32):
    return _EncApply.apply(x, folded, True, dtype)


def dec_jvp(folded: FoldedMLP, z, u, dtype=torch.float32):
    """v = J_dec(z) u computed in ``dtype``, (rows, d_in) f32 each ->
    (rows, d_out) f32; K3 on CUDA tensors. Differentiable in u; the gradient
    in z is exactly 0."""
    return _DecJvp.apply(z, u, folded, False, dtype)


def dec_jvp_plain(folded: FoldedMLP, z, u, dtype=torch.float32):
    return _DecJvp.apply(z, u, folded, True, dtype)
