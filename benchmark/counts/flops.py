"""Operations, bytes and peaks: the yardstick's own arithmetic.

Frozen copies of the port's smoke-run arithmetic (``chain_flops`` and
``bound`` of symmetry_ode_discovery_tpu_torch/smoke_setup.py, with the same
data-sheet peaks) and the model-operation counts of the two configurations.
Everything is worked out from the configuration's widths and the rows a run
processed, never from which kernel did the work, so a count still bounds a
gain after a kernel is replaced.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense, at the card's 700 W limit
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3

# per closure: K2 forward (encoder), K2 backward (its masked transpose chain),
# K3 forward (decoder primal and tangent: two chains), K3 backward (one)
ENC_CHAINS, DEC_CHAINS = 2, 3


def mlp_widths(d_in: int, hidden: int, n_layers: int, d_out: int) -> list:
    """[d_in, hidden x n_layers, d_out]: the widths of an MLP's layers."""
    return [d_in] + [hidden] * n_layers + [d_out]


def chain_flops(widths, hidden_only: bool = False) -> int:
    """Multiply-adds x 2 of one pass of a matrix chain per row (without its
    last layer when ``hidden_only``)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    if hidden_only:
        pairs = pairs[:-1]
    return 2 * sum(a * b for a, b in pairs)


def bound_s(bytes_moved: float, flops: float, peak_flops: float = H100_F32_FLOPS):
    """(least seconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the compute rate."""
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k23_work(rows: int, enc_widths, dec_widths):
    """(flops, bytes) of one closure's four K2/K3 launches over ``rows``
    rows: the operations of five chain passes, and each launch's weights,
    inputs, outputs and ReLU mask bits read or written once (f32)."""
    flops = rows * (ENC_CHAINS * chain_flops(enc_widths) + DEC_CHAINS * chain_flops(dec_widths))

    def weights(w):
        return 4 * sum(a * b + b for a, b in zip(w[:-1], w[1:]))

    def masks(w):
        return rows * sum(w[1:-1]) // 8

    enc_io = 4 * rows * (enc_widths[0] + enc_widths[-1])
    dec_in, dec_out = 4 * rows * dec_widths[0], 4 * rows * dec_widths[-1]
    nbytes = (2 * (weights(enc_widths) + masks(enc_widths) + enc_io)       # K2 fwd, bwd
              + weights(dec_widths) + masks(dec_widths) + 2 * dec_in + dec_out  # K3 fwd
              + weights(dec_widths) + masks(dec_widths) + dec_in + dec_out)     # K3 bwd
    return flops, nbytes


def mlp_train_flops(rows: int, widths, input_grad: bool) -> int:
    """Operations of a forward and backward pass of an MLP over ``rows``
    rows: per layer the forward product, the weight gradient and the input
    gradient (the first layer's only when ``input_grad``). Biases, norms and
    activations count as zero."""
    total = 0
    for k, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        products = 2 if (k == 0 and not input_grad) else 3
        total += products * 2 * a * b * rows
    return total


def lassi_step_flops(batch: int, n_comps: int, input_dim: int, latent_dim: int, hidden: int,
                     n_layers: int) -> int:
    """Operations of one LaLiGAN batch step (training/lassi.py) with
    use_original_x off: the encoder and decoder over every component row,
    and the discriminator three times over the batch's flattened latents (on
    the transformed latents for the generator's loss, with its input
    gradient; on the detached real and fake latents for its own loss)."""
    rows = batch * n_comps
    enc = mlp_widths(input_dim, hidden, n_layers, latent_dim)
    dec = mlp_widths(latent_dim, hidden, n_layers, input_dim)
    disc = mlp_widths(n_comps * latent_dim, hidden, n_layers, 1)
    return (mlp_train_flops(rows, enc, input_grad=False)
            + mlp_train_flops(rows, dec, input_grad=True)
            + mlp_train_flops(batch, disc, input_grad=True)
            + 2 * mlp_train_flops(batch, disc, input_grad=False))
