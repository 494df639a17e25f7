"""The operations of a batch step (the autoencoder's and the
discriminator's three passes, forward and backward, from the
configuration's widths: counts/flops.py::lassi_step_flops), over the median
of the window's untraced step intervals (CUDA events) and the f32 peak, in
%. Read in a traced run, which also has the untraced steps."""

from benchmark.counts import flops


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("steps") or not ctx.get("step_ms_median"):
        return None
    return 100.0 * ctx["step_flops"] / (ctx["step_ms_median"] / 1e3 * flops.H100_F32_FLOPS)
