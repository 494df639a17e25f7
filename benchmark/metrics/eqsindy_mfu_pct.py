"""The operations the closures' frozen-autoencoder chains need (five chain
passes a row, counts/flops.py::k23_work), over the device stretch's wall and
the f32 peak, in %. The Euler pair's and the optimizer's operations count as
zero. The count does not depend on which kernel does the work."""

from benchmark.counts import flops


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("chain_rows"):
        return None
    f, _ = flops.k23_work(d["chain_rows"], ctx["enc_widths"], ctx["dec_widths"])
    return 100.0 * f / (d["trace"].window_s * flops.H100_F32_FLOPS)
