"""The K2/K3 launches' least time over their summed device time in the
device stretch, in %: the operations and bytes of five chain passes over
every row the penalty evaluated there (counts/flops.py::k23_work), against
the f32 peak and the memory rate; the kernels found by name."""

from benchmark.counts import flops

KERNEL = "symmpen_kernel"


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("chain_rows"):
        return None
    device_s = d["trace"].device_s(lambda name: KERNEL in name)
    if device_s <= 0:
        return None
    f, b = flops.k23_work(d["chain_rows"], ctx["enc_widths"], ctx["dec_widths"])
    return 100.0 * flops.bound_s(b, f)[0] / device_s
