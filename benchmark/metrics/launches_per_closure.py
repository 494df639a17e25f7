"""Kernels launched in the device stretch over the closures evaluated in it
(the program's K2 forward launches, one a closure)."""


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("closures"):
        return None
    return len(d["trace"].kernels) / d["closures"]
