"""Kernels launched in the device stretch over its batch steps."""


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("steps"):
        return None
    return len(d["trace"].kernels) / d["steps"]
