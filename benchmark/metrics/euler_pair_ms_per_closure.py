"""Device milliseconds of the kernels launched under the program's
euler_pair and euler_pair.backward labels, over the closures of the host
stretch."""

LABELS = ("euler_pair", "euler_pair.backward")


def read(ctx):
    h = ctx.get("host")
    if not h or not h.get("closures"):
        return None
    seconds = h["trace"].device_s_under(LABELS)
    return seconds * 1e3 / h["closures"] if seconds > 0 else None
