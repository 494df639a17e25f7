"""100 x (1 - the device's busy union / the device stretch's wall), in a
sweep cell."""


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("closures"):
        return None
    return 100.0 * (1.0 - d["trace"].busy_s() / d["trace"].window_s)
