"""100 x (1 - the device's busy time a step / the median step interval), in
a LaLiGAN training cell. The busy time is the device stretch's busy union
over its steps; the interval is the median of the window's untraced step
intervals (CUDA events), since the profiler's callback on each launch
stretches a traced step's wall."""


def read(ctx):
    d = ctx.get("device")
    if not d or not d.get("steps") or not ctx.get("step_ms_median"):
        return None
    busy = d["trace"].busy_s() / d["steps"]
    return 100.0 * (1.0 - busy / (ctx["step_ms_median"] / 1e3))
