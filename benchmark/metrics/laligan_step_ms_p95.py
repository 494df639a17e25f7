"""The 95th percentile of the intervals between consecutive batch-step
completions over every step of the window (CUDA events recorded after each
step, read after it; a traced stretch's steps and the step after it are
left out), in ms. A stall or an idle gap counts."""


def read(ctx):
    return ctx.get("step_ms_p95")
