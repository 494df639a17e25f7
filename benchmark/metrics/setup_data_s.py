"""Host seconds of the set-up's data generation on the device (trajectories,
noise, GP smoothing, windows), ending in a synchronise."""


def read(ctx):
    return ctx.get("setup_data_s")
