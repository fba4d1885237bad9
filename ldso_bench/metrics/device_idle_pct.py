"""The traced slice's time in which no operation ran on the device, in %:
the slice minus the union of its device events, over the slice."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
