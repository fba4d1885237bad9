"""Device kernels, copies and sets in the traced slice, per frame."""


def read(ctx):
    if ctx.trace is None or not ctx.slice_frames:
        return None
    return ctx.trace["n_device_events"] / ctx.slice_frames
