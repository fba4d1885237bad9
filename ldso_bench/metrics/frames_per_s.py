"""Frames whose ``add_frame`` returned inside the window, over the window's
seconds (host clock, ending in ``torch.cuda.synchronize()``)."""


def read(ctx):
    return ctx.window_frames / ctx.window_s
