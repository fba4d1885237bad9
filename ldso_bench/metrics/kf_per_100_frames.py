"""Keyframes made in the window per 100 of its frames."""


def read(ctx):
    return 100.0 * ctx.keyframes / ctx.window_frames if ctx.window_frames else None
