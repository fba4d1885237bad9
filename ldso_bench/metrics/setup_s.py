"""Seconds from the process's start to the window's first frame: imports,
CUDA start, the kernels' libraries (built into ``.build/`` at a checkout's
first run), the ring's render, the bootstrap and the warm frames."""


def read(ctx):
    return ctx.setup_s
