"""The 95th percentile of the host milliseconds of each ``add_frame`` call
of the window (the conductor, ``system.FullSystem.add_frame``)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.add_frame_ms, 95)) if ctx.add_frame_ms else None
