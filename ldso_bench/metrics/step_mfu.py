"""The whole step's share of the chip's peak over the traced slice, in %:
the least time the counted work of the hand kernels on the path needs
(K1 a frame, K2 and K4 as their roofline readers count them,
``harness/bounds.py``) over the slice's wall time. A kernel taken off the
path leaves its roofline silent; this share still counts its work."""

from ldso_bench.harness import bounds
from ldso_bench.harness.cells import load_reader

CAPTURE = {"k2": "ldso_tpu_torch.kernels.track_level:track_levels_cuda",
           "k4": "ldso_tpu_torch.kernels.ba:assemble_cuda",
           "k4e": "ldso_tpu_torch.kernels.ba:energy_only_cuda"}


def read(ctx):
    if ctx.trace is None or not ctx.slice_frames:
        return None
    k2 = ctx.kept.get("k2")
    if not k2 or not k2.kept:
        return None
    k2_ms = sum(bounds.track_frame_bound_ms(r["args"], r["out"]) for r in k2.kept) \
        / len(k2.kept) * k2.seen
    k4_ms = load_reader("k4_roofline_pct").total_bound_ms(ctx) or 0.0
    k1_ms = bounds.pyramid_bound_ms(ctx.h, ctx.w, ctx.cfg.shapes.pyr_levels) * ctx.slice_frames
    return 100.0 * (k1_ms + k2_ms + k4_ms) / (1e3 * ctx.trace["window_s"])
