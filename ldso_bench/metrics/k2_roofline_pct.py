"""The tracker kernel (K2, ``track_levels_kernel``) against its roofline:
the least time its work needs (``harness/bounds.track_frame_bound_ms`` on
the kept calls of the traced slice, scaled to all its calls there) over
its device time in the trace, in %."""

from ldso_bench.harness import bounds, devtrace

CAPTURE = {"k2": "ldso_tpu_torch.kernels.track_level:track_levels_cuda"}


def read(ctx):
    keep = ctx.kept.get("k2") if ctx.trace else None
    if not keep or not keep.kept:
        return None
    n, t = devtrace.kernel_time(ctx.trace, "track_levels_kernel")
    if t <= 0:
        return None
    mean = sum(bounds.track_frame_bound_ms(r["args"], r["out"]) for r in keep.kept) / len(keep.kept)
    return 100.0 * mean * keep.seen / (1e3 * t)
