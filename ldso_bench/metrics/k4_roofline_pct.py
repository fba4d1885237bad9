"""The BA linearization kernel (K4, ``ba_kernel``) against its roofline:
the least time its evaluations need (``harness/bounds.ba_bound_ms`` on the
kept calls of the traced slice, scaled to all its calls there, assemble
and energy_only apart) over its device time in the trace, in %."""

from ldso_bench.harness import bounds, devtrace

CAPTURE = {"k4": "ldso_tpu_torch.kernels.ba:assemble_cuda",
           "k4e": "ldso_tpu_torch.kernels.ba:energy_only_cuda"}


def total_bound_ms(ctx):
    """The K4 evaluations' least time over the slice, or None."""
    total = 0.0
    for key in ("k4", "k4e"):
        keep = ctx.kept.get(key)
        if keep is None or not keep.seen:
            continue
        if not keep.kept:
            return None
        b = [bounds.ba_bound_ms(r["args"][0], r["args"][3] if key == "k4" else "energy",
                                r["out"].valid_pair if key == "k4" else None)
             for r in keep.kept]
        total += sum(b) / len(b) * keep.seen
    return total


def read(ctx):
    if ctx.trace is None:
        return None
    n, t = devtrace.kernel_time(ctx.trace, "ba_kernel")
    total = total_bound_ms(ctx)
    if not n or t <= 0 or not total:
        return None
    return 100.0 * total / (1e3 * t)
