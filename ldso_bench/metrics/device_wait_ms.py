"""Milliseconds a frame the host spends blocked on the device: every
`wait.*` span (the uploads, the diag event, BA's energy gate and its
read-back) over the window's frames."""

from ldso_bench.harness import program_spans

WAITS = ["wait.upload", "wait.diag", "wait.ba_gate", "wait.ba_stats"]


def read(ctx):
    if program_spans.totals(ctx) is None:
        return None
    return program_spans.ms_per(ctx, WAITS, "frame") or 0.0
