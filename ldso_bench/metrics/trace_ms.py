"""Milliseconds a frame of the epipolar trace, `frame_step._trace_core`
(`trace` span; K3 and its host side)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["trace"], "frame")
