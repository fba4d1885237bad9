"""Milliseconds a frame of the tracker, `tracker.track_frame` (`track`
span; K2's two launches and their host side)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["track"], "frame")
