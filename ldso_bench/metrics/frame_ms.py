"""Milliseconds a frame of the window, from the program's own spans: the
mean `add_frame` span over the window's frames (the traced run's frame
time, the denominator of the other span metrics)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["add_frame"], "span")
