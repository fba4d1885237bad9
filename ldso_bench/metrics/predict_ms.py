"""Milliseconds a frame of the constant-velocity prediction and the motion
hypotheses (`predict` span in `frame_step._track_pyr`)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["predict"], "frame")
