"""Milliseconds a keyframe of BA's damped solves, `ba.solve._solve_core`
(`ba.solve` spans, summed a keyframe)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["ba.solve"], "keyframe")
