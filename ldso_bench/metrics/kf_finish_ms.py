"""Milliseconds a keyframe of `FullSystem._finish_kf`: pose records,
frame flagging, point and frame marginalization (`kf_finish` span)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["kf_finish"], "keyframe")
