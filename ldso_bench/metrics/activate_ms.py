"""Milliseconds a keyframe of the activation: `lifecycle.kf_activate` (K5)
and the bank's drop commit (`activate` span)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["activate"], "keyframe")
