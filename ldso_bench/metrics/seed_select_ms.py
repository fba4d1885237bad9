"""Milliseconds a keyframe of the candidate selection,
`FullSystem._dispatch_seed` (corners, gradient pixels, their pattern
samples; `seed_select` span)."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["seed_select"], "keyframe")
