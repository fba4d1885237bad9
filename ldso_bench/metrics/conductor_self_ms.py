"""Milliseconds a frame of `add_frame`'s self time: the conductor's own
host work (the keyframe decision, the records, the snapshot and the
dispatch) outside every span under it."""

from ldso_bench.harness import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["add_frame"], "frame", self_time=True)
