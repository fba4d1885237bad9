"""The port's own spans and counters (``ldso_tpu_torch.telemetry``) over
the measured window, for the per-layer metrics that read them.

Importing this module turns the port's recorder on. The readers that
import it are loaded only in ``--trace 1`` runs, after the warm frames and
just before the window (``main.drive``), so the recorder runs through the
traced window and slice and is off in every untraced run. A program
without the recorder gives every reader None.
"""

from __future__ import annotations

import sys

try:
    from ldso_tpu_torch import telemetry
except ImportError:              # a program that has no recorder
    telemetry = None
else:
    telemetry.enable()


def window_frames(ctx):
    """The recorded frames of the window: of the last ``ctx.window_frames
    + ctx.slice_frames`` frames recorded, the first ``ctx.window_frames``;
    None without a recorder, or if any frame fell off its ring."""
    if telemetry is None:
        return None
    frames, dropped = telemetry.frames()
    frames = [f for f in frames if f.id is not None]
    n = ctx.window_frames + ctx.slice_frames
    if dropped or len(frames) < n or not ctx.window_frames:
        return None
    return frames[len(frames) - n:len(frames) - ctx.slice_frames or None]


_printed: set = set()         # ids of the runs' contexts whose spans were printed


def totals(ctx):
    """{span name: [spans, total ns, self ns]} over the window's frames,
    or None (``window_frames``). The first call of a run prints every
    span's count and ms a frame (total, self) and the counters to
    standard error."""
    frames = window_frames(ctx)
    if frames is None:
        return None
    t = telemetry.totals(frames)
    if id(ctx) not in _printed:
        _printed.add(id(ctx))
        n = ctx.window_frames
        print(f"program spans over the window's {n} frames (count, ms a frame total / self): "
              + ", ".join(f"{k} {v[0]} {v[1] * 1e-6 / n:.4f}/{v[2] * 1e-6 / n:.4f}"
                          for k, v in sorted(t.items(), key=lambda kv: -kv[1][1]))
              + f"; counters {counts(ctx)}", file=sys.stderr)
    return t


def ms_per(ctx, names, per: str, self_time: bool = False):
    """Milliseconds of the spans ``names`` over the window, summed and
    divided by its frames (``per="frame"``), its keyframes (``"keyframe"``)
    or the spans of the first name (``"span"``); None where the window has
    none of them."""
    t = totals(ctx)
    if t is None:
        return None
    found = [t[n] for n in names if n in t]
    if not found:
        return None
    ns = sum(v[2 if self_time else 1] for v in found)
    base = {"frame": ctx.window_frames, "keyframe": ctx.keyframes,
            "span": t.get(names[0], [0])[0]}[per]
    return ns * 1e-6 / base if base else None


def counts(ctx) -> dict:
    """The window's counters summed over its frames, or None."""
    frames = window_frames(ctx)
    if frames is None:
        return None
    out: dict = {}
    for f in frames:
        for k, v in f.counts.items():
            out[k] = out.get(k, 0) + v
    return out
