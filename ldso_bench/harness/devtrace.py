"""Reduce a ``torch.profiler`` run over the traced slice of frames.

Device activity is every CUDA event (kernels, copies, sets). The busy time
is the union of their intervals; the idle gaps between them are named by
the innermost harness label (``record_function``) open on the host at the
gap's middle, or ``no_label``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def events(prof):
    """(device events, host label events), each [(name, start_ns, end_ns)]."""
    dev, labels = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if not on_device:          # a label's copy on the device timeline is no work
                labels.append((e.name(), start, start + dur))
        elif on_device:
            dev.append((e.name(), start, start + dur))
    return dev, labels


def reduce(prof, t0_ns: int, t1_ns: int, labels_wanted: tuple) -> dict:
    """Summary of the device trace between host times ``t0_ns`` and
    ``t1_ns`` (the profiler's clock): busy seconds, window seconds, the
    device events (count and seconds by name) and the idle gaps by label."""
    dev, labels = events(prof)
    dev = sorted((d for d in dev if d[2] > t0_ns and d[1] < t1_ns), key=lambda d: d[1])
    busy, cur_s, cur_e = 0, None, None
    gaps = []
    prev_end = t0_ns
    for _, s, e in dev:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1_ns > prev_end:
        gaps.append((prev_end, t1_ns))
    by_name = defaultdict(lambda: [0, 0])
    for name, s, e in dev:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    # the innermost wanted label open at each gap's middle
    labs = sorted((s, e, n) for n, s, e in labels if n in labels_wanted)
    starts = [s for s, _, _ in labs]
    idle = defaultdict(int)
    for s, e in gaps:
        mid = (s + e) // 2
        best = None
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            ls, le, n = labs[j]
            if le >= mid:                 # the latest start that holds mid
                best = n
                break
            if mid - ls > 5_000_000_000:
                break
        idle[best or "no_label"] += e - s
    return dict(busy_s=busy * 1e-9, window_s=(t1_ns - t0_ns) * 1e-9,
                n_device_events=len(dev),
                ops={n: (c, t * 1e-9) for n, (c, t) in by_name.items()},
                idle_gaps={n: t * 1e-9 for n, t in idle.items()})


def kernel_time(summary: dict, needle: str) -> tuple:
    """(launches, device seconds) of the events whose name holds ``needle``."""
    n, t = 0, 0.0
    for name, (c, s) in summary["ops"].items():
        if needle in name:
            n += c
            t += s
    return n, t


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(((n, s) for n, (_, s) in summary["ops"].items()), key=lambda x: -x[1])
    gaps = sorted(summary["idle_gaps"].items(), key=lambda x: -x[1])
    return dict(device_ops=[[n[:64], s] for n, s in ops[:top]],
                idle_gaps=[[n, s] for n, s in gaps[:top]])
