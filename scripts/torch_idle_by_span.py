#!/usr/bin/env python3
"""Where the card idles, by the program's own spans, and where the host
waits for it, on a CUDA card.

    python3 scripts/torch_idle_by_span.py [--workload dso640.walk] [--frames 300]
        [--alt-frames 1200] [--sync-frames 100] [--seed 3000000001]
        [--out out/idle_by_span.json]

Drives a benchmark cell's ring (``ldso_bench``: the cell's configuration
and traffic, sync mode, closed loop) past its bootstrap and warm frames,
then ``--alt-frames`` frames with the span recorder
(``ldso_tpu_torch.telemetry``) on for every other frame, so that frames
with it on and off see the same ring and the same host: each frame's
``add_frame`` ms, compared by the median of the frames that built no
keyframe and by the mean of all, beside the cost of one span on and off
(a loop of empty spans) times the spans a frame. Then ``--frames`` frames
with the recorder off, as many with it on under ``torch.profiler`` with
CUDA activity only, and as many under CPU and CUDA activity; each ends in
a synchronize, so they say what each kind of profile costs the host.

The CUDA-only profile is reduced on the recorder's clock: every span's
stamps converted to the Unix clock (``telemetry.to_unix_ns``, the
profiler's), the idle time between device events split among the
innermost spans open during it, and each CUDA runtime call (the host's
side of a launch, a copy, a synchronize) put down to the innermost span
open at its middle. Then ``--sync-frames`` frames more run under
``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing call site
in the port, with its count a frame and the spans open around it. The
summary goes to standard output and, whole, to ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def build(workload: str, seed: int, dev):
    """The cell's system fed past its bootstrap, a marginalized keyframe and
    one keyframe more; returns ``feed()``, which adds the ring's next frame."""
    import numpy as np

    from ldso_bench.harness import cells, scene
    from ldso_tpu_torch.system import FullSystem

    bench = cells.load_benchmark()
    cell = cells.find_cell(bench, workload)
    conf = cells.load_config(bench, cell["config"])
    traffic = cells.load_traffic(cell["traffic"])
    intr = cells.intrinsics(conf)
    poses = scene.walk_poses(traffic["frames_each_way"], traffic["step"],
                             traffic.get("lateral", 0.15), traffic.get("lateral_freq", 0.2))
    ring = scene.render_ring(traffic["texture_seed"], poses, intr, conf["width"],
                             conf["height"], dev)
    start = scene.ring_start(seed, traffic["start_frames"])
    system = FullSystem(cells.port_config(conf), np.asarray(intr, np.float32),
                        conf["width"], conf["height"], device=dev)
    state = dict(i=0)

    def feed():
        i = state["i"]
        state["i"] = i + 1
        return system.add_frame(ring[(start + i) % len(ring)], timestamp=float(i))

    while feed()["status"] != "initialized":
        if state["i"] > 3000:
            raise RuntimeError("the bootstrap did not initialize")
    kf_after = None
    while kf_after is None or system.next_kf_id <= kf_after:
        if feed()["status"] == "lost":
            raise RuntimeError("a warm frame was lost")
        if kf_after is None and any(not k.in_window for k in system.kfs.values()):
            kf_after = system.next_kf_id
    return system, feed


def timed(torch, feed, n: int, system) -> dict:
    kf0 = system.next_kf_id
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        feed()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return dict(ms_a_frame=1e3 * s / n, keyframes=system.next_kf_id - kf0)


def alternating(torch, feed, n: int, system, telemetry) -> dict:
    """``n`` frames, the recorder on for every other one: the median ms of
    the frames that built no keyframe and the mean of all, each way; and
    the ns of an empty span on and off, times the spans a frame."""
    ms = {True: [], False: []}
    plain = {True: [], False: []}
    telemetry.reset()
    torch.cuda.synchronize()
    for i in range(n):
        on = i % 2 == 1
        (telemetry.enable if on else telemetry.disable)()
        kf0 = system.next_kf_id
        t0 = time.perf_counter()
        feed()
        dt = 1e3 * (time.perf_counter() - t0)
        ms[on].append(dt)
        if system.next_kf_id == kf0:
            plain[on].append(dt)
    telemetry.disable()
    torch.cuda.synchronize()
    frames, _ = telemetry.frames()
    per_frame = sum(len(f.spans) for f in frames) / max(len(ms[True]), 1)
    telemetry.reset()

    def empty_span_ns(k=100_000):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with telemetry.span("x"):
                pass
        return (time.perf_counter_ns() - t0) / k

    telemetry.enable()
    ns_on = empty_span_ns()
    telemetry.disable()
    ns_off = empty_span_ns()
    telemetry.reset()
    med = {k: statistics.median(v) for k, v in plain.items()}
    mean = {k: statistics.fmean(v) for k, v in ms.items()}
    return dict(frames=n, plain_frames=[len(plain[False]), len(plain[True])],
                median_plain_ms=[med[False], med[True]], mean_ms=[mean[False], mean[True]],
                span_ns=[ns_off, ns_on], spans_a_frame=per_frame,
                predicted_ms_a_frame=per_frame * (ns_on - ns_off) * 1e-6)


def innermost(spans, starts, t: int):
    """The innermost span (name) open at Unix time ``t``: of the spans that
    hold it, the one that started last (spans of one thread nest)."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        s0, s1, name = spans[j]
        if s1 >= t:
            return name
        if t - s0 > 5_000_000_000:
            break
        j -= 1
    return "no_span"


def segments(spans) -> list:
    """The timeline cut where the innermost open span changes: [(start,
    end, name)], "no_span" between roots; ``spans`` [(start, end, name)]
    sorted by start, nested (one thread's)."""
    out, stack, cur = [], [], spans[0][0] if spans else 0

    def emit(upto, name):
        nonlocal cur
        if upto > cur:
            out.append((cur, upto, name))
            cur = upto

    for s0, s1, name in spans:
        while stack and stack[-1][1] <= s0:
            top = stack.pop()
            emit(top[1], top[2])
        emit(s0, stack[-1][2] if stack else "no_span")
        stack.append((s0, s1, name))
    while stack:
        top = stack.pop()
        emit(top[1], top[2])
    return out


def reduce_cuda_profile(prof, frames, telemetry) -> dict:
    """Idle time between device events, split among the innermost program
    spans open during it, and the host's CUDA runtime calls, each put down
    to the innermost span at its middle."""
    spans = sorted((telemetry.to_unix_ns(s.start_ns), telemetry.to_unix_ns(s.end_ns), s.name)
                   for f in frames for s in f.spans)
    segs = segments(spans)
    seg_ends = [g[1] for g in segs]
    t0, t1 = segs[0][0], segs[-1][1]
    starts = [s[0] for s in spans]
    dev, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                dev.append((s, s + d))
        elif e.name().startswith("cuda"):
            runtime.append((e.name(), s, s + d))
    dev.sort()
    gaps, busy, cur = [], 0, t0
    for s, e in dev:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += max(0, e - max(s, cur))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    idle = collections.Counter()
    for g0, g1 in gaps:
        j = bisect.bisect_right(seg_ends, g0)
        while j < len(segs) and segs[j][0] < g1:
            a, b, name = segs[j]
            idle[name] += min(b, g1) - max(a, g0)
            j += 1
    calls = collections.defaultdict(lambda: [0, 0])
    for name, s, e in runtime:
        if t0 <= s < t1:
            c = calls[(innermost(spans, starts, (s + e) // 2), name)]
            c[0] += 1
            c[1] += e - s
    return dict(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
                idle_s_by_span={k: v * 1e-9 for k, v in idle.most_common()},
                runtime_by_span=sorted(([k[0], k[1], c, t * 1e-9] for k, (c, t) in calls.items()),
                                       key=lambda r: -r[3]))


def sync_sites(torch, feed, n: int, telemetry) -> dict:
    """Every synchronizing call site the port makes in ``n`` frames under
    ``set_sync_debug_mode("warn")``: {file:line: [count, innermost span,
    open spans, the call]}."""
    sites: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = None
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "ldso_tpu_torch" in fr.filename and "telemetry" not in fr.filename:
                site = fr
                break
        key = (f"{os.path.relpath(site.filename, ROOT)}:{site.lineno}" if site
               else f"{filename}:{lineno}")
        open_ = telemetry.open_spans()
        rec = sites.setdefault(key, [0, open_[-1] if open_ else "no_span", "/".join(open_),
                                     site.line if site else str(message)[:80]])
        rec[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                feed()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="dso640.walk")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--alt-frames", type=int, default=1200)
    ap.add_argument("--sync-frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=3000000001)
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "idle_by_span.json"))
    a = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldso_tpu_torch import telemetry

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    system, feed = build(a.workload, a.seed, dev)
    out = dict(workload=a.workload, seed=a.seed, frames=a.frames, card=_card())

    out["alternating"] = alternating(torch, feed, a.alt_frames, system, telemetry)
    out["off"] = timed(torch, feed, a.frames, system)
    telemetry.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out["cuda_profiled"] = timed(torch, feed, a.frames, system)
    frames, dropped = telemetry.frames()
    red = reduce_cuda_profile(prof, [f for f in frames if f.id is not None], telemetry)
    totals = telemetry.totals(frames)
    out["cuda_profile"] = dict(red, dropped=dropped, spans_ms_a_frame={
        k: [v[1] * 1e-6 / a.frames, v[2] * 1e-6 / a.frames] for k, v in totals.items()})
    del prof
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["cpu_cuda_profiled"] = timed(torch, feed, a.frames, system)
    telemetry.reset()
    out["sync_sites"] = sync_sites(torch, feed, a.sync_frames, telemetry)
    out["sync_frames"] = a.sync_frames
    telemetry.disable()

    alt = out["alternating"]
    print(f"{a.workload}, seed {a.seed}; card {out['card']}")
    print(f"  recorder off / on, every other frame of {alt['frames']}: median of the frames "
          f"without a keyframe ({alt['plain_frames'][0]} / {alt['plain_frames'][1]}) "
          f"{alt['median_plain_ms'][0]:.4f} / {alt['median_plain_ms'][1]:.4f} ms, mean of all "
          f"{alt['mean_ms'][0]:.4f} / {alt['mean_ms'][1]:.4f} ms; an empty span "
          f"{alt['span_ns'][0]:.0f} / {alt['span_ns'][1]:.0f} ns x {alt['spans_a_frame']:.2f} "
          f"spans a frame = {alt['predicted_ms_a_frame']:.4f} ms a frame")
    for m in ("off", "cuda_profiled", "cpu_cuda_profiled"):
        print(f"  {m}: {out[m]['ms_a_frame']:.3f} ms a frame over {a.frames}, "
              f"{out[m]['keyframes']} keyframes")
    cp = out["cuda_profile"]
    print(f"CUDA-only profile: {cp['window_s']:.3f} s, device busy {cp['busy_s']:.4f} s "
          f"({100 * cp['busy_s'] / cp['window_s']:.2f}%), dropped frames {cp['dropped']}")
    print("  idle s by innermost span: " + ", ".join(
        f"{k} {v:.4f}" for k, v in cp["idle_s_by_span"].items()))
    print("  spans, ms a frame (total / self): " + ", ".join(
        f"{k} {t:.3f}/{s_:.3f}" for k, (t, s_) in sorted(
            cp["spans_ms_a_frame"].items(), key=lambda kv: -kv[1][0])))
    print("  CUDA runtime calls by span (span, call, count, s), top 25:")
    for row in cp["runtime_by_span"][:25]:
        print(f"    {row[0]:>14} {row[1]:<28} {row[2]:>7} {row[3]:.4f}")
    print(f"synchronizing call sites over {a.sync_frames} frames (count, innermost span, site, "
          "open spans, call):")
    for k, (n, inner, open_, line) in sorted(out["sync_sites"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {n:>6} {inner:>14} {k}  [{open_}]  {line}")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
