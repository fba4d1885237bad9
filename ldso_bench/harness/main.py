"""One run of one cell: set-up, the measured window, the traced slice,
the comparison, the result line.

    python3 ldso_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's ring of frames on the card (the traffic's
fixed textures), builds ``ldso_tpu_torch.FullSystem`` (sync mode, no loop
closing) and feeds the ring from the frame the seed draws until the
bootstrap has initialized, the window of keyframes is full and a keyframe
has been marginalized; then one keyframe more. The window feeds the ring
on, in order and wrapping,
each frame as soon as the previous ``add_frame`` has returned, for
``--seconds``. With ``--trace 1`` the host spans the cell's per-layer
metrics name are on during the window, and ``torch.profiler`` then traces
the traffic's ``profile_frames`` frames more. After the window the
comparison runs (``check.py``) and the last line of standard output is
the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

from ldso_bench.harness import cells, check, devtrace, scene, spans

FORBIDDEN = ("jax", "jaxlib", "flax", "ldso_tpu")
MAX_WARM_FRAMES = 3000


def _host_line(torch) -> str:
    import platform

    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":")[0].strip() in ("model name", "CPU part", "Model"):
                    model += " " + line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    aff = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []
    return (f"host: cpu {model}; cores {os.cpu_count()}; affinity {len(aff)} "
            f"({aff[:4]}...); torch threads {torch.get_num_threads()}; torch "
            f"{torch.__version__} cuda {torch.version.cuda}")


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return "card: " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi unavailable ({e})"


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark); cpu only for the harness's own tests")
    a = ap.parse_args(argv)

    bench = cells.load_benchmark()
    cell = cells.find_cell(bench, a.workload)
    conf = cells.load_config(bench, cell["config"])
    traffic = cells.load_traffic(cell["traffic"])

    import torch

    if a.device == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < int(cell["chips"])):
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(_host_line(torch), file=sys.stderr)
    dev = torch.device("cuda", 0) if a.device == "cuda" else torch.device("cpu")
    res = drive(a, bench, cell, conf, traffic, dev, t_start, torch)
    found = _forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0


def drive(a, bench, cell, conf, traffic, dev, t_start, torch, control: bool = False,
          window_hook=None) -> dict:
    """The run; ``control`` adds the control's readings (the reference in
    bfloat16 in the program's place, ``check.compare``) under "control";
    ``window_hook()`` is called as the window opens (the tests plant their
    faults in the program there)."""
    from ldso_tpu_torch.system import FullSystem

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = cells.port_config(conf)
    w, h = conf["width"], conf["height"]
    intr = cells.intrinsics(conf)
    poses = scene.walk_poses(traffic["frames_each_way"], traffic["step"],
                             traffic.get("lateral", 0.15), traffic.get("lateral_freq", 0.2))
    t_r = time.perf_counter()
    ring = scene.render_ring(traffic["texture_seed"], poses, intr, w, h, dev)
    t_ring = time.perf_counter() - t_r
    R = len(ring)
    start = scene.ring_start(a.seed, traffic["start_frames"])
    system = FullSystem(cfg, np.asarray(intr, np.float32), w, h, device=dev)
    state = dict(i=0)

    def feed():
        i = state["i"]
        state["i"] = i + 1
        return system.add_frame(ring[(start + i) % R], timestamp=float(i), exposure=1.0)

    ck = conf["check"]
    patches = spans.Patches()
    boot = spans.Keep(patches, "ldso_tpu_torch.init2f:init_level", ck["init_levels"],
                      np.random.default_rng([a.seed, 3]))
    boot.on = True
    # bootstrap, then warm frames: the window of keyframes full, a keyframe
    # marginalized, and one keyframe built after that
    t_b = time.perf_counter()
    st = feed()
    while st["status"] not in ("initialized",):
        if state["i"] > MAX_WARM_FRAMES or st["status"] == "init_reset":
            raise RuntimeError(f"the bootstrap did not initialize: {st}")
        st = feed()
    sync()
    bootstrap_s = time.perf_counter() - t_b
    boot.on = False
    kf_after = None
    while True:
        st = feed()
        if st["status"] == "lost":
            raise RuntimeError(f"frame {state['i'] - 1} lost during warm-up")
        if kf_after is None and any(not k.in_window for k in system.kfs.values()):
            kf_after = system.next_kf_id
        if kf_after is not None and system.next_kf_id > kf_after:
            break
        if state["i"] > MAX_WARM_FRAMES:
            raise RuntimeError("no keyframe was marginalized during warm-up")

    per_layer = cells.cell_metrics(bench, cell["name"], "per_layer") if a.trace else []
    end_to_end = cells.cell_metrics(bench, cell["name"], "end_to_end")
    readers = {m["name"]: cells.load_reader(m["name"]) for m in end_to_end + per_layer}
    span = spans.Spans(patches)
    for name in readers:
        for label, targets in getattr(readers[name], "SPANS", {}).items():
            if label not in span.ms:
                for t in targets:
                    span.add(label, t)
    rng = np.random.default_rng([a.seed, 1])
    kfs = ck["keyframes"]
    levels = spans.Last(patches, "ldso_tpu_torch.kernels.track_level:track_levels_cuda")
    keeps = {
        "step": spans.Keep(patches, "ldso_tpu_torch.frame_step:fused_step", ck["steps"], rng,
                           attach=lambda: check.coarse_winner(levels)),
        "activate": spans.Keep(patches, "ldso_tpu_torch.lifecycle:kf_activate", kfs, rng),
        "k4": spans.Keep(patches, "ldso_tpu_torch.ba.solve:assemble", ck["evaluations"], rng),
        "solve": spans.Keep(patches, "ldso_tpu_torch.ba.solve:_solve_core", ck["evaluations"],
                            rng),
        "apply": spans.Keep(patches, "ldso_tpu_torch.ba.solve:apply_step", ck["evaluations"],
                            rng),
        "marg": spans.Keep(patches, "ldso_tpu_torch.ba.marginal:marginalize_points", kfs, rng,
                           when=lambda win, mask, *rest: bool(np.asarray(mask).any())),
        "ba": spans.Keep(patches, "ldso_tpu_torch.ba.solve:run_ba", kfs, rng),
        "margf": spans.Keep(patches, "ldso_tpu_torch.ba.marginal:marginalize_frame", kfs, rng),
        "seed": spans.Keep(patches, "ldso_tpu_torch.system:_seed_program", kfs, rng),
        "patch": spans.Keep(patches, "ldso_tpu_torch.lifecycle:compute_seed_patch", kfs, rng),
        "project": spans.Keep(patches, "ldso_tpu_torch.system:_project_points_to_slot", kfs,
                              rng),
        "tref": spans.Keep(patches, "ldso_tpu_torch.tracker:make_tracker_ref", kfs, rng),
    }
    votes = spans.Record(patches, "ldso_tpu_torch.system:FullSystem._process_tracked",
                         check.kf_vote)
    captures = {}
    for name in readers:
        for key, target in getattr(readers[name], "CAPTURE", {}).items():
            if key not in captures:
                captures[key] = spans.Keep(patches, target, traffic["profile_keep"], rng)

    # the measured window
    if window_hook is not None:
        window_hook()
    span.reset()
    for k in keeps.values():
        k.on = True
    votes.on = True
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    fid0, kf0 = state["i"], system.next_kf_id
    print(f"setup: {setup_s:.3f} s = imports and CUDA start {t_r - t_start:.3f}, ring "
          f"{t_ring:.3f} ({R} frames), bootstrap {bootstrap_s:.3f} ({len(system.frames)} "
          f"frames fed then), warm frames to {fid0} ({time.perf_counter() - t_b - bootstrap_s:.3f})",
          file=sys.stderr)
    add_ms, lost = [], 0
    t0 = time.perf_counter()
    while True:
        ta = time.perf_counter()
        st = feed()
        add_ms.append(1e3 * (time.perf_counter() - ta))
        lost += st["status"] == "lost"
        if ta - t0 >= a.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    fid1, kf1 = state["i"], system.next_kf_id
    for k in keeps.values():
        k.on = False
    votes.on = False
    ends = np.cumsum(add_ms) * 1e-3
    bins = [int(((ends >= lo) & (ends < lo + 5.0)).sum()) / 5.0 for lo in np.arange(0, ends[-1] - 2.5, 5.0)]
    print(f"window frames/s by 5 s: {bins}", file=sys.stderr)
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    spans_ms = {k: list(v) for k, v in span.ms.items()}

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, window_frames=fid1 - fid0,
        keyframes=kf1 - kf0, add_frame_ms=add_ms, spans=spans_ms, bootstrap_s=bootstrap_s,
        trace=None, slice_frames=0, kept={}, cfg=cfg, w=w, h=h)
    device_info = dict(platform="gpu" if cuda else "cpu",
                       kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                       count=1, memory_peak_bytes=mem_peak)
    breakdown = None
    if a.trace and cuda:
        ctx.trace, ctx.slice_frames, ctx.kept = _traced_slice(
            torch, feed, span, captures, traffic["profile_frames"])
        device_info["busy_s"] = ctx.trace["busy_s"]
        device_info["window_s"] = ctx.trace["window_s"]
        breakdown = devtrace.breakdown(ctx.trace)
    patches.restore()

    metrics = {}
    for m in (per_layer if a.trace else end_to_end):
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])

    # the comparison, once the program's state is freed
    ate = _window_ate(system, poses, start, fid0, fid1)
    kept = {k: v.kept for k, v in keeps.items()}
    kept["init"] = boot.kept
    del system, ctx, captures, readers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(kept)
    numbers.update(lost_frames=float(lost), ate_pct=ate,
                   kf_decisions_parted=check.decisions_parted(votes.rows))
    limits = conf["limits"]
    # a number whose calls the window never made has no reading: not correct
    checks = {k: dict(value=numbers.get(k), limit=float(v)) for k, v in sorted(limits.items())}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    print("not compared: " + ", ".join(f"{k} {v!r}" for k, v in sorted(numbers.items())
                                       if k not in limits), file=sys.stderr)
    print(_card_line(), file=sys.stderr)
    print(f"window: {fid1 - fid0} frames, {kf1 - kf0} keyframes, {window_s:.3f} s, "
          f"kf_per_100_frames {100.0 * (kf1 - kf0) / max(fid1 - fid0, 1):.3f}, ring start "
          f"{start}; "
          f"kept {[(k, len(v)) for k, v in kept.items()]}", file=sys.stderr)
    out = dict(correct=bool(correct), attempted=fid1 - fid0, failed=int(lost),
               metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["control"] = check.compare(kept, control=True)
    # the numbers compared, each beside its limit, come last
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return out


def _traced_slice(torch, feed, span, captures, n_frames: int):
    """``n_frames`` more frames under ``torch.profiler`` (host labels of the
    spans, ``add_frame`` around each call, ``slice`` around them all),
    with the metrics' captures on. Returns (device summary, frames, kept)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    span.profiling = True
    for k in captures.values():
        k.on = True
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("slice"):
            for _ in range(n_frames):
                with record_function("add_frame"):
                    feed()
            torch.cuda.synchronize()
    span.profiling = False
    for k in captures.values():
        k.on = False
    _, labels = devtrace.events(prof)
    sl = [(s, e) for n, s, e in labels if n == "slice"]
    t0_ns, t1_ns = sl[0]
    summary = devtrace.reduce(prof, t0_ns, t1_ns, tuple(span.ms) + ("add_frame",))
    return summary, n_frames, captures


def _window_ate(system, poses_wc: np.ndarray, start: int, fid0: int, fid1: int) -> float:
    """ATE (% of extent) of the window's tracked frames against the ring's
    ground truth, the largest over its passes of one ring each: each
    frame's pose composed onto its keyframe's latest."""
    est, gt = [], []
    for fr in system.frames:
        if fid0 <= fr.frame_id < fid1 and fr.ref_kf in system.kfs:
            T = fr.T_from_ref @ system.kfs[fr.ref_kf].T_cw
            est.append(-(T[:3, :3].T @ T[:3, 3]))
            gt.append(poses_wc[(start + fr.frame_id) % len(poses_wc)][:3, 3])
    if len(est) < 3:
        return float("inf")
    return check.segment_ate_pct(np.asarray(est), np.asarray(gt), len(poses_wc))
