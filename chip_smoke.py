#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ldso_tpu_torch``) once on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one result line each (any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch/CUDA versions and the
     float32 precision flags;
  2. build: compile every kernel of the main path from ``ldso_tpu_torch/csrc``
     and, beside it, the native image loader ``ldso_tpu_torch/native/loader.cc``
     (host C++; if it cannot be built the reason is printed and the Python
     decoders serve phase 7); meanwhile a pool of worker processes, one
     per CPU core up to 8, renders the bench and loop sequences and phase
     7's dataset in chunks of frames, and the dataset is written to a
     temporary directory (``scripts/torch_tum_fixture.py``);
  3. kernel vs plain: the one-launch pyramid kernel against
     ``build_pyramid_torch`` at every shape the drives below give it
     (640x480 at B = 1 and at the batch of phase 6 (b), 320x240 loop
     frames at B = 1, an undistorted float32 640x480 frame of phase 7's
     reader at B = 1), at B = 8 and at the partial-tile size 208x176, on
     rendered frames (uint8) and random float32 images, at 5 levels; then
     CUDA-event timings at 640x480 uint8: the
     kernel's device time at B = 1 and B = 8 (launches queued behind a
     spin kernel, so the host's launch rate does not pace them), the time
     of a whole call of the wrapper, the plain version, and the bytes
     bound computed from the shapes;
  4. main path: sync ``FullSystem`` at the untouched ``preset("default")``
     (corner-biased seeding on) over the 120-frame bench sequence (seed 3,
     corridor, forward_arc, 640x480, uint8), checked against the
     ground-truth trajectory (ATE <= 6% of extent) and for corner-seeded
     activations;
  5. loop closure: the loop sequence of the JAX package's
     ``bench.py::bench_loop_closure`` (``preset("default")``, 320x240, 240
     frames, seed 5, out_and_back, uint8) driven twice, loop closure off
     and then on (a synchronous ``LoopClosing(train_after=4)`` attached
     through ``on_keyframe`` / ``loop_closing``), then relocalization on a
     revisited view. The loop-on drive must close >= 1 loop, run the pose
     graph and keep ATE <= 6% of extent;
  6. async modes, each on a fresh ``FullSystem`` at ``preset("default")``,
     fed free-running and ended by ``finish_mapping()`` and ``shutdown()``:
     (a) ``async_mapping=True`` over the first 80 frames of the 640x480
     bench sequence (cut from 120 to keep the script near ten minutes: the
     mapping thread also runs in (b) and the per-frame async path in (c),
     both at full length); (b) ``async_mapping=True, pipeline_depth=8,
     batch_size=4`` over all 120 ((b) drops the last frame if the tracked
     frames would otherwise be a multiple of 4, so that the tail flush of
     fewer than 4 frames runs);
     (c) ``async_mapping=True`` with an ``AsyncLoopClosing(train_after=4)``
     over the loop sequence. Each must lose no frame, export a pose per
     frame, build >= 3 keyframes with >= 1 marginalized, keep ATE <=
     max(1.5 x the sync ATE of the same sequence in this run, 6%), leave no
     worker thread alive, and launch the pyramid kernel exactly as often
     as expected (once per frame; in (b) once per bootstrap frame, per
     full batch and per tail frame); (c) must close >= 1 loop and run the
     pose graph. Frames/s (host clock, whole drive with its drain) and the
     submit-to-pose latency are printed beside the sync drive's;
  7. dataset path: 120 frames of the bench sequence written to disk in the
     TUM-monoVO layout (640x480 PNGs in a zip, through an FOV lens with
     omega 0.5, a gamma 2.2 response, a radial vignette and per-frame
     exposures; ``camera.txt`` in crop mode), then
     (a) ``ldso_tpu_torch.cli.main(["run", "--dataset", "tum", ...])``
     in-process at ``--preset default`` with the default flags (sync, loop
     closing attached), writing a trajectory, a metrics file and the viz
     dumps: return code 0, no frame lost, >= 110 finite poses read back
     from the trajectory file, ATE against the renderer's ground truth <=
     6% of extent, one metrics line per tracked frame (frame ids
     consecutive from the end of the bootstrap to the last frame), a PLY
     with > 0 points, one pyramid launch per frame fed;
     (b) resume through the Python API: run A takes frames 0..119 with
     ``save_checkpoint`` after frame 59, run B is ``load_checkpoint`` on the
     card and frames 60..119; the positions of the two trajectories must
     agree to 1e-3 (the bound of tests/test_system.py::TestCheckpointResume);
     printed beside them: the decoder that served the frames, decode ms,
     device ms of response + vignette + remap, whole ``get_image`` ms,
     checkpoint bytes and save / load seconds.
  8. distributed solvers (``ldso_tpu_torch/distributed``, ``graft_entry``):
     the toy window of ``eval/toys.make_synthetic_window`` at
     ``preset("default")`` (10 slots, 2048 points, D = 84), 640x480, 10
     frames, each a one-level pyramid build (K1's one-level branch, also
     held against the plain version in phase 3 at 640x480, 320x240 and
     128x96 on float32), built once here and written through
     ``convert.to_numpy``; then ``distributed_rank`` in (a, c, d, e) 4 gloo
     ranks sharing the card (NCCL refuses two ranks on one device) and (b)
     1 NCCL rank, started with ``spawn`` and held by ``check_distributed``:
     the sharded BA step against the single-process ``_solve_core`` step
     (the JAX package's bounds: x 3e-3, idepth 5e-3, energy 2%), one
     all-reduce of 7,225 floats per step, energy down over 3 steps, a 2x2
     mesh against 1-D; the edge-sharded PGO on a 24-KF test circle and
     the block-halo PGO on the 4096-KF, 40-loop test curve against
     ``optimize_pose_graph``; ``graft_entry.dryrun_multichip``; replicated
     results bitwise equal on every rank. A rank that fails, or has not
     ended within ``DIST_TIMEOUT_S``, fails the phase.
Then a JSON line of per-kernel results, the card line again, and as the
last line ``{"ok": true, "device": {...}}``. There is no CPU path; the CPU
tests (tests/test_torch_distributed.py) run phase 8's rank program at
``preset("tiny")``.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

N_FRAMES = 120
N_WARM = 10                  # frames excluded from the steady-state rate
W, H, LEVELS = 640, 480, 5
# |kernel - plain| <= atol + RTOL·|plain|, the bounds of the JAX package's
# Pallas-vs-XLA pyramid check (tests/test_frontend.py): the 2x2 means are
# summed in another order, and a one-ulp difference in a level's
# intensity moves gsq (up to ~1.6e4 on 8-bit images) by more than 1e-3
PYR_ATOL, GSQ_ATOL, RTOL = 1e-4, 1e-3, 1e-6
ATE_MAX_PCT = 6.0            # the repo's ATE qualification floor (README)
# the JAX package's own accuracy on the same sequences, measured on a TPU
# (BENCH_r05.json): sync bench ATE, and the loop pair off -> on
REF_SYNC_ATE, REF_LOOP_OFF_ATE, REF_LOOP_ON_ATE = 1.93, 3.09, 2.80
LOOP_FRAMES, LOOP_W, LOOP_H = 240, 320, 240
PART_W, PART_H = 208, 176    # not a multiple of the kernel's 64x32 tile; 13 wide at level 4
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores, data sheet
SPIN_CYCLES = 20_000_000     # ~10 ms: holds the stream while the host queues the launches
BATCH = 4
N_ASYNC_A = 80               # frames of phase 6 (a)
TUM_OMEGA = 0.5              # FOV lens of phase 7's dataset
N_RESUME = 60                # phase 7 (b): the checkpoint is taken after frame 59
RESUME_ATOL = 1e-3           # tests/test_system.py::TestCheckpointResume's bound
MIN_POSES = 110              # of 120, in the trajectory file of phase 7 (a)
DIST_RANKS = 4               # phase 8: gloo ranks sharing the one card
DIST_FRAMES = 10             # phase 8's toy window: 640x480, one per slot of the default preset
DIST_TIMEOUT_S = 300.0       # a phase-8 rank run that has not ended by then fails
# phase 8's problems, of the JAX package's tests (tests/test_distributed.py):
# a circle (seed, LM, CG), the one of its recovery test, on which the energy
# and S are held to the single process too; the 4096-KF, 40-loop curve
# (K, loops, LM, CG)
DIST_SPEC = dict(preset="default", ba_steps=3, circle=[(3, 15, 80)],
                 curve=(4096, 40, 6, 40), dryrun=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20, inner: int = 20) -> float:
    """Median per-call device time (CUDA events) after warm-up."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _device_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Median device time per call: ``n`` calls are queued behind a spin
    kernel that holds the stream, so they run back to back on the card
    however slowly the host launches them."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def pyramid_bound_ms(b: int, h: int, w: int, levels: int, in_bytes: int) -> tuple:
    """The least time the card could take for one pyramid build: the
    larger of its bytes (the frame read once; 12 B of stack and 4 B of gsq
    written per pixel of every level) over the memory rate and its
    operations (per pixel 2 subtractions, 2 halvings, 2 products and a
    sum, and 4 operations per pooled pixel) over the float32 rate."""
    px = sum((h >> l) * (w >> l) for l in range(levels))
    t_bytes = b * (h * w * in_bytes + 16 * px) / HBM_BYTES_PER_S
    t_ops = b * (7 * px + 4 * (px - h * w)) / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_pyramid(name: str, img, levels: int = LEVELS) -> tuple:
    """Hold one launch of the pyramid kernel against the plain version on
    ``img`` ([H, W] or [B, H, W], uint8 or float32, on the card): shapes,
    |kernel - plain| <= atol + RTOL·|plain|, and exactly one launch.
    Returns (max|err| of the stacks, max|err| of gsq)."""
    import torch

    from ldso_tpu_torch.kernels import pallas_pyramid
    from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

    n0 = pallas_pyramid.LAUNCHES
    pyr_k, gsq_k = pallas_pyramid.build_pyramid_cuda(img, levels)
    if pallas_pyramid.LAUNCHES != n0 + 1:
        raise RuntimeError(f"one pyramid build must be one launch, counted "
                           f"{pallas_pyramid.LAUNCHES - n0} on {name}")
    pyr_p, gsq_p = build_pyramid_torch(img, levels)
    torch.cuda.synchronize()
    if any(a.shape != b.shape for a, b in zip(pyr_k + gsq_k, pyr_p + gsq_p)):
        raise RuntimeError(f"pyramid kernel output shapes differ on {name}")
    e_pyr = max(float((a - b).abs().max()) for a, b in zip(pyr_k, pyr_p))
    e_gsq = max(float((a - b).abs().max()) for a, b in zip(gsq_k, gsq_p))
    ok = all(bool(((a - b).abs() <= atol + RTOL * b.abs()).all())
             for outs_k, outs_p, atol in ((pyr_k, pyr_p, PYR_ATOL),
                                          (gsq_k, gsq_p, GSQ_ATOL))
             for a, b in zip(outs_k, outs_p))
    if not ok:
        raise RuntimeError(f"pyramid kernel disagrees on {name}: max|err| pyr "
                           f"{e_pyr} gsq {e_gsq} (atol {PYR_ATOL} / {GSQ_ATOL}, "
                           f"rtol {RTOL})")
    print(f"kernel pyramid vs plain [{name}]: max|err| pyr {e_pyr:.3g}, "
          f"gsq {e_gsq:.3g} (bounds: atol {PYR_ATOL} / {GSQ_ATOL} + rtol {RTOL}"
          f"·|plain|)", flush=True)
    return e_pyr, e_gsq


def _sequence(n: int, w: int, h: int, seed: int, traj_kind: str):
    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    return SyntheticDataset(w=w, h=h, n=n, seed=seed, scene_kind="corridor",
                            traj_kind=traj_kind, supersample=1, cache=False)


def _render_frames(n: int, w: int, h: int, seed: int, traj_kind: str, lo: int,
                   hi: int) -> list:
    """Frames lo..hi-1 of an n-frame sequence, as (uint8 image, ts, exposure)."""
    import numpy as np

    ds = _sequence(n, w, h, seed, traj_kind)
    frames = []
    for i in range(lo, hi):
        img, ts, expo = ds.get_image(i)
        frames.append((np.clip(np.round(img), 0, 255).astype(np.uint8), ts, expo))
    return frames


def _render_bench(n: int, w: int = W, h: int = H, seed: int = 3,
                  traj_kind: str = "forward_arc", pool=None):
    """A sequence as bench.py::_render_frames renders it: corridor,
    supersample 1, uint8 (default: the 640x480 bench sequence, seed 3,
    forward_arc). With an executor ``pool``, chunks of 30 frames are
    rendered on its workers. Returns (dataset, frames)."""
    if pool is None:
        frames = _render_frames(n, w, h, seed, traj_kind, 0, n)
    else:
        parts = [pool.submit(_render_frames, n, w, h, seed, traj_kind, lo, min(lo + 30, n))
                 for lo in range(0, n, 30)]
        frames = [f for p in parts for f in p.result()]
    return _sequence(n, w, h, seed, traj_kind), frames


def _ate_pct(system, ds) -> float:
    import numpy as np

    from ldso_tpu_torch.eval.ate import ate_rmse

    _, poses = system.export_trajectory()
    if not np.isfinite(poses).all():
        raise RuntimeError("non-finite poses in the exported trajectory")
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt = [ds.gt_pose_c_w(i) for i in ids]
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    return 100.0 * rmse / float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))


def drive_bench(cfg, ds, frames, dev, sync) -> dict:
    """Phase 4: sync FullSystem over ``frames``; fails on a lost frame, no
    initialization, no marginalization, no corner-seeded activation or
    ATE above the floor."""
    from ldso_tpu_torch.system import FullSystem

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    t_frames, statuses, n_corner_act = [], [], 0
    t0 = time.perf_counter()
    for img_np, ts, expo in frames:
        t_a = time.perf_counter()
        st = system.add_frame(img_np, ts, expo)
        sync()
        t_frames.append(time.perf_counter() - t_a)
        statuses.append(st["status"])
        n_corner_act += st.get("n_corner_act", 0)
        if st["status"] == "lost":
            raise RuntimeError(f"lost at frame {st['frame_id']}: {st}")
    system.finish_mapping()
    system.shutdown()
    fps_all = len(frames) / (time.perf_counter() - t0)
    if not system.initialized or system.is_lost:
        raise RuntimeError(f"not initialized or lost: {statuses}")
    n_marg = sum(1 for k in system.kfs.values() if not k.in_window)
    if n_marg < 1:
        raise RuntimeError("no keyframe left the window: marginalization never ran")
    if cfg.selector.corner_fraction > 0 and n_corner_act < 1:
        raise RuntimeError("no corner-seeded activation: the corner path never ran")
    ate = _ate_pct(system, ds)
    if not ate <= ATE_MAX_PCT:
        raise RuntimeError(f"ATE {ate:.3f}% of extent > {ATE_MAX_PCT}%")
    return dict(ate=ate, n_tracked=statuses.count("tracked"), n_kf=len(system.kfs),
                n_marg=n_marg, n_corner_act=n_corner_act,
                n_init=statuses.index("initialized") + 1,
                fps=(len(t_frames) - N_WARM) / sum(t_frames[N_WARM:]),
                fps_all=fps_all, latency_ms=list(system.frame_latency_ms))


def _pctl(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def drive_async(cfg, ds, frames, dev, sync, ate_sync: float, *, batched: bool = False,
                loop: bool = False) -> dict:
    """Phase 6: one free-running drive of an async mode on a fresh
    FullSystem, ended by finish_mapping() and shutdown(). Fails on a lost
    frame, a missing pose, fewer than 3 keyframes, no marginalization, an
    ATE above max(1.5 x ``ate_sync``, the floor), a worker thread left
    alive, or (``loop``) no closure."""
    import numpy as np

    from ldso_tpu_torch.loop.closing import AsyncLoopClosing
    from ldso_tpu_torch.system import FullSystem

    mode = dict(async_mapping=True)
    if batched:
        mode.update(pipeline_depth=8, batch_size=BATCH)
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev, **mode)
    threads = [system._map_thread]
    lc, n_pgo = None, [0]
    if loop:
        lc = AsyncLoopClosing(cfg, ds.intrinsics(), train_after=4)
        threads.append(lc._thread)
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
        run_pose_graph = lc.run_pose_graph

        def counted_pose_graph(s):
            run_pose_graph(s)
            n_pgo[0] += 1

        lc.run_pose_graph = counted_pose_graph
    n_init, n_fed, n_feed = None, 0, len(frames)
    t0 = time.perf_counter()
    try:
        for img_np, ts, expo in frames:
            if n_fed >= n_feed:
                break
            st = system.add_frame(img_np, ts, expo)
            n_fed += 1
            if st["status"] == "lost":
                raise RuntimeError(f"async drive {mode}: lost at frame {n_fed - 1}: {st}")
            if st["status"] == "initialized":
                n_init = n_fed
                if batched and (len(frames) - n_init) % BATCH == 0:
                    n_feed -= 1        # leave a tail of fewer than BATCH frames
        system.finish_mapping()
        if lc is not None:
            lc.finish()
            lc.finish_retrain()
        sync()
        dt = time.perf_counter() - t0
    finally:
        system.shutdown()
        if lc is not None:
            lc.shutdown()
    if any(t is not None and t.is_alive() for t in threads) \
            or system._map_thread is not None:
        raise RuntimeError(f"async drive {mode}: a worker thread outlived shutdown()")
    if n_init is None or system.is_lost:
        raise RuntimeError(f"async drive {mode}: not initialized or lost")
    n_poses = len(system.export_trajectory()[1])
    if n_poses != n_fed or system._pending or system._fbuf:
        raise RuntimeError(f"async drive {mode}: {n_poses} poses for {n_fed} frames fed")
    n_marg = sum(1 for k in system.kfs.values() if not k.in_window)
    if len(system.kfs) < 3 or n_marg < 1:
        raise RuntimeError(f"async drive {mode}: {len(system.kfs)} keyframes, {n_marg} "
                           f"marginalized")
    ate = _ate_pct(system, ds)
    bound = max(1.5 * ate_sync, ATE_MAX_PCT)
    if not ate <= bound:
        raise RuntimeError(f"async drive {mode}: ATE {ate:.3f}% of extent > {bound:.3f}%")
    n_tracked = n_fed - n_init
    lat = system.frame_latency_ms
    if len(lat) != n_tracked:
        raise RuntimeError(f"async drive {mode}: {len(lat)} latencies for {n_tracked} "
                           f"tracked frames")
    out = dict(ate=ate, bound=bound, n_fed=n_fed, n_init=n_init, n_tracked=n_tracked,
               n_kf=len(system.kfs), n_marg=n_marg, fps_all=n_fed / dt,
               lat_med=statistics.median(lat), lat_p95=_pctl(lat, 0.95),
               kf_suppressed=system.kf_suppressed, kf_shed_events=system.kf_shed_events,
               # one pyramid launch per bootstrap frame, then per frame, or
               # per full batch and per tail frame
               launches_expected=(n_init + n_tracked // BATCH + n_tracked % BATCH
                                  if batched else n_fed),
               n_tail=n_tracked % BATCH if batched else 0)
    if lc is not None:
        if lc.retrain_errors:
            raise RuntimeError(f"vocabulary retrain failed: {lc.retrain_errors}")
        opti = [k.S_cw_opti for k in system.kfs.values() if k.S_cw_opti is not None]
        if not all(np.isfinite(S).all() for S in opti):
            raise RuntimeError("non-finite pose-graph output")
        if len(lc.loops_closed) < 1 or n_pgo[0] < 1:
            raise RuntimeError(
                f"async loop drive: {len(lc.loops_closed)} closures, {n_pgo[0]} pose-graph "
                f"runs; rejected "
                f"{dict(collections.Counter(r.get('reason') for r in lc.rejected))}")
        out.update(n_loops=len(lc.loops_closed), n_pgo=n_pgo[0],
                   loops=[(a, b) for a, b, _ in lc.loops_closed])
    return out


def _mode_line(name: str, r: dict) -> str:
    extra = (f", {r['n_loops']} closures {r['loops']}, {r['n_pgo']} pose-graph runs"
             if "n_loops" in r else "")
    return (f"  {name}: {r['n_fed']} frames ({r['n_init']} to initialize, {r['n_tracked']} "
            f"tracked, 0 lost), {r['fps_all']:.3f} frames/s, latency median "
            f"{r['lat_med']:.1f} ms p95 {r['lat_p95']:.1f} ms, {r['n_kf']} KFs "
            f"({r['n_marg']} marginalized), kf_suppressed {r['kf_suppressed']}, "
            f"kf_shed_events {r['kf_shed_events']}, ATE {r['ate']:.4f}% (bound "
            f"{r['bound']:.3f}%), pyramid launches {r['launches']} (expected "
            f"{r['launches_expected']}){extra}")


def _drive_loop(cfg, ds, frames, dev, sync, loop_on: bool) -> dict:
    """One drive of the loop sequence, as bench.py::bench_loop_closure
    wires it, with a synchronous LoopClosing when ``loop_on``."""
    import numpy as np

    from ldso_tpu_torch.loop.closing import LoopClosing
    from ldso_tpu_torch.system import FullSystem

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    lc, pgo_s = None, []
    if loop_on:
        lc = LoopClosing(cfg, ds.intrinsics(), train_after=4)
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
        run_pose_graph = lc.run_pose_graph

        def timed_pose_graph(s):          # host time of each pose-graph run
            t = time.perf_counter()
            run_pose_graph(s)
            sync()
            pgo_s.append(time.perf_counter() - t)

        lc.run_pose_graph = timed_pose_graph
    statuses = []
    t0 = time.perf_counter()
    for img_np, ts, expo in frames:
        st = system.add_frame(img_np, ts, expo)
        statuses.append(st["status"])
        if st["status"] == "lost":
            raise RuntimeError(f"loop {'on' if loop_on else 'off'}: lost at frame "
                               f"{st['frame_id']}: {st}")
    sync()
    dt = time.perf_counter() - t0
    out = dict(system=system, lc=lc, n_kf=len(system.kfs), fps=len(frames) / dt,
               n_tracked=statuses.count("tracked"), ate=_ate_pct(system, ds),
               latency_ms=list(system.frame_latency_ms))
    if lc is not None:
        lc.finish_retrain()
        if lc._retrain_thread is not None and lc._retrain_thread.is_alive():
            raise RuntimeError("the vocabulary retrain did not finish")
        if lc.retrain_errors:
            raise RuntimeError(f"vocabulary retrain failed: {lc.retrain_errors}")
        opti = [k.S_cw_opti for k in system.kfs.values() if k.S_cw_opti is not None]
        if not all(np.isfinite(S).all() for S in opti):
            raise RuntimeError("non-finite pose-graph output")
        out.update(n_loops=len(lc.loops_closed), n_pgo=len(pgo_s), pgo_s=sum(pgo_s),
                   loops=[(a, b) for a, b, _ in lc.loops_closed],
                   rejected=dict(collections.Counter(r.get("reason") for r in lc.rejected)))
    return out


def _relocalize_revisit(system, lc, ds, frames, dev) -> dict:
    """tests/test_system.py's relocalization check on a revisited view:
    the frame after the second-to-last keyframe, against its pose."""
    import numpy as np
    import torch

    from ldso_tpu_torch.kernels.pyramid import build_pyramid

    kf = sorted(system.kfs.values(), key=lambda k: k.kf_id)[-2]
    fid = kf.frame_id + 1
    img = torch.as_tensor(frames[fid][0][: system.h, : system.w], device=dev)
    pyr, _ = build_pyramid(img, system.cfg.shapes.pyr_levels)
    rel = lc.relocalize(system, pyr)
    if rel is None or not np.isfinite(rel["T_cw"]).all():
        raise RuntimeError(f"relocalization on frame {fid} returned no pose: {rel}")

    def center(T):
        return -T[:3, :3].T @ T[:3, 3]

    d_est = float(np.linalg.norm(center(rel["T_cw"]) - center(kf.T_cw)))
    d_gt = float(np.linalg.norm(center(ds.gt_pose_c_w(fid))
                                - center(ds.gt_pose_c_w(kf.frame_id))))
    bound = max(4.0 * d_gt, 0.15)
    if not d_est < bound:
        raise RuntimeError(f"relocalized center {d_est:.4f} from its anchor, bound "
                           f"{bound:.4f}")
    return dict(frame=fid, kf_id=rel["kf_id"], n_inliers=rel["n_inliers"],
                d_est=d_est, bound=bound)


def drive_loop_pair(cfg, ds, frames, dev, sync) -> dict:
    """Phase 5: loop off, loop on, then relocalization on a revisit."""
    off = _drive_loop(cfg, ds, frames, dev, sync, loop_on=False)
    on = _drive_loop(cfg, ds, frames, dev, sync, loop_on=True)
    if on["n_loops"] < 1 or on["n_pgo"] < 1:
        raise RuntimeError(f"no loop closed ({on['n_loops']} closures, {on['n_pgo']} "
                           f"pose-graph runs; rejected {on['rejected']})")
    if not on["ate"] <= ATE_MAX_PCT:
        raise RuntimeError(f"loop-on ATE {on['ate']:.3f}% of extent > {ATE_MAX_PCT}%")
    reloc = _relocalize_revisit(on["system"], on["lc"], ds, frames, dev)
    return dict(off=off, on=on, reloc=reloc)


def _ate_pct_file(traj_file: str, ds_gt) -> tuple:
    """(ATE in % of extent, poses) of a TUM trajectory file against the
    renderer's ground truth (frame i has timestamp i·0.05)."""
    import numpy as np

    from ldso_tpu_torch.eval.ate import ate_rmse, read_tum_trajectory

    ts, pos, quat = read_tum_trajectory(traj_file)
    if not (np.isfinite(pos).all() and np.isfinite(quat).all()):
        raise RuntimeError("non-finite poses in the trajectory file")
    gt_c = np.stack([ds_gt.poses_w_c[int(round(t / 0.05))][:3, 3] for t in ts])
    rmse, _ = ate_rmse(pos, gt_c, with_scale=True)
    return 100.0 * rmse / float(np.linalg.norm(gt_c.max(0) - gt_c.min(0))), len(ts)


def drive_cli(root_dir: str, ds_gt, out_dir: str) -> dict:
    """Phase 7 (a): the command line, in-process, on the card at the default
    preset, on the dataset in ``root_dir``; checks its files as the module
    docstring says."""
    import contextlib
    import io

    from ldso_tpu_torch import cli

    traj, metrics, viz = (os.path.join(out_dir, n)
                          for n in ("traj.txt", "metrics.jsonl", "viz"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "--dataset", "tum", "--path", root_dir, "--preset",
                       "default", "--device", "cuda", "--output", traj,
                       "--metrics", metrics, "--viz", viz])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    n_fed = summary["frames"]
    if summary["lost"] or summary["skipped"] or n_fed != ds_gt.num_frames:
        raise RuntimeError(f"the CLI lost or skipped frames: {summary}")
    ate, n_poses = _ate_pct_file(traj, ds_gt)
    if n_poses < MIN_POSES:
        raise RuntimeError(f"only {n_poses} poses in the trajectory file")
    if not ate <= ATE_MAX_PCT:
        raise RuntimeError(f"CLI ATE {ate:.3f}% of extent > {ATE_MAX_PCT}%")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    ids = [r["frame"] for r in rows]
    # a record per tracked frame, none for a bootstrap frame: the ids run
    # from the end of the bootstrap to the last frame without a gap, so no
    # frame after it was lost
    if not rows or ids != list(range(n_fed - len(rows), n_fed)):
        raise RuntimeError(f"{len(rows)} metrics lines for {n_fed} frames fed: {ids}")
    ply = os.path.join(viz, "map.ply")
    with open(ply) as f:
        n_pts = int(next(line for line in f if line.startswith("element vertex")).split()[-1])
    if n_pts <= 0:
        raise RuntimeError("the PLY holds no point")
    return dict(summary=summary, wall=wall, ate=ate, n_poses=n_poses, n_fed=n_fed,
                n_metrics=len(rows), n_bootstrap=n_fed - len(rows), n_pts=n_pts)


def drive_resume(cfg, root_dir: str, out_dir: str, dev, sync) -> dict:
    """Phase 7 (b): read the dataset once, run A over all frames with a
    checkpoint after frame ``N_RESUME - 1``, run B from that checkpoint;
    the two trajectories must agree to RESUME_ATOL."""
    import numpy as np

    from ldso_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from ldso_tpu_torch.io.datasets import TumMonoDataset
    from ldso_tpu_torch.system import FullSystem

    reader = TumMonoDataset(root_dir, device=dev)
    try:
        frames, t_get = [], []
        for i in range(reader.num_frames):
            t = time.perf_counter()
            frames.append(reader.get_image(i))
            sync()
            t_get.append(time.perf_counter() - t)
        intr = reader.intrinsics()
    finally:
        reader.close()
    h, w = frames[0][0].shape

    def feed(system, lo, hi):
        for i in range(lo, hi):
            st = system.add_frame(*frames[i])
            if st["status"] == "lost":
                raise RuntimeError(f"resume drive: lost at frame {i}: {st}")

    path = os.path.join(out_dir, "ckpt")
    a = FullSystem(cfg, intr, w, h, device=dev)
    feed(a, 0, N_RESUME)
    t = time.perf_counter()
    save_checkpoint(a, path)
    t_save = time.perf_counter() - t
    n_bytes = os.path.getsize(path + ".npz") + os.path.getsize(path + ".json")
    feed(a, N_RESUME, len(frames))
    t = time.perf_counter()
    b = load_checkpoint(path, cfg, device=dev)
    sync()
    t_load = time.perf_counter() - t
    if b.device.type != "cuda":
        raise RuntimeError(f"the checkpoint was loaded onto {b.device}")
    feed(b, N_RESUME, len(frames))
    (_, pa), (_, pb) = a.export_trajectory(), b.export_trajectory()
    if len(pa) != len(frames) or len(pb) != len(frames):
        raise RuntimeError(f"resume: {len(pa)} and {len(pb)} poses for {len(frames)} frames")
    if not (np.isfinite(pa).all() and np.isfinite(pb).all()):
        raise RuntimeError("resume: non-finite poses")
    gap = float(np.abs(pa[:, :3, 3] - pb[:, :3, 3]).max())
    if not gap <= RESUME_ATOL:
        raise RuntimeError(f"the resumed run parts from the uninterrupted one: max "
                           f"|position gap| {gap:.3g} > {RESUME_ATOL}")
    return dict(gap=gap, n_frames=len(frames), n_kf=(len(a.kfs), len(b.kfs)),
                t_save=t_save, t_load=t_load, n_bytes=n_bytes,
                get_ms=1e3 * statistics.median(t_get),
                launches_expected=2 * len(frames) - N_RESUME)


def reader_times(root_dir: str, dev, n: int = 20) -> dict:
    """Per-frame host decode time (zip read + PNG decode, on the feed
    thread, no prefetch), device time of response + vignette + remap (CUDA
    events) and the two copies' host time, on the dataset's own frames."""
    import zipfile

    import torch

    from ldso_tpu_torch.io import datasets

    reader = datasets.TumMonoDataset(root_dir, device=dev)
    try:
        with zipfile.ZipFile(os.path.join(root_dir, "images.zip")) as zf:
            blobs = [zf.read(name) for name in reader._names[:n]]
        t = time.perf_counter()
        raws = [datasets.decode_image(b) for b in blobs]
        decode_ms = 1e3 * (time.perf_counter() - t) / len(blobs)
        raw_dev = torch.from_numpy(raws[0]).to(dev)
        device_ms = _time_ms(lambda: reader._undistort(raw_dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for raw in raws:
            torch.from_numpy(raw).to(dev).cpu()
        copy_ms = 1e3 * (time.perf_counter() - t) / len(raws)
    finally:
        reader.close()
    return dict(decode_ms=decode_ms, device_ms=device_ms, copy_ms=copy_ms)


def _timed_ms(fn, sync, reps: int = 20) -> float:
    """Median host-clock ms of ``fn()`` ending in ``sync()``, after one warm-up."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def distributed_rank(out_dir: str, spec: dict) -> None:
    """Phase 8's program, run by every rank of a process group (the parent
    starts the ranks with ``distributed.mesh.spawn_ranks``); writes this
    rank's results to ``out_dir/rank<r>.npz``. ``spec``: ``device``,
    ``preset``, ``window`` (an npz of ``convert.to_numpy``), ``ba_steps``,
    and unless ``ba_only``: ``circle`` [(seed, lm_iters, cg_iters)],
    ``curve`` (K, n_loops, lm_iters, cg_iters) and ``dryrun``.

    (1) The point-sharded BA step on a 1-D mesh, ``ba_steps`` times, each
    under a wrapper that records every all-reduce's size; the all-reduce
    alone; (2) the meshes: the default ``make_mesh_2d()``, one row per
    rank, 3 hosts (ValueError), an all-gather of 10·(rank + 1); the BA step
    on a 2×2 mesh; (3) the edge-sharded PGO on the test circles; (4) the
    block PGO on the curve; (5) ``graft_entry.dryrun_multichip``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ldso_tpu_torch import convert, graft_entry
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.distributed import mesh as dmesh
    from ldso_tpu_torch.distributed import sharded_ba, sharded_pgo
    from ldso_tpu_torch.eval import toys
    from ldso_tpu_torch.kernels import pallas_pyramid

    dev = torch.device(spec["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rank, n = dist.get_rank(), dist.get_world_size()
    cfg = preset(spec["preset"])
    D = cfg.shapes.state_dim
    HM, bM = np.zeros((D, D), np.float32), np.zeros(D, np.float32)
    with np.load(spec["window"]) as z:
        win = convert.from_numpy("window", dict(z), device=dev)
    res = {}
    all_reduce, calls = dist.all_reduce, []

    def counted(step, w):
        """One BA step with every all-reduce's element count recorded."""
        def counting(t, *a, **k):
            calls.append(t.numel())
            return all_reduce(t, *a, **k)

        dist.all_reduce, n0 = counting, len(calls)
        try:
            w, E = step(w, HM, bM, lam=1e-5)
            E = float(E)
        finally:
            dist.all_reduce = all_reduce
        return w, E, calls[n0:]

    # (1) the sharded BA step, 1-D mesh
    mesh1 = sharded_ba.make_mesh()
    shard = sharded_ba.shard_window(win, mesh1)
    step = sharded_ba.make_distributed_ba_step(mesh1, cfg)
    w, E_ba, ms_ba, n_calls = shard, [], [], []
    for i in range(spec["ba_steps"]):
        sync()
        t = time.perf_counter()
        w, E, c = counted(step, w)
        ms_ba.append(1e3 * (time.perf_counter() - t))
        E_ba.append(E)
        n_calls.append(c)
        if i == 0:
            res.update(ba_x=w.x.cpu().numpy(), ba_c=w.c.cpu().numpy(),
                       ba_idepth=w.p_idepth.cpu().numpy())
    payload = torch.zeros(D * D + 2 * D + 1, device=dev)
    res.update(n_local=shard.num_points, ba_E=E_ba, ba_ms=ms_ba,
               ba_n_calls=[len(c) for c in n_calls], ba_call_sizes=sum(n_calls, []),
               allreduce_ms=_timed_ms(lambda: mesh1.psum_(payload), sync))
    if not spec.get("ba_only"):
        # (2) meshes and the 2x2 step
        res["mesh_default"] = dmesh.make_mesh_2d().shape
        res["mesh_rows"] = dmesh.make_mesh_2d(n_hosts=n).shape
        try:
            dmesh.make_mesh_2d(n_hosts=3)
            res["mesh_3_error"] = ""
        except ValueError as e:
            res["mesh_3_error"] = str(e)
        res["gathered"] = mesh1.all_gather(torch.tensor([10.0 * (rank + 1)], device=dev)
                                           ).cpu().numpy()
        mesh2 = dmesh.make_mesh_2d(n_hosts=2)
        step2 = sharded_ba.make_distributed_ba_step(mesh2, cfg)
        w2, E2, c2 = counted(step2, sharded_ba.shard_window(win, mesh2))
        res.update(ba2_x=w2.x.cpu().numpy(), ba2_idepth=w2.p_idepth.cpu().numpy(),
                   ba2_E=E2, ba2_calls=np.asarray(c2))

        # (3) edge-sharded PGO on the test circles
        pmesh = sharded_pgo.make_mesh()
        f32 = dict(dtype=torch.float32, device=dev)

        def circle(seed):
            _, S, ei, ej, S_meas, w_e, fixed = toys.sim3_circle_graph(24, seed)
            return (torch.as_tensor(S, **f32),
                    *sharded_pgo.shard_edges(ei, ej, S_meas.astype(np.float32),
                                             w_e.astype(np.float32), pmesh, device=dev),
                    torch.as_tensor(fixed, device=dev))

        # one LM step of one CG step first: first uses stay out of the timings
        sharded_pgo.make_distributed_pgo(pmesh, lm_iters=1, cg_iters=1)(*circle(0))
        for seed, lm, cg in spec["circle"]:
            args = circle(seed)
            run = sharded_pgo.make_distributed_pgo(pmesh, lm_iters=lm, cg_iters=cg)
            sync()
            t = time.perf_counter()
            out = run(*args)
            res[f"pgo{seed}_E"] = float(out.energy)
            res[f"pgo{seed}_ms"] = 1e3 * (time.perf_counter() - t)
            res[f"pgo{seed}_S"] = out.S.cpu().numpy()

        # (4) block-halo PGO on the curve
        K, n_loops, lm, cg = spec["curve"]
        _, S, ei, ej, S_meas, w_e, fixed = toys.sim3_curve_graph(K, n_loops)
        part = sharded_pgo.partition_pose_graph(K, ei, ej, S_meas, w_e, n)
        Kp = part["Kp"]
        S_p = np.concatenate([S, np.tile(np.eye(4, dtype=S.dtype), (Kp - K, 1, 1))])
        fixed_p = np.concatenate([fixed, np.ones(Kp - K, bool)])
        run_blk = sharded_pgo.make_block_pgo(pmesh, part, lm_iters=lm, cg_iters=cg,
                                             device=dev)
        sync()
        t = time.perf_counter()
        out = run_blk(torch.as_tensor(S_p, **f32), torch.as_tensor(fixed_p, device=dev))
        res.update(block_E=float(out.energy), block_ms=1e3 * (time.perf_counter() - t),
                   block_S=out.S.cpu().numpy(), block_B=part["B"], block_H=part["H"])

        # (5) the dry run, counting this rank's pyramid launches
        if spec["dryrun"]:
            pallas_pyramid.reset_launches()
            t = time.perf_counter()
            e = graft_entry.dryrun_multichip(mesh2, device=dev)
            res.update(dryrun=[e["ba"], e["pgo"], e["block_pgo"]],
                       dryrun_s=time.perf_counter() - t,
                       dryrun_launches=pallas_pyramid.LAUNCHES)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def run_ranks(spec: dict, world: int, backend: str, out_dir: str, timeout_s: float,
              ranks_per_host=None) -> list:
    """Start ``world`` ranks of ``distributed_rank`` on this host; raises
    unless every rank exits 0 and wrote its sentinel; returns each rank's
    results as a dict."""
    import numpy as np

    from ldso_tpu_torch.distributed.mesh import spawn_ranks

    os.makedirs(out_dir, exist_ok=True)
    spawn_ranks(distributed_rank, world, (out_dir, spec), backend=backend,
                out_dir=out_dir, timeout_s=timeout_s, ranks_per_host=ranks_per_host)
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# the JAX package's bounds (tests/test_distributed.py): sharded against the
# single-process step (f32 reduction order, amplified by the solve), 2-D mesh
# against 1-D, edge-sharded PGO against the single process, block PGO quality
BA_X_ATOL, BA_IDEPTH_ATOL, BA_E_RTOL = 3e-3, 5e-3, 0.02
MESH2_X_ATOL, MESH2_IDEPTH_ATOL = 2e-3, 5e-3
PGO_E_RTOL, PGO_E_ATOL, PGO_S_ATOL = 0.05, 1e-8, 2e-3
BLOCK_E_FACTOR, BLOCK_ERR_FACTOR, BLOCK_ERR_ATOL = 1.25, 1.05, 1e-3


def single_process_refs(win, cfg, spec: dict, sync) -> dict:
    """The single-process counterparts on ``win``'s device: the BA step of
    ``_solve_core`` (the window after it, its energy as ``assemble`` reads
    it, host ms) and ``optimize_pose_graph`` on the circles and the curve
    of ``spec`` (float32)."""
    import numpy as np
    import torch

    from ldso_tpu_torch.ba.residuals import assemble
    from ldso_tpu_torch.ba.solve import (_solve_core, apply_step, fix_mask, prior_diag,
                                         scale_vector)
    from ldso_tpu_torch.core.window import state_delta
    from ldso_tpu_torch.eval import toys
    from ldso_tpu_torch.loop.posegraph import optimize_pose_graph

    dev = win.x.device
    F, D = cfg.shapes.max_frames, cfg.shapes.state_dim
    hub, osum = cfg.ba.huber_th, cfg.ba.outlier_th_sum_component
    z = torch.zeros(D, device=dev)
    s_vec = torch.as_tensor(scale_vector(F, cfg.scales), device=dev)
    fixed = torch.as_tensor(fix_mask(F, 0), device=dev)

    def step():
        sys = assemble(win, huber_th=hub, outlier_sum=osum)
        dx, dd = _solve_core(sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d,
                             torch.zeros((D, D), device=dev), z, state_delta(win),
                             prior_diag(win.frame_valid, cfg), s_vec, fixed, z, 1e-5,
                             win.p_valid)
        return apply_step(win, dx, dd)

    w_ref = step()
    refs = dict(win=w_ref, E=float(assemble(w_ref, huber_th=hub, outlier_sum=osum).energy),
                ba_ms=_timed_ms(step, sync, reps=5))
    f32 = dict(dtype=torch.float32, device=dev)
    graphs = [(f"pgo{seed}", toys.sim3_circle_graph(24, seed), lm, cg)
              for seed, lm, cg in spec["circle"]]
    K, n_loops, lm, cg = spec["curve"]
    graphs.append(("block", toys.sim3_curve_graph(K, n_loops), lm, cg))

    def pgo(graph, lm, cg):
        _, S, ei, ej, S_meas, w_e, fixed_v = graph
        return optimize_pose_graph(
            torch.as_tensor(S, **f32), torch.as_tensor(ei, device=dev),
            torch.as_tensor(ej, device=dev), torch.as_tensor(S_meas, **f32),
            torch.as_tensor(w_e, **f32), torch.as_tensor(fixed_v, device=dev),
            lm_iters=lm, cg_iters=cg)

    pgo(graphs[0][1], 1, 1)          # first uses stay out of the timings
    for name, graph, lm, cg in graphs:
        sync()
        t = time.perf_counter()
        out = pgo(graph, lm, cg)
        refs[f"{name}_E"] = float(out.energy)
        refs[f"{name}_ms"] = 1e3 * (time.perf_counter() - t)
        refs[f"{name}_S"] = out.S.cpu().numpy()
        refs[f"{name}_graph"] = graph[:2]
    return refs


def check_distributed(results: list, refs: dict, win, cfg, spec: dict) -> dict:
    """Hold the ranks' results (``distributed_rank``) to the JAX package's
    bounds against the single-process ``refs`` and to each other: raises
    on the first miss; returns the numbers compared."""
    import numpy as np

    from ldso_tpu_torch.ba.residuals import assemble
    from ldso_tpu_torch.eval import toys

    n = len(results)
    D = cfg.shapes.state_dim
    P = win.num_points
    r0 = results[0]

    def fail(msg):
        raise RuntimeError(f"phase 8: {msg}")

    def same_on_all(key):
        if not all(np.array_equal(r[key], r0[key]) for r in results[1:]):
            fail(f"{key} differs between ranks")

    # replicated outputs: bitwise equal on every rank
    for key in ["ba_x", "ba_c", "ba_E"] + (
            [] if "ba2_x" not in r0 else
            ["ba2_x", "ba2_E", "block_E", "gathered", "mesh_default"]
            + [f"pgo{s}_{k}" for s, _, _ in spec["circle"] for k in ("S", "E")]
            + (["dryrun"] if spec["dryrun"] else [])):
        same_on_all(key)
    if any(int(r["n_local"]) != P // n for r in results):
        fail(f"a rank does not hold P/n = {P // n} points")
    # one all-reduce of D²+2D+1 floats per step on the 1-D mesh
    want = D * D + 2 * D + 1
    n_calls, sizes = r0["ba_n_calls"].tolist(), r0["ba_call_sizes"].tolist()
    if n_calls != [1] * spec["ba_steps"] or sizes != [want] * spec["ba_steps"]:
        fail(f"all-reduces per step {n_calls} of {sizes} floats, expected one of {want}")
    E = [float(e) for e in r0["ba_E"]]
    if len(E) > 1 and not E[-1] < E[0]:
        fail(f"energy does not decrease over the steps: {E}")

    def full_idepth(key):
        return np.concatenate([r[key] for r in results])

    x, idepth = r0["ba_x"], full_idepth("ba_idepth")
    w_ref = refs["win"]
    err_x = float(np.abs(x - w_ref.x.cpu().numpy()).max())
    err_id = float(np.abs(idepth - w_ref.p_idepth.cpu().numpy()).max())
    w_out = w_ref._replace(x=w_ref.x.new_tensor(x), c=w_ref.c.new_tensor(r0["ba_c"]),
                           p_idepth=w_ref.p_idepth.new_tensor(idepth))
    e_out = float(assemble(w_out, huber_th=cfg.ba.huber_th,
                           outlier_sum=cfg.ba.outlier_th_sum_component).energy)
    if not (err_x <= BA_X_ATOL and err_id <= BA_IDEPTH_ATOL
            and abs(e_out - refs["E"]) < BA_E_RTOL * refs["E"]):
        fail(f"sharded BA step against the single process: max|dx| {err_x:.3g} (atol "
             f"{BA_X_ATOL}), max|d idepth| {err_id:.3g} (atol {BA_IDEPTH_ATOL}), energy "
             f"{e_out:.6g} against {refs['E']:.6g} (rtol {BA_E_RTOL})")
    out = dict(err_x=err_x, err_idepth=err_id, e_out=e_out, e_ref=refs["E"], E=E,
               allreduce_floats=want)
    if "ba2_x" not in r0:
        return out

    if tuple(r0["mesh_rows"]) != (n, 1) or not str(r0["mesh_3_error"]) and n % 3:
        fail(f"mesh shapes: {r0['mesh_rows']}, 3 hosts: {r0['mesh_3_error']!r}")
    if sorted(r0["gathered"].ravel().tolist()) != [10.0 * (k + 1) for k in range(n)]:
        fail(f"all-gather: {r0['gathered'].ravel().tolist()}")
    if r0["ba2_calls"].tolist() != [want, want]:
        fail(f"2x2 mesh all-reduces {r0['ba2_calls'].tolist()}, expected two of {want}")
    err2_x = float(np.abs(r0["ba2_x"] - x).max())
    err2_id = float(np.abs(full_idepth("ba2_idepth") - idepth).max())
    if not (err2_x <= MESH2_X_ATOL and err2_id <= MESH2_IDEPTH_ATOL):
        fail(f"2x2 mesh against 1-D: max|dx| {err2_x:.3g}, max|d idepth| {err2_id:.3g}")
    out.update(err2_x=err2_x, err2_idepth=err2_id)

    for seed, _, _ in spec["circle"]:
        k = f"pgo{seed}"
        e_d, e_s = float(r0[f"{k}_E"]), refs[f"{k}_E"]
        err_S = float(np.abs(r0[f"{k}_S"] - refs[f"{k}_S"]).max())
        gt, S0 = refs[f"{k}_graph"]
        c_gt = toys.sim3_centers(gt)
        err0 = float(np.linalg.norm(toys.sim3_centers(S0) - c_gt, axis=1).mean())
        err1 = float(np.linalg.norm(toys.sim3_centers(r0[f"{k}_S"]) - c_gt, axis=1).mean())
        if not (abs(e_d - e_s) <= PGO_E_ATOL + PGO_E_RTOL * abs(e_s) and err_S <= PGO_S_ATOL
                and err1 < 0.05 and err1 < 0.2 * err0):
            fail(f"edge-sharded PGO (circle seed {seed}): energy {e_d:.6g} against "
                 f"{e_s:.6g} (atol {PGO_E_ATOL} + rtol {PGO_E_RTOL}), max|dS| {err_S:.3g} "
                 f"(atol {PGO_S_ATOL}), "
                 f"centre error {err1:.4g} from {err0:.4g} (< 0.05 and < 0.2x)")
        out[k] = dict(E=e_d, E_ref=e_s, err_S=err_S, err0=err0, err1=err1)

    B, H = int(r0["block_B"]), int(r0["block_H"])
    K = spec["curve"][0]
    S_blk = np.concatenate([r["block_S"] for r in results])[:K]
    gt, _ = refs["block_graph"]
    c_gt = toys.sim3_centers(gt)
    err_ref = float(np.linalg.norm(toys.sim3_centers(refs["block_S"]) - c_gt, axis=1).mean())
    err_blk = float(np.linalg.norm(toys.sim3_centers(S_blk) - c_gt, axis=1).mean())
    e_blk = float(r0["block_E"])
    if not (H < B // 4 and e_blk < BLOCK_E_FACTOR * refs["block_E"] + 1e-6
            and err_blk < BLOCK_ERR_FACTOR * err_ref + BLOCK_ERR_ATOL):
        fail(f"block PGO at K = {K}: H {H}, B {B}; energy {e_blk:.6g} against "
             f"{refs['block_E']:.6g}; centre error {err_blk:.5g} against {err_ref:.5g}")
    out["block"] = dict(B=B, H=H, E=e_blk, E_ref=refs["block_E"], err=err_blk,
                        err_ref=err_ref)
    if spec["dryrun"]:
        if not np.isfinite(r0["dryrun"]).all():
            fail(f"dry run energies {r0['dryrun'].tolist()}")
        out["dryrun"] = r0["dryrun"].tolist()
    return out


def drive_distributed(dev, work_dir: str) -> dict:
    """Phase 8: the toy window once in this process (640x480, 10 frames,
    ``preset("default")``, one-level pyramids on the card), written through
    ``convert.to_numpy``; the single-process references on the card; then
    (a, c, d, e) 4 gloo ranks on the one card and (b) 1 NCCL rank, each
    held by ``check_distributed``. Any rank's failure raises."""
    import numpy as np
    import torch

    from ldso_tpu_torch import convert
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.eval.toys import make_synthetic_window
    from ldso_tpu_torch.kernels import pallas_pyramid

    sync = torch.cuda.synchronize
    cfg = preset("default")
    t = time.perf_counter()
    n0 = pallas_pyramid.LAUNCHES
    win, _ = make_synthetic_window(cfg, w=W, h=H, n_frames=DIST_FRAMES, device=dev)
    sync()
    launches_toy = pallas_pyramid.LAUNCHES - n0
    if launches_toy != DIST_FRAMES:
        raise RuntimeError(f"the toy window launched the pyramid kernel {launches_toy} "
                           f"times for {DIST_FRAMES} frames")
    t_toy = time.perf_counter() - t
    path = os.path.join(work_dir, "window.npz")
    np.savez(path, **convert.to_numpy(win))
    spec = dict(DIST_SPEC, device="cuda", window=path)
    t = time.perf_counter()
    refs = single_process_refs(win, cfg, spec, sync)
    t_refs = time.perf_counter() - t
    t = time.perf_counter()
    gloo = run_ranks(spec, DIST_RANKS, "gloo", os.path.join(work_dir, "gloo"),
                     timeout_s=DIST_TIMEOUT_S)
    t_gloo = time.perf_counter() - t
    chk = check_distributed(gloo, refs, win, cfg, spec)
    spec1 = dict(spec, ba_only=True)
    t = time.perf_counter()
    nccl = run_ranks(spec1, 1, "nccl", os.path.join(work_dir, "nccl"),
                     timeout_s=DIST_TIMEOUT_S)
    t_nccl = time.perf_counter() - t
    chk1 = check_distributed(nccl, refs, win, cfg, spec1)
    # every rank's dry run builds its 6 toy frames with the kernel, 1 level
    launches = launches_toy + sum(int(r["dryrun_launches"]) for r in gloo)
    if launches != DIST_FRAMES + DIST_RANKS * 6:
        raise RuntimeError(f"pyramid kernel launched {launches} times in phase 8, expected "
                           f"{DIST_FRAMES + DIST_RANKS * 6}")
    return dict(gloo=gloo[0], nccl=nccl[0], refs=refs, chk=chk, chk1=chk1, launches=launches,
                t_toy=t_toy, t_refs=t_refs, t_gloo=t_gloo, t_nccl=t_nccl)


def _dist_lines(d: dict, card: str) -> list:
    """Phase 8's result lines."""
    g, c, refs = d["gloo"], d["chk"], d["refs"]
    ms = ", ".join(f"{x:.2f}" for x in g["ba_ms"])
    blk = c["block"]
    circles = "; ".join(
        f"circle seed {s} ({lm} LM x {cg} CG): {g[f'pgo{s}_ms']:.0f} ms against "
        f"{refs[f'pgo{s}_ms']:.0f} ms single-process, energy {c[f'pgo{s}']['E']:.6g} / "
        f"{c[f'pgo{s}']['E_ref']:.6g}, max|dS| {c[f'pgo{s}']['err_S']:.3g}, centre error "
        f"{c[f'pgo{s}']['err1']:.4g} from {c[f'pgo{s}']['err0']:.4g}"
        for s, lm, cg in DIST_SPEC["circle"])
    K, n_loops, lm, cg = DIST_SPEC["curve"]
    return [
        f"distributed BA: {DIST_RANKS} gloo ranks on cuda:0, preset default, {W}x{H}, "
        f"{DIST_FRAMES} frames, P/{DIST_RANKS} = {int(g['n_local'])} points per rank; one "
        f"all-reduce of {c['allreduce_floats']} floats per step; sharded step {ms} ms "
        f"(host clock, steps 1..{len(g['ba_ms'])}, synchronized), single-process step "
        f"{refs['ba_ms']:.2f} ms, the all-reduce alone {float(g['allreduce_ms']):.3f} ms; "
        f"against the single process max|dx| {c['err_x']:.3g} (atol {BA_X_ATOL}), "
        f"max|d idepth| {c['err_idepth']:.3g} (atol {BA_IDEPTH_ATOL}), energy after the "
        f"step {c['e_out']:.6g} / {c['e_ref']:.6g}; energies over the steps "
        f"{[round(e, 3) for e in c['E']]}; 2x2 mesh against 1-D max|dx| "
        f"{c['err2_x']:.3g}, max|d idepth| {c['err2_idepth']:.3g}; NCCL, 1 rank: steps "
        f"{', '.join(f'{x:.2f}' for x in d['nccl']['ba_ms'])} ms, all-reduce "
        f"{float(d['nccl']['allreduce_ms']):.3f}"
        f" ms, max|dx| {d['chk1']['err_x']:.3g}, max|d idepth| {d['chk1']['err_idepth']:.3g} "
        f"| {card}",
        f"distributed PGO: edge-sharded, {DIST_RANKS} gloo ranks: {circles}; block-halo at K "
        f"= {K} ({n_loops} loops, {lm} LM x {cg} CG): B {blk['B']}, H {blk['H']}, "
        f"{float(g['block_ms']):.0f} ms against {refs['block_ms']:.0f} ms single-process, "
        f"energy {blk['E']:.6g} / {blk['E_ref']:.6g}, centre error {blk['err']:.5g} / "
        f"{blk['err_ref']:.5g} | {card}",
        f"distributed dry run (graft_entry.dryrun_multichip, {DIST_RANKS} ranks, 2x2 mesh): "
        f"energies BA {c['dryrun'][0]:.6g}, PGO {c['dryrun'][1]:.4g}, block PGO "
        f"{c['dryrun'][2]:.4g}, {float(g['dryrun_s']):.1f} s; pyramid launches "
        f"{d['launches']} (1 level); toy window {d['t_toy']:.1f} s, single-process "
        f"references {d['t_refs']:.1f} s, gloo ranks {d['t_gloo']:.1f} s (start to join), "
        f"NCCL rank {d['t_nccl']:.1f} s | {card}",
    ]


def main() -> int:
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ldso_tpu_torch")):
        raise SystemExit("chip_smoke.py: ldso_tpu_torch/ not found next to this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this script drives the port on a CUDA card only")

    # ---- 1. device
    import ldso_tpu_torch  # noqa: F401  (sets the float32 precision flags)
    from ldso_tpu_torch.kernels import pallas_pyramid
    from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

    card = _card_line()
    dev = torch.device("cuda", 0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}",
          flush=True)

    # ---- 2. build; the inputs are rendered in worker processes meanwhile
    import concurrent.futures
    import multiprocessing
    import tempfile

    from ldso_tpu_torch import native
    from ldso_tpu_torch.io import datasets

    sys.path.insert(0, os.path.join(root, "scripts"))
    import torch_tum_fixture

    tmp = tempfile.TemporaryDirectory(prefix="ldso_smoke_")
    t_inputs = time.perf_counter()
    n_workers = min(8, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=n_workers, mp_context=multiprocessing.get_context("spawn")) as renders, \
            concurrent.futures.ThreadPoolExecutor(max_workers=5) as pool:
        # the dataset first: its frames cost the most (rendered larger,
        # warped through the lens, PNG-encoded)
        futures = [
            pool.submit(torch_tum_fixture.make_tum_fixture, os.path.join(tmp.name, "tum"),
                        n=N_FRAMES, w=W, h=H, omega=TUM_OMEGA, seed=3, pool=renders),
            pool.submit(_render_bench, N_FRAMES, pool=renders),
            pool.submit(_render_bench, LOOP_FRAMES, LOOP_W, LOOP_H, seed=5,
                        traj_kind="out_and_back", pool=renders)]
        t0 = time.perf_counter()
        builds = [pool.submit(pallas_pyramid.build), pool.submit(native.available)]
        lib, has_native = (b.result() for b in builds)
        reason = ""
        if not has_native:
            lines = (native.unavailable_reason() or "no reason given").strip().splitlines()
            # the compiler's or linker's own complaint, else the last line
            reason = f" ({next((ln for ln in lines if 'error' in ln), lines[-1]).strip()})"
        print(f"build: {os.path.relpath(lib, root)}; native image loader "
              f"{'built' if has_native else 'NOT built'}{reason}; frames will be decoded by "
              f"'{datasets.active_decoder()}'; {time.perf_counter() - t0:.2f} s", flush=True)
        (tum_root, tum_gt), (ds, frames), (lds, lframes) = (f.result() for f in futures)
    print(f"dataset: {N_FRAMES} frames {W}x{H} in the TUM-monoVO layout (FOV omega "
          f"{TUM_OMEGA}, crop mode), the bench sequence and the loop sequence rendered "
          f"in {n_workers} worker processes beside the build in "
          f"{time.perf_counter() - t_inputs:.1f} s", flush=True)

    # ---- 3. kernel vs plain, on the card
    rng = np.random.default_rng(0)

    def random_f32(b, h, w):
        return torch.as_tensor(rng.random((b, h, w), np.float32) * 255.0, device=dev)

    bench8 = torch.as_tensor(np.stack([f[0] for f in frames[:8]]), device=dev)
    tum_reader = datasets.TumMonoDataset(tum_root, device=dev)
    tum_f32 = torch.as_tensor(tum_reader.get_image(N_FRAMES // 2)[0], device=dev)
    tum_reader.close()
    if tum_f32.dtype != torch.float32 or tuple(tum_f32.shape) != (H, W):
        raise RuntimeError(f"the reader gave {tum_f32.dtype} {tuple(tum_f32.shape)}")
    inputs = {
        "bench_u8 B=1": bench8[0], "bench_u8 B=8": bench8,
        "random_f32 B=1": random_f32(1, H, W)[0], "random_f32 B=8": random_f32(8, H, W),
        # the batch of phase 6 (b), and a loop frame of phases 5 and 6 (c)
        f"bench_u8 B={BATCH}": bench8[:BATCH].contiguous(),
        f"random_f32 B={BATCH}": random_f32(BATCH, H, W),
        f"loop_u8 {LOOP_W}x{LOOP_H} B=1": torch.as_tensor(lframes[LOOP_FRAMES // 2][0],
                                                          device=dev),
        f"random_f32 {LOOP_W}x{LOOP_H} B=1": random_f32(1, LOOP_H, LOOP_W)[0],
        # an undistorted irradiance frame, as phase 7's reader hands it over
        f"tum_f32 {W}x{H} B=1": tum_f32,
        f"bench_u8 {PART_W}x{PART_H} B=1": bench8[0, :PART_H, :PART_W].contiguous(),
        f"bench_u8 {PART_W}x{PART_H} B=8": bench8[:, :PART_H, :PART_W].contiguous(),
        f"random_f32 {PART_W}x{PART_H} B=1": random_f32(1, PART_H, PART_W)[0],
        f"random_f32 {PART_W}x{PART_H} B=8": random_f32(8, PART_H, PART_W),
    }
    max_err = max(max(check_pyramid(name, img)) for name, img in inputs.items())
    # one level on float32, as the toy windows of phase 8 build it: its
    # 640x480 window, the dry run's 320x240 and the 128x96 of graft_entry.entry()
    f32_l1 = random_f32(1, H, W)[0]
    for name, img in ((f"random_f32 {W}x{H} B=1", f32_l1),
                      (f"random_f32 {LOOP_W}x{LOOP_H} B=1", random_f32(1, LOOP_H, LOOP_W)[0]),
                      ("random_f32 128x96 B=1", random_f32(1, 96, 128)[0])):
        max_err = max(max_err, *check_pyramid(f"{name}, 1 level", img, levels=1))
    img1, img8 = inputs["bench_u8 B=1"], inputs["bench_u8 B=8"]
    kernel1 = lambda: pallas_pyramid.build_pyramid_cuda(img1, LEVELS)  # noqa: E731
    kernel8 = lambda: pallas_pyramid.build_pyramid_cuda(img8, LEVELS)  # noqa: E731
    plain = lambda: build_pyramid_torch(img1, LEVELS)                   # noqa: E731
    # in turns (plain, kernel, kernel, plain), so drift hits both alike
    p1, k1, k2, p2 = (_time_ms(fn) for fn in (plain, kernel1, kernel1, plain))
    ms_call, ms_p = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    ms_k1, ms_k8 = _device_ms(kernel1), _device_ms(kernel8)
    ms_f32 = _device_ms(lambda: pallas_pyramid.build_pyramid_cuda(tum_f32, LEVELS))
    ms_l1 = _device_ms(lambda: pallas_pyramid.build_pyramid_cuda(f32_l1, 1))
    plain_l1 = 0.5 * sum(_time_ms(lambda: build_pyramid_torch(f32_l1, 1)) for _ in range(2))
    bound1, bound_by = pyramid_bound_ms(1, H, W, LEVELS, 1)
    bound8, _ = pyramid_bound_ms(8, H, W, LEVELS, 1)
    bound_f32, _ = pyramid_bound_ms(1, H, W, LEVELS, 4)
    bound_l1, bound_by_l1 = pyramid_bound_ms(1, H, W, 1, 4)
    print(f"kernel pyramid timing [bench_u8 {W}x{H}, {LEVELS} levels, one launch]: "
          f"device B=1 {ms_k1:.4f} ms (bound {bound1:.5f} ms by {bound_by}), device B=8 "
          f"{ms_k8:.4f} ms (bound {bound8:.5f} ms), float32 frame B=1 {ms_f32:.4f} ms "
          f"(bound {bound_f32:.5f} ms), whole call B=1 {ms_call:.4f} ms, "
          f"plain B=1 {ms_p:.4f} ms; float32 frame at 1 level (phase 8) device "
          f"{ms_l1:.4f} ms (bound {bound_l1:.5f} ms by {bound_by_l1}), plain {plain_l1:.4f} ms"
          f" | {card}", flush=True)

    # ---- 4. the main path, at the untouched default preset
    from ldso_tpu_torch.config import preset

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    pallas_pyramid.reset_launches()
    main = drive_bench(preset("default"), ds, frames, dev, sync=sync)
    launches_main = pallas_pyramid.LAUNCHES
    # one launch per frame: a bootstrap frame builds one pyramid too
    if launches_main != len(frames) or main["n_tracked"] == 0:
        raise RuntimeError(f"pyramid kernel launched {launches_main} times for "
                           f"{len(frames)} frames ({main['n_tracked']} tracked)")
    print(f"main path: {len(frames)} frames ({main['n_init']} to initialize, "
          f"{main['n_tracked']} tracked, 0 lost), {main['n_kf']} KFs ({main['n_marg']} "
          f"marginalized), {main['n_corner_act']} corner-seeded activations, ATE "
          f"{main['ate']:.4f}% of extent (limit {ATE_MAX_PCT}%; JAX package "
          f"{REF_SYNC_ATE}% on the same frames, BENCH_r05.json), steady-state "
          f"{main['fps']:.3f} frames/s over frames {N_WARM}..{len(frames) - 1} (host "
          f"clock, synchronized per frame), pyramid launches {launches_main}, phase "
          f"wall time {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 5. loop closure on the loop sequence
    t_phase = time.perf_counter()
    pallas_pyramid.reset_launches()
    loop = drive_loop_pair(preset("default"), lds, lframes, dev, sync=sync)
    launches_loop = pallas_pyramid.LAUNCHES
    # two drives of one launch per frame, and the relocalization's pyramid
    if launches_loop != 2 * len(lframes) + 1:
        raise RuntimeError(f"pyramid kernel launched {launches_loop} times in the loop "
                           f"phase, expected {2 * len(lframes) + 1}")
    off, on = loop["off"], loop["on"]
    print(f"loop closure: {LOOP_FRAMES} frames {LOOP_W}x{LOOP_H} out_and_back, 0 lost "
          f"in both drives; ATE loop off {off['ate']:.4f}% -> loop on {on['ate']:.4f}% "
          f"of extent (limit {ATE_MAX_PCT}%; JAX package {REF_LOOP_OFF_ATE}% -> "
          f"{REF_LOOP_ON_ATE}%, BENCH_r05.json); "
          f"{on['n_loops']} closures accepted "
          f"{on['loops']}, rejected {on['rejected']}; {on['n_pgo']} pose-graph runs, "
          f"{on['pgo_s']:.3f} s host time; {off['n_kf']} / {on['n_kf']} KFs; "
          f"{off['fps']:.3f} / {on['fps']:.3f} frames/s (all frames, host clock, "
          f"synchronized per frame); relocalization on frame {loop['reloc']['frame']} "
          f"-> kf {loop['reloc']['kf_id']} with {loop['reloc']['n_inliers']} inliers, "
          f"center offset {loop['reloc']['d_est']:.4f} (bound {loop['reloc']['bound']:.4f}); "
          f"pyramid launches {launches_loop}; phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 6. async modes, free-running
    t_phase = time.perf_counter()
    drives = {}
    for name, kw, seq, ate_sync in (
            (f"(a) async, first {N_ASYNC_A} frames", dict(), (ds, frames[:N_ASYNC_A]),
             main["ate"]),
            (f"(b) async + pipeline_depth 8 + batch {BATCH}", dict(batched=True),
             (ds, frames), main["ate"]),
            ("(c) async + AsyncLoopClosing, loop sequence", dict(loop=True),
             (lds, lframes), on["ate"])):
        pallas_pyramid.reset_launches()
        r = drive_async(preset("default"), *seq, dev, sync, ate_sync, **kw)
        r["launches"] = pallas_pyramid.LAUNCHES
        if r["launches"] != r["launches_expected"]:
            raise RuntimeError(f"{name}: pyramid kernel launched {r['launches']} times, "
                               f"expected {r['launches_expected']}")
        drives[name] = r
    if drives[f"(b) async + pipeline_depth 8 + batch {BATCH}"]["n_tail"] < 1:
        raise RuntimeError("the batched drive left no tail of fewer than a batch")
    launches_async = sum(r["launches"] for r in drives.values())
    print(f"async modes (free-running, host clock over the whole drive with its drain; "
          f"latency = add_frame to pose available) | {card}", flush=True)
    print(f"  sync, bench sequence (phase 4): {len(frames)} frames, "
          f"{main['fps_all']:.3f} frames/s, latency median "
          f"{statistics.median(main['latency_ms']):.1f} ms p95 "
          f"{_pctl(main['latency_ms'], 0.95):.1f} ms, {main['n_kf']} KFs, ATE "
          f"{main['ate']:.4f}%", flush=True)
    print(f"  sync + LoopClosing, loop sequence (phase 5): {len(lframes)} frames, "
          f"{on['fps']:.3f} frames/s, latency median "
          f"{statistics.median(on['latency_ms']):.1f} ms p95 "
          f"{_pctl(on['latency_ms'], 0.95):.1f} ms, {on['n_kf']} KFs, ATE {on['ate']:.4f}%",
          flush=True)
    for name, r in drives.items():
        print(_mode_line(name, r), flush=True)
    print(f"async modes: phase wall time {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)

    # ---- 7. the dataset path: the command line, then checkpoint and resume
    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp.name, "out")
    os.makedirs(out_dir)
    pallas_pyramid.reset_launches()
    cli_run = drive_cli(tum_root, tum_gt, out_dir)
    launches_cli = pallas_pyramid.LAUNCHES
    if launches_cli != cli_run["n_fed"]:
        raise RuntimeError(f"pyramid kernel launched {launches_cli} times for "
                           f"{cli_run['n_fed']} frames fed by the CLI")
    pallas_pyramid.reset_launches()
    resume = drive_resume(preset("default"), tum_root, out_dir, dev, sync)
    launches_resume = pallas_pyramid.LAUNCHES
    if launches_resume != resume["launches_expected"]:
        raise RuntimeError(f"pyramid kernel launched {launches_resume} times in the resume "
                           f"drives, expected {resume['launches_expected']}")
    rt = reader_times(tum_root, dev)
    tmp.cleanup()
    cs = cli_run["summary"]
    print(f"dataset path: CLI over {cli_run['n_fed']} frames {W}x{H} from disk, "
          f"decoder '{datasets.active_decoder()}'{reason}: return 0, 0 lost, "
          f"{cli_run['n_poses']} poses in the trajectory file, ATE {cli_run['ate']:.4f}% of "
          f"extent (limit {ATE_MAX_PCT}%; phase 4 on the undistorted uint8 frames "
          f"{main['ate']:.4f}%), {cs['keyframes']} KFs, {cli_run['n_metrics']} metrics lines "
          f"({cli_run['n_bootstrap']} bootstrap frames write none), PLY {cli_run['n_pts']} "
          f"points, {cs['fps']} frames/s (the CLI's own clock, all frames; phase 4 "
          f"{main['fps_all']:.3f}), whole call {cli_run['wall']:.1f} s, pyramid launches "
          f"{launches_cli} | {card}", flush=True)
    print(f"  reader, per frame: decode {rt['decode_ms']:.3f} ms (host, zip read + PNG, no "
          f"prefetch), response + vignette + remap {rt['device_ms']:.4f} ms (device, CUDA "
          f"events), the two copies {rt['copy_ms']:.3f} ms (host clock), whole get_image "
          f"{resume['get_ms']:.3f} ms (host clock, median, zip prefetch on) | {card}",
          flush=True)
    print(f"  resume: checkpoint after frame {N_RESUME - 1}: {resume['n_bytes']} bytes, save "
          f"{resume['t_save']:.3f} s, load onto the card {resume['t_load']:.3f} s; frames "
          f"{N_RESUME}..{resume['n_frames'] - 1} again from it: max |position gap| to the "
          f"uninterrupted run {resume['gap']:.3g} (bound {RESUME_ATOL}), KFs "
          f"{resume['n_kf'][0]} / {resume['n_kf'][1]}, pyramid launches {launches_resume}; "
          f"phase wall time {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 8. the distributed solvers: ranks on the one card
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ldso_dist_") as work:
        dist_run = drive_distributed(dev, work)
    for line in _dist_lines(dist_run, card):
        print(line, flush=True)
    print(f"distributed solvers: phase wall time {time.perf_counter() - t_phase:.1f} s | "
          f"{card}", flush=True)

    print(f"chip_smoke.py: phases 1-8 in {time.perf_counter() - t_start:.1f} s | {card}",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "pyramid", "route": "cuda",
        "source": "ldso_tpu_torch/csrc/pyramid.cu",
        "replaces": "ldso_tpu/kernels/pallas_pyramid.py:33",
        "launches": (launches_main + launches_loop + launches_async + launches_cli
                     + launches_resume + dist_run["launches"]),
        "max_abs_err": max_err, "ms": ms_k1, "ms_b8": ms_k8, "ms_f32": ms_f32,
        "ms_is": "device", "call_ms": ms_call,
        "plain_ms": ms_p, "bound_ms": bound1, "bound_ms_b8": bound8,
        "bound_ms_f32": bound_f32, "ms_f32_l1": ms_l1, "plain_ms_f32_l1": plain_l1,
        "bound_ms_f32_l1": bound_l1,
        "bound_by": bound_by, "library_ms": None}]}), flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
