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
     decoders serve phase 7); then write phase 7's dataset to a temporary
     directory (``scripts/torch_tum_fixture.py``);
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
Then a JSON line of per-kernel results, the card line again, and as the
last line ``{"ok": true, "device": {...}}``. There is no CPU path.
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


def _render_bench(n: int, w: int = W, h: int = H, seed: int = 3,
                  traj_kind: str = "forward_arc"):
    """A sequence as bench.py::_render_frames renders it: corridor,
    supersample 1, uint8 (default: the 640x480 bench sequence, seed 3,
    forward_arc)."""
    import numpy as np

    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(w=w, h=h, n=n, seed=seed, scene_kind="corridor",
                          traj_kind=traj_kind, supersample=1)
    frames = []
    for i in range(n):
        img, ts, expo = ds.get_image(i)
        frames.append((np.clip(np.round(img), 0, 255).astype(np.uint8), ts, expo))
    return ds, frames


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


def main() -> int:
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

    # ---- 2. build
    import concurrent.futures
    import tempfile

    from ldso_tpu_torch import native
    from ldso_tpu_torch.io import datasets

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
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

    sys.path.insert(0, os.path.join(root, "scripts"))
    import torch_tum_fixture

    tmp = tempfile.TemporaryDirectory(prefix="ldso_smoke_")
    t0 = time.perf_counter()
    tum_root, tum_gt = torch_tum_fixture.make_tum_fixture(
        os.path.join(tmp.name, "tum"), n=N_FRAMES, w=W, h=H, omega=TUM_OMEGA, seed=3)
    print(f"dataset: {N_FRAMES} frames {W}x{H} in the TUM-monoVO layout (FOV omega "
          f"{TUM_OMEGA}, crop mode) written in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernel vs plain, on the card
    ds, frames = _render_bench(N_FRAMES)
    lds, lframes = _render_bench(LOOP_FRAMES, LOOP_W, LOOP_H, seed=5,
                                 traj_kind="out_and_back")
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
    img1, img8 = inputs["bench_u8 B=1"], inputs["bench_u8 B=8"]
    kernel1 = lambda: pallas_pyramid.build_pyramid_cuda(img1, LEVELS)  # noqa: E731
    kernel8 = lambda: pallas_pyramid.build_pyramid_cuda(img8, LEVELS)  # noqa: E731
    plain = lambda: build_pyramid_torch(img1, LEVELS)                   # noqa: E731
    # in turns (plain, kernel, kernel, plain), so drift hits both alike
    p1, k1, k2, p2 = (_time_ms(fn) for fn in (plain, kernel1, kernel1, plain))
    ms_call, ms_p = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    ms_k1, ms_k8 = _device_ms(kernel1), _device_ms(kernel8)
    ms_f32 = _device_ms(lambda: pallas_pyramid.build_pyramid_cuda(tum_f32, LEVELS))
    bound1, bound_by = pyramid_bound_ms(1, H, W, LEVELS, 1)
    bound8, _ = pyramid_bound_ms(8, H, W, LEVELS, 1)
    bound_f32, _ = pyramid_bound_ms(1, H, W, LEVELS, 4)
    print(f"kernel pyramid timing [bench_u8 {W}x{H}, {LEVELS} levels, one launch]: "
          f"device B=1 {ms_k1:.4f} ms (bound {bound1:.5f} ms by {bound_by}), device B=8 "
          f"{ms_k8:.4f} ms (bound {bound8:.5f} ms), float32 frame B=1 {ms_f32:.4f} ms "
          f"(bound {bound_f32:.5f} ms), whole call B=1 {ms_call:.4f} ms, "
          f"plain B=1 {ms_p:.4f} ms | {card}", flush=True)

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
          f"{REF_LOOP_ON_ATE}%, BENCH_r05.json); {on['n_loops']} closures accepted "
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

    print(json.dumps({"kernels": [{
        "name": "pyramid", "route": "cuda",
        "source": "ldso_tpu_torch/csrc/pyramid.cu",
        "replaces": "ldso_tpu/kernels/pallas_pyramid.py:33",
        "launches": (launches_main + launches_loop + launches_async + launches_cli
                     + launches_resume),
        "max_abs_err": max_err, "ms": ms_k1, "ms_b8": ms_k8, "ms_f32": ms_f32,
        "ms_is": "device", "call_ms": ms_call,
        "plain_ms": ms_p, "bound_ms": bound1, "bound_ms_b8": bound8,
        "bound_ms_f32": bound_f32,
        "bound_by": bound_by, "library_ms": None}]}), flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
