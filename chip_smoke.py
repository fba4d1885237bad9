#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ldso_tpu_torch``) once on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one result line each (any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch/CUDA versions and the
     float32 precision flags;
  2. build: compile every kernel of the main path from ``ldso_tpu_torch/csrc``;
  3. kernel vs plain: the pyramid kernel against ``build_pyramid_torch``
     on a rendered bench frame (uint8) and a random float32 image, both
     640x480 at 5 levels, with CUDA-event timings of both;
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
     graph and keep ATE <= 6% of extent.
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
    for img_np, ts, expo in frames:
        t_a = time.perf_counter()
        st = system.add_frame(img_np, ts, expo)
        sync()
        t_frames.append(time.perf_counter() - t_a)
        statuses.append(st["status"])
        n_corner_act += st.get("n_corner_act", 0)
        if st["status"] == "lost":
            raise RuntimeError(f"lost at frame {st['frame_id']}: {st}")
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
                fps=(len(t_frames) - N_WARM) / sum(t_frames[N_WARM:]))


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
               n_tracked=statuses.count("tracked"), ate=_ate_pct(system, ds))
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
    t0 = time.perf_counter()
    lib = pallas_pyramid.build()
    print(f"build: {os.path.relpath(lib, root)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel vs plain, on the card
    ds, frames = _render_bench(N_FRAMES)
    rng = np.random.default_rng(0)
    inputs = {
        "bench_u8": torch.as_tensor(frames[0][0], device=dev),
        "random_f32": torch.as_tensor(rng.random((H, W), np.float32) * 255.0, device=dev),
    }
    max_err = 0.0
    for name, img in inputs.items():
        pyr_k, gsq_k = pallas_pyramid.build_pyramid_cuda(img, LEVELS)
        pyr_p, gsq_p = build_pyramid_torch(img, LEVELS)
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
        max_err = max(max_err, e_pyr, e_gsq)
        print(f"kernel pyramid_level vs plain [{name}]: max|err| pyr {e_pyr:.3g}, "
              f"gsq {e_gsq:.3g} (bounds: atol {PYR_ATOL} / {GSQ_ATOL} + rtol {RTOL}"
              f"·|plain|)", flush=True)
    img = inputs["bench_u8"]
    kernel = lambda: pallas_pyramid.build_pyramid_cuda(img, LEVELS)  # noqa: E731
    plain = lambda: build_pyramid_torch(img, LEVELS)                  # noqa: E731
    # in turns (plain, kernel, kernel, plain), so drift hits both alike
    p1, k1, k2, p2 = (_time_ms(fn) for fn in (plain, kernel, kernel, plain))
    ms_k, ms_p = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    print(f"kernel pyramid_level timing [bench_u8 {W}x{H}, {LEVELS} levels]: "
          f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms | {card}", flush=True)

    # ---- 4. the main path, at the untouched default preset
    from ldso_tpu_torch.config import preset

    t_phase = time.perf_counter()
    pallas_pyramid.reset_launches()
    main = drive_bench(preset("default"), ds, frames, dev, sync=torch.cuda.synchronize)
    launches_main = pallas_pyramid.LAUNCHES
    if launches_main < LEVELS * main["n_tracked"] or main["n_tracked"] == 0:
        raise RuntimeError(f"pyramid kernel launched {launches_main} times for "
                           f"{main['n_tracked']} tracked frames x {LEVELS} levels")
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
    lds, lframes = _render_bench(LOOP_FRAMES, LOOP_W, LOOP_H, seed=5,
                                 traj_kind="out_and_back")
    pallas_pyramid.reset_launches()
    loop = drive_loop_pair(preset("default"), lds, lframes, dev,
                           sync=torch.cuda.synchronize)
    launches_loop = pallas_pyramid.LAUNCHES
    if launches_loop < LEVELS * (loop["off"]["n_tracked"] + loop["on"]["n_tracked"]):
        raise RuntimeError(f"pyramid kernel launched {launches_loop} times in the loop "
                           f"phase")
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

    print(json.dumps({"kernels": [{
        "name": "pyramid_level", "route": "cuda",
        "source": "ldso_tpu_torch/csrc/pyramid.cu",
        "replaces": "ldso_tpu/kernels/pallas_pyramid.py:33",
        "launches": launches_main + launches_loop, "max_abs_err": max_err,
        "ms": ms_k, "plain_ms": ms_p}]}), flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
