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
  4. main path: sync ``FullSystem`` at ``preset("default")`` with
     ``selector.corner_fraction = 0`` over the 120-frame bench sequence
     (seed 3, corridor, forward_arc, 640x480, uint8), checked against
     the ground-truth trajectory (ATE <= 6% of extent).
Then a JSON line of per-kernel results, the card line again, and as the
last line ``{"ok": true, "device": {...}}``. There is no CPU path.
"""

from __future__ import annotations

import dataclasses
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


def _render_bench(n: int):
    """The bench sequence as bench.py renders it: seed 3, corridor,
    forward_arc, 640x480, supersample 1, uint8."""
    import numpy as np

    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    ds = SyntheticDataset(w=W, h=H, n=n, seed=3, scene_kind="corridor",
                          traj_kind="forward_arc", supersample=1)
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

    # ---- 4. the main path
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.system import FullSystem

    base = preset("default")
    cfg = base.replace(selector=dataclasses.replace(base.selector, corner_fraction=0.0))
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    pallas_pyramid.reset_launches()
    t_frames = []
    statuses = []
    for img_np, ts, expo in frames:
        t_a = time.perf_counter()
        st = system.add_frame(img_np, ts, expo)
        torch.cuda.synchronize()
        t_frames.append(time.perf_counter() - t_a)
        statuses.append(st["status"])
        if st["status"] == "lost":
            raise RuntimeError(f"lost at frame {st['frame_id']}: {st}")
    launches = pallas_pyramid.LAUNCHES
    n_tracked = statuses.count("tracked")
    n_kf = len(system.kfs)
    n_marg = sum(1 for k in system.kfs.values() if not k.in_window)
    if not system.initialized or system.is_lost:
        raise RuntimeError(f"not initialized or lost: {statuses}")
    if n_marg < 1:
        raise RuntimeError("no keyframe left the window: marginalization never ran")
    if launches < LEVELS * n_tracked or n_tracked == 0:
        raise RuntimeError(f"pyramid kernel launched {launches} times for "
                           f"{n_tracked} tracked frames x {LEVELS} levels")
    ate = _ate_pct(system, ds)
    if not ate <= ATE_MAX_PCT:
        raise RuntimeError(f"ATE {ate:.3f}% of extent > {ATE_MAX_PCT}%")
    steady = sum(t_frames[N_WARM:])
    fps = (len(t_frames) - N_WARM) / steady
    n_init = statuses.index("initialized") + 1
    print(f"main path: {len(frames)} frames ({n_init} to initialize, {n_tracked} "
          f"tracked, 0 lost), {n_kf} KFs ({n_marg} marginalized), ATE {ate:.4f}% of "
          f"extent (limit {ATE_MAX_PCT}%), steady-state {fps:.3f} frames/s over "
          f"frames {N_WARM}..{len(frames) - 1} (host clock, synchronized per frame), "
          f"pyramid launches {launches} | {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "pyramid_level", "route": "cuda",
        "source": "ldso_tpu_torch/csrc/pyramid.cu",
        "replaces": "ldso_tpu/kernels/pallas_pyramid.py:33",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_k, "plain_ms": ms_p}]}), flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
