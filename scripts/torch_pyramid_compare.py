#!/usr/bin/env python3
"""Check the port's one-launch pyramid kernel at sizes ``chip_smoke.py``
does not drive, and time it, on a CUDA card.

    python3 scripts/torch_pyramid_compare.py [--parent DIR] [--ptxas]

Builds ``ldso_tpu_torch/csrc/pyramid.cu`` and holds the kernel against the
plain torch version with ``chip_smoke.check_pyramid`` (its bounds, its
one-launch check) at B = 1 and B = 8, uint8 and float32, from 640x480
down to 7x5 and at 1 to 5 levels. Then it times 640x480 and 320x240 with
``chip_smoke``'s two clocks: a whole call of the wrapper, back to back
(what a caller pays; paced by the host), and the device time alone (calls
queued behind a spin kernel), beside ``chip_smoke.pyramid_bound_ms``.
``--parent DIR`` names a checkout of an earlier commit (unpacked with
``git archive``): that commit's kernel is built too, compared bitwise
with this one and timed in turns with it (parent, new, new, parent), which
is how a redesign of the kernel is held against what it replaces. The
five-launch kernel's times in ``PERF.md`` were read this way.
``--ptxas`` prints the compiler's register and shared-memory report. Every
line that carries a time ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_parent(path: str):
    """The parent checkout's kernel wrapper under another module name."""
    src = os.path.join(path, "ldso_tpu_torch", "kernels", "pallas_pyramid.py")
    spec = importlib.util.spec_from_file_location("parent_pallas_pyramid", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from ldso_tpu_torch.kernels import pallas_pyramid as new
    from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

    card = cs._card_line()
    if args.ptxas:
        out = subprocess.run(
            [new._nvcc(), *new.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull, new._SRC],
            capture_output=True, text=True)
        print(out.stdout + out.stderr, flush=True)
        if out.returncode:
            raise SystemExit("nvcc failed")
    new.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def image(b, h, w, dtype):
        a = rng.random((b, h, w), np.float32) * 255.0
        t = torch.as_tensor(a.astype(np.uint8) if dtype == "u8" else a, device=dev)
        return t[0].contiguous() if b == 1 else t

    for (h, w, levels) in ((480, 640, 5), (240, 320, 5), (176, 208, 5), (240, 320, 4),
                           (36, 20, 3), (6, 2, 2), (5, 7, 1)):
        for b in (1, 8):
            for dtype in ("u8", "f32"):
                img = image(b, h, w, dtype)
                cs.check_pyramid(f"{w}x{h} L{levels} B{b} {dtype}", img, levels)

    parent = _load_parent(args.parent) if args.parent else None
    if parent is not None:
        parent.build()
        for dtype in ("u8", "f32"):
            img = image(1, 480, 640, dtype)
            pk, gk = new.build_pyramid_cuda(img, 5)
            po, go = parent.build_pyramid_cuda(img, 5)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(pk + gk, po + go))
            print(f"bitwise equal to the parent's kernel [{dtype} 640x480]: {same}",
                  flush=True)
            if not same:
                raise RuntimeError("this kernel is not bitwise equal to the parent's")

    for (h, w) in ((480, 640), (240, 320)):
        for dtype, nbytes in (("u8", 1), ("f32", 4)):
            i1, i8 = image(1, h, w, dtype), image(8, h, w, dtype)
            k1 = lambda: new.build_pyramid_cuda(i1, 5)          # noqa: E731
            k8 = lambda: new.build_pyramid_cuda(i8, 5)          # noqa: E731
            pl = lambda: build_pyramid_torch(i1, 5)             # noqa: E731
            line = f"time {w}x{h} {dtype} L5, whole call / device:"
            if parent is not None:
                old = lambda: parent.build_pyramid_cuda(i1, 5)  # noqa: E731
                o1, n1, n2, o2 = (cs._time_ms(f) for f in (old, k1, k1, old))
                d1, e1, e2, d2 = (cs._device_ms(f) for f in (old, k1, k1, old))
                line += f" parent B=1 {0.5 * (o1 + o2):.4f} / {0.5 * (d1 + d2):.4f} ms,"
                t1, dev1 = 0.5 * (n1 + n2), 0.5 * (e1 + e2)
            else:
                t1, dev1 = cs._time_ms(k1), cs._device_ms(k1)
            b1, b8 = (cs.pyramid_bound_ms(b, h, w, 5, nbytes)[0] for b in (1, 8))
            print(f"{line} this kernel B=1 {t1:.4f} / {dev1:.4f} ms (bound {b1:.5f}), "
                  f"B=8 {cs._time_ms(k8):.4f} / {cs._device_ms(k8):.4f} ms (bound "
                  f"{b8:.5f}), plain B=1 {cs._time_ms(pl):.4f} ms | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
