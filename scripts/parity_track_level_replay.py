#!/usr/bin/env python3
"""Replay one tracker level, dumped on the card by
``scripts/torch_track_level_compare.py``, through the port's plain version
and the JAX package's ``track_level`` on the CPU.

    python3 scripts/parity_track_level_replay.py DUMP.npz [CAP ...]

For each iteration cap (default: every cap the dump holds) it prints, for
the lane whose (a, b) parts most on the card, (a, b) and rmse of the
kernel and of the plain version as the card computed them, then of the
plain version and of JAX on this CPU, and each one's distance from JAX.
Then it reads where JAX and the port's plain version part on this CPU
with ``chip_smoke._tie_parting`` (JAX standing in for the kernel): the
iteration, which one moved, and that step's relative energy change. It
imports both packages, as a test does, so it is not a ``torch_*``
script.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ldso_tpu import tracker as jtr
    from ldso_tpu_torch import tracker as ttr

    d = np.load(sys.argv[1])
    names = ("img3", "uv", "idepth", "color", "valid", "T0", "ab0", "intr_l")
    args = [d[k] for k in names]
    kw = {k[3:]: d[k].item() for k in d.files if k.startswith("kw_")}
    caps = sorted(int(k.split("_")[-1]) for k in d.files if k.startswith("k_ab_"))
    if len(sys.argv) > 2:
        caps = [int(c) for c in sys.argv[2:]]
    lane = int(np.abs(d[f"k_ab_{caps[-1]}"] - d[f"p_ab_{caps[-1]}"]).max(-1).argmax())
    print(f"{sys.argv[1]}: {args[5].shape[0]} lanes x {args[1].shape[0]} points, "
          f"{kw['w']}x{kw['h']}, lane {lane}", flush=True)
    jargs = [jnp.asarray(a) for a in args]
    for cap in caps:
        kc = dict(kw, iters=cap)
        t = ttr.track_level_torch(*(torch.from_numpy(a) for a in args), **kc)
        w, h, iters = kc.pop("w"), kc.pop("h"), kc.pop("iters")
        cut, hub = kc.pop("cutoff"), kc.pop("huber_th")
        j = jax.vmap(lambda T0, ab0: jtr.track_level(
            *jargs[:5], T0, ab0, jargs[7], w, h, iters, cut, hub, **kc))(jargs[5], jargs[6])
        rows = {"kernel (card)": (d[f"k_ab_{cap}"][lane], d[f"k_rm_{cap}"][lane]),
                "plain (card)": (d[f"p_ab_{cap}"][lane], d[f"p_rm_{cap}"][lane]),
                "plain (CPU)": (t[1][lane].numpy(), t[2][lane].numpy()),
                "JAX (CPU)": (np.asarray(j[1][lane]), np.asarray(j[2][lane]))}
        ab_j = rows["JAX (CPU)"][0]
        print(f"cap {cap}: " + "; ".join(
            f"{k} ab {v[0].tolist()} rmse {float(v[1])!r} |dab| from JAX "
            f"{float(np.abs(v[0] - ab_j).max()):.3g}" for k, v in rows.items()), flush=True)

    import chip_smoke as cs
    from ldso_tpu_torch.kernels import track_level as ktl

    def jax_level(*a, **k):
        w, h, iters, cut, hub = (k.pop(x) for x in ("w", "h", "iters", "cutoff", "huber_th"))
        ja = [jnp.asarray(x.numpy()) for x in a]
        out = jax.vmap(lambda T0, ab0: jtr.track_level(
            *ja[:5], T0, ab0, ja[7], w, h, iters, cut, hub, **k))(ja[5], ja[6])
        return tuple(torch.from_numpy(np.array(x)) for x in out)

    ktl.track_level_cuda = jax_level          # JAX in the kernel's seat, on the CPU
    tie = cs._tie_parting(tuple(torch.from_numpy(a) for a in args), kw, lane)
    print(f"JAX (as 'kernel') and the port's plain version, both on the CPU, part: "
          f"{tie if tie else 'not at a tie, or not at all'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
