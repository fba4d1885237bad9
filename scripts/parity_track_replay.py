#!/usr/bin/env python3
"""Replay one frame's coarse tracking, as ``scripts/torch_async_modes.py
dump=F`` wrote it on a CUDA card, through the port's and the JAX package's
``frame_step._track_core`` on the CPU, and print where each put the frame
beside the card's own result.

    python3 scripts/parity_track_replay.py [--preset NAME] FILE.npz [FILE.npz ...]

Both runs start from the dumped inputs: the frame, the tracker ref, the
prediction pair, the affine seed, the intrinsics and the exposure, at the
preset of the drive that wrote them (``default`` unless ``--preset``). A
line gives, for the card, the port on the CPU and the JAX package on the
CPU: the coarse RMSE, the keyframe score delta, the translation of the
refToNew pose, and its distance from the card's.
Needs both packages (the JAX one on the CPU), as the tests do.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ref_fields(z) -> dict:
    """The dumped ``ref_*`` arrays as TrackerRef fields (per-level tuples)."""
    fields = {}
    for key in z.files:
        if not key.startswith("ref_"):
            continue
        name, _, lvl = key[4:].rpartition("_")
        if name and lvl.isdigit():
            fields.setdefault(name, {})[int(lvl)] = z[key]
        else:
            fields[key[4:]] = z[key]
    return {k: tuple(v[i] for i in sorted(v)) if isinstance(v, dict) else v
            for k, v in fields.items()}


def replay(path: str, preset_name: str = "default") -> str:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp
    import torch

    from ldso_tpu import frame_step as jfs
    from ldso_tpu import tracker as jtracker
    from ldso_tpu.config import preset as jpreset
    from ldso_tpu_torch import convert
    from ldso_tpu_torch import frame_step as tfs
    from ldso_tpu_torch.config import preset

    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
        ref = _ref_fields(z)
    T_i = tfs.DIAG_T
    rows = [("card", d["diag"])]
    t_ref = convert.from_numpy("tracker_ref", ref, device="cpu")
    *_, t_diag = tfs._track_core(
        torch.as_tensor(d["img"]), t_ref, torch.as_tensor(d["T_last"]),
        torch.as_tensor(d["T_prelast"]), torch.as_tensor(d["ab0"]),
        torch.as_tensor(d["intr"]), float(d["exposure"]), preset(preset_name))
    rows.append(("port, CPU", t_diag.numpy()))
    j_ref = jtracker.TrackerRef(**{
        k: tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple) else jnp.asarray(v)
        for k, v in ref.items()})
    *_, j_diag = jfs._track_core(
        jnp.asarray(d["img"]), j_ref, jnp.asarray(d["T_last"], jnp.float32),
        jnp.asarray(d["T_prelast"], jnp.float32), jnp.asarray(d["ab0"], jnp.float32),
        jnp.asarray(d["intr"], jnp.float32), jnp.float32(d["exposure"]), jpreset(preset_name))
    rows.append(("JAX package, CPU", np.asarray(j_diag)))
    t_card = d["diag"][T_i:].reshape(4, 4)[:3, 3]
    out = [os.path.basename(path)]
    for name, diag in rows:
        t = np.asarray(diag[T_i:], np.float64).reshape(4, 4)[:3, 3]
        out.append(f"  {name}: coarse RMSE {float(diag[tfs.DIAG_RMSE0]):.3f}, delta "
                   f"{float(diag[tfs.DIAG_KF_DELTA]):.3f}, translation "
                   f"[{', '.join(f'{x:.5g}' for x in t)}], from the card's "
                   f"{np.linalg.norm(t - t_card):.3g}")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="default")
    p.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    for path in a.files:
        print(replay(path, a.preset), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
