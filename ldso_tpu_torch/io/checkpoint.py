"""Checkpoint / resume of the full engine state.

Port of ``ldso_tpu/io/checkpoint.py``. The entire engine state is explicit
data — the Window, the dense marginalization prior HM/bM, the immature
bank, host records (keyframes, frames, pose edges, archived map points) —
so a checkpoint is a single ``.npz`` plus a JSON sidecar, and resume
reconstructs the conductor mid-sequence. Array and key names are the
reference's, and ``Window`` and ``Bank`` have the same fields in both
packages, so a checkpoint written by the JAX package loads here; that
file, next to ``convert.py``, is how state is carried across.

The port carries state that the reference's file has no name for: the
tracker reference as it was built (before the keyframe's marginalization
took points out of the window it was projected from), the prediction pair
that lives on the device, the ref versions that tag the relative-affine
seed and key the stale-vote axis, and the activation ladder. They are
saved under new names (arrays ``port_*``, the JSON key ``port``), which
the reference's loader ignores, and restored exactly, so that a resumed run
repeats the uninterrupted one; for a file without them (one the JAX
package wrote) they are rebuilt to a consistent state instead.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ldso_tpu_torch import convert
from ldso_tpu_torch.core import bank as bank_mod
from ldso_tpu_torch.core import window as win_mod
from ldso_tpu_torch.core.bank import Bank
from ldso_tpu_torch.core.window import Window


def save_checkpoint(system, path: str) -> None:
    """Serialize a FullSystem to `<path>.npz` + `<path>.json`.

    Pending tracking results are read and the mapping backlog is drained
    first (``finish_mapping()``), so the window is at rest; the host
    registries are snapshotted under ``state_lock``, which the loop worker
    takes around its write-backs.

    Not saved, as in the reference: the keyframes' features and the loop
    database, and ``last_idepth_hessian`` (a resumed run forgets its
    places). ``last_rel_ab`` is saved as the seed the next track would
    get: zero when it was measured against a tracker ref that has since
    been replaced (the reference zeroes it at the swap)."""
    system.finish_mapping()
    arrays = {}
    for name, val in system.win._asdict().items():
        arrays[f"win_{name}"] = val.cpu().numpy()
    arrays["HM"] = system.HM
    arrays["bM"] = system.bM
    bank = system.immatures
    for f in Bank._fields:
        arrays[f"imm_{f}"] = getattr(bank, f)
    if system.T_last_cw is not None:
        arrays["T_last_cw"] = system.T_last_cw
    if system.T_prelast_cw is not None:
        arrays["T_prelast_cw"] = system.T_prelast_cw
    seed_ok = system._last_rel_ab_version == system._ref_version
    arrays["last_rel_ab"] = system.last_rel_ab if seed_ok \
        else np.zeros(2, dtype=np.float32)
    with system.state_lock:
        kfs_snap = {k: (v, np.asarray(v.T_cw).copy(),
                        None if v.S_cw_opti is None
                        else np.asarray(v.S_cw_opti).copy())
                    for k, v in system.kfs.items()}
        frames_snap = list(system.frames)
        edges_snap = list(system.pose_edges)
        map_snap = {k: (d["xyz_cam"].copy(), d["color"].copy())
                    for k, d in system.map_points.items()}
    kfs = {
        str(k): dict(kf_id=v.kf_id, frame_id=v.frame_id, timestamp=v.timestamp,
                     slot=v.slot, in_window=v.in_window)
        for k, (v, _, _) in kfs_snap.items()
    }
    for k, (_, T_cw, S_opti) in kfs_snap.items():
        arrays[f"kf_T_{k}"] = T_cw
        if S_opti is not None:
            arrays[f"kf_S_{k}"] = S_opti
    frames = [dict(frame_id=f.frame_id, timestamp=f.timestamp, ref_kf=f.ref_kf,
                   is_kf=f.is_kf) for f in frames_snap]
    for i, f in enumerate(frames_snap):
        arrays[f"fr_T_{i}"] = f.T_from_ref
    edges = [dict(kf_a=e.kf_a, kf_b=e.kf_b, kind=e.kind, scale=e.scale)
             for e in edges_snap]
    for i, e in enumerate(edges_snap):
        arrays[f"edge_T_{i}"] = e.T_ab
    # persistent global map + PGO-optimized Sim3 poses
    for k, (xyz, col) in map_snap.items():
        arrays[f"map_xyz_{k}"] = xyz
        arrays[f"map_col_{k}"] = col

    port = None
    if system.track_ref is not None:
        for name, val in convert.to_numpy(system.track_ref).items():
            if isinstance(val, tuple):
                for lvl, a in enumerate(val):
                    arrays[f"port_ref_{name}_{lvl}"] = a
            else:
                arrays[f"port_ref_{name}"] = val
        arrays["port_T_ref_cw"] = system._T_ref_cw_np
        for name in _DEVICE_CARRIES:
            arrays[f"port{name}"] = getattr(system, name).cpu().numpy()
        port = dict(ref_version=system._ref_version,
                    dispatch_ref_version=system._dispatch_ref_version,
                    next_kf_version=system._next_kf_version,
                    kf_base={str(v): list(b) for v, b in system._kf_base.items()},
                    min_act_dist=system._min_act_dist,
                    n_active=system._n_active_cache)

    meta = dict(
        port=port,
        kfs=kfs, frames=frames, edges=edges,
        slot_kf=[(-1 if s is None else s) for s in system.slot_kf],
        next_kf_id=system.next_kf_id, frame_count=system.frame_count,
        initialized=system.initialized, is_lost=system.is_lost,
        ref_kf=system.ref_kf, first_coarse_rmse=system.first_coarse_rmse,
        w=system.w, h=system.h, intr=[float(x) for x in system.intr],
        has_T_last="T_last_cw" in arrays, has_T_prelast="T_prelast_cw" in arrays,
    )
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


# float32 state that a live system carries on the device
_DEVICE_CARRIES = ("_T_ref_cw_dev", "_T_last_rel", "_T_prelast_rel", "_ab_rel_dev",
                   "_dispatch_T_ref_dev")


def _restore_port_state(system, data, port: dict) -> None:
    """Put back, exactly, what :func:`save_checkpoint` wrote under the
    port's own names."""
    from ldso_tpu_torch.tracker import TrackerRef

    dev = system.device
    levels = system.cfg.shapes.pyr_levels
    ref = {}
    for name in TrackerRef._fields:
        if f"port_ref_{name}" in data:
            ref[name] = data[f"port_ref_{name}"]
        else:
            ref[name] = tuple(data[f"port_ref_{name}_{lvl}"] for lvl in range(levels))
    system.track_ref = convert.from_numpy("tracker_ref", ref, device=dev)
    system._T_ref_cw_np = data["port_T_ref_cw"]
    for name in _DEVICE_CARRIES:
        setattr(system, name, torch.as_tensor(data[f"port{name}"], device=dev))
    system._ref_version = port["ref_version"]
    system._dispatch_ref_version = port["dispatch_ref_version"]
    system._next_kf_version = port["next_kf_version"]
    system._kf_base = {int(v): (int(b[0]), float(b[1])) for v, b in port["kf_base"].items()}
    system._min_act_dist = port["min_act_dist"]
    system._n_active_cache = port["n_active"]


def _check_shapes(data, prefix: str, template, path: str) -> None:
    """Every array of ``template`` that the file holds has its shape."""
    for name in template._fields:
        key = f"{prefix}{name}"
        if key not in data:
            continue
        want = tuple(getattr(template, name).shape)
        got = tuple(data[key].shape)
        if got != want:
            raise ValueError(
                f"{path}.npz: array {key!r} has shape {got}, the configuration "
                f"expects {want} (a checkpoint loads only at the shapes it was "
                f"saved with)")


def load_checkpoint(path: str, cfg, *, device="cuda") -> "FullSystem":
    """Reconstruct a FullSystem on ``device`` from a checkpoint written by
    :func:`save_checkpoint` or by the JAX package's.

    The arrays themselves are checked against ``cfg.shapes`` and the saved
    image size: a mismatch (another ``max_frames``, ``max_points``, ...)
    raises ``ValueError`` naming the array and both shapes.

    The port's own state is restored exactly where the file holds it (see
    the module docstring). Where it does not, it is rebuilt as the
    reference's loader rebuilds its own: the tracker ref from the restored
    window, which sets ``_ref_version``; the prediction pair and the
    dispatch ref from the restored trajectory (``_resync_prediction``); the
    stale-vote motion axis (``_kf_base``, ``_next_kf_version``) restarts at
    the restored ref, which is consistent because no tracking result is in
    flight at a save; the activation ladder starts afresh. In both cases
    the restored ``last_rel_ab`` is tagged with the ref version in force,
    so the first resumed frame is seeded with it.

    A file without the ``port_*`` state (one the JAX package wrote) is not
    expected to resume within the 1e-3 position bound that a port-written
    file meets: at the default preset on an H100, 640x480, checkpoint after
    frame 59 of 120, the rebuilt state left a largest position gap of
    1.4e-2 to the uninterrupted run (4.0e-3 with only the activation
    ladder restored; ``scripts/torch_resume_rebuild.py`` measures both)."""
    from ldso_tpu_torch.system import FrameRecord, FullSystem, KeyframeRecord, PoseEdge

    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as npz:
        data = {k: npz[k] for k in npz.files}

    w, h = int(meta["w"]), int(meta["h"])
    _check_shapes(data, "win_", win_mod.empty_window(cfg, h, w, np.zeros(4, np.float32),
                                                     "cpu"), path)
    _check_shapes(data, "imm_", bank_mod.empty_bank(cfg.shapes.max_immature, "cpu"), path)
    D = cfg.shapes.state_dim
    for key, want in (("HM", (D, D)), ("bM", (D,))):
        if tuple(data[key].shape) != want:
            raise ValueError(f"{path}.npz: array {key!r} has shape "
                             f"{tuple(data[key].shape)}, the configuration expects {want}")

    system = FullSystem(cfg, np.asarray(meta["intr"], np.float32), w, h,
                        device=device)
    dev = system.device
    system.win = Window(**{
        name: torch.as_tensor(data[f"win_{name}"], device=dev).to(tmpl.dtype)
        for name, tmpl in system.win._asdict().items()})
    system.HM = data["HM"]
    system.bM = data["bM"]
    bank = system.immatures     # host snapshot of the device bank
    # older checkpoints may miss new fields
    bank = bank._replace(**{fld: data[f"imm_{fld}"] for fld in Bank._fields
                            if f"imm_{fld}" in data})
    system.bank = bank_mod.from_host(bank, dev)
    system.slot_kf = [None if s < 0 else s for s in meta["slot_kf"]]
    system.kfs = {}
    for k, v in meta["kfs"].items():
        system.kfs[int(k)] = KeyframeRecord(
            kf_id=v["kf_id"], frame_id=v["frame_id"], timestamp=v["timestamp"],
            T_cw=data[f"kf_T_{k}"], slot=v["slot"], in_window=v["in_window"],
            S_cw_opti=data.get(f"kf_S_{k}"))
    system.map_points = {
        int(k[len("map_xyz_"):]): dict(xyz_cam=data[k],
                                       color=data["map_col_" + k[len("map_xyz_"):]])
        for k in data if k.startswith("map_xyz_")}
    system.frames = [
        FrameRecord(f["frame_id"], f["timestamp"], f["ref_kf"],
                    data[f"fr_T_{i}"], f["is_kf"])
        for i, f in enumerate(meta["frames"])
    ]
    system.pose_edges = [
        PoseEdge(e["kf_a"], e["kf_b"], data[f"edge_T_{i}"], e["kind"], e["scale"])
        for i, e in enumerate(meta["edges"])
    ]
    system.next_kf_id = meta["next_kf_id"]
    system.frame_count = meta["frame_count"]
    system.initialized = meta["initialized"]
    system.is_lost = meta["is_lost"]
    system.ref_kf = meta["ref_kf"]
    system.first_coarse_rmse = meta["first_coarse_rmse"]
    if meta["has_T_last"]:
        system.T_last_cw = data["T_last_cw"]
    if meta["has_T_prelast"]:
        system.T_prelast_cw = data["T_prelast_cw"]
    if system.initialized and system.ref_kf is not None:
        if meta.get("port") is not None:
            _restore_port_state(system, data, meta["port"])
        else:
            ref = system.kfs[system.ref_kf]
            system._update_tracker_ref(ref)
            # the live system carries the prediction pair on the device;
            # here it is re-derived from the restored trajectory state
            system._resync_prediction(system._T_ref_cw_np)
            system._kf_base = {system._ref_version: (ref.frame_id, 0.0)}
            system._next_kf_version = system._ref_version + 1
        system.last_rel_ab = data["last_rel_ab"].astype(np.float32)
        system._last_rel_ab_version = system._ref_version
    return system
