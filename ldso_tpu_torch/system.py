"""System orchestration: the odometry conductor, sync and track ∥ map.

Port of ``ldso_tpu/system.py``: every numeric stage (pyramid, tracking,
tracing, activation, BA, marginalization assembly) is a torch function
over fixed-capacity tensors on one device; this module is the host state
machine that owns the frame loop, the keyframe decision, the point
lifecycle (immature → active → marginalized / dropped), window management
and trajectory bookkeeping.

Per frame: pyramid → coarse track vs. reference KF → epipolar trace of
the immature bank (one ``frame_step.fused_step``, or one
``frame_step.fused_batch`` per ``batch_size`` frames) → KF decision. Per
keyframe: insert → activate immature points → windowed photometric BA →
rebuild the tracker reference → select new candidates → flag + marginalize
points and frames into the dense prior.

Modes (as the reference's constructor arguments):
  * ``async_mapping``: keyframes are built on a mapping thread
    (``_mapping_loop``) fed through a queue of keyframe tasks, none of
    which is ever dropped; at most ``tracker.max_kf_inflight`` keyframes
    are queued or being built, further wanted ones are suppressed
    (``kf_suppressed``, ``kf_shed_events``) unless the reference is too
    stale (``tracker.max_stale_delta``), when tracking waits for the
    build;
  * ``pipeline_depth`` > 0 (with ``async_mapping``): the per-frame diag is
    copied to pinned host memory without blocking and read once its CUDA
    event has fired, at most ``pipeline_depth`` frames late;
  * ``batch_size`` > 1 (with both): B frames per ``fused_batch``.
The tracking thread writes back a bank derived from the snapshot it
dispatched with; patches the mapping thread committed meanwhile are
replayed from a journal (``_commit_traced_bank``), so none is lost.

Where this departs from the reference, which was shaped by a remote
accelerator link:
  * A keyframe's finish (pose records, marginalization, hooks) runs at the
    end of its build on the thread that built it; there is no queue of
    deferred finishes. The tracker reference is swapped and the in-flight
    count released before that bookkeeping, so tracking is not held up.
    No finish ever sees a window a later BA has touched, so the
    reference's stale-row race cannot occur and rows need no generation
    counter.
  * A stale keyframe vote (tracked against a reference that has since
    been replaced) is re-evaluated on a motion axis kept per reference
    version (``_effective_delta``), not against the single last trigger:
    that stays right when the lag spans two swaps.
  * No stacked backlog drains, no pulls by age, no probing for async
    copies: readiness is ``torch.cuda.Event.query()``.
  * Every frame is traced by the fused step that tracked it, so a frame
    that is no keyframe leaves no mapping work and is not queued. The
    reference's split ``track_step`` / ``trace_step`` pair, its untraced
    tasks and its rule for dropping queued non-keyframe tasks date from
    before its fused step; nothing produces such tasks and they are not
    carried over.
  * The reference lets the tracking thread run on against the old
    reference while a keyframe is built, up to a staleness bound in scene
    units (``tracker.max_stale_delta``). Here, once a keyframe's trigger
    is decided, one more frame goes out against the old reference; the
    next waits for the new one (``_bound_ref_lag``). Both threads run
    Python under one interpreter lock, so a build beside a free-running
    tracker took ~4x its time alone (~400 against ~90 ms on an H100,
    ``PERF.md``) and the reference went 5-11 frames stale; frames tracked
    13 frames from their reference failed, and keyframes were built from
    them. A batch goes out past no decided trigger, and the triggers whose
    readbacks have landed are decided before it goes (``_flush_batch``):
    with one more batch allowed, frames were tracked up to 12 frames from
    their reference, and the batched drive's ATE on the bench sequence (an
    H100) went from 2.7% to 6.8% with the bootstrap's float32 rounding.
    The
    staleness wait of ``_process_tracked`` stays beside this rule: with
    ``pipeline_depth`` a trigger is decided only when its frame's readback
    lands, up to that many frames after its dispatch, and the frames
    dispatched meanwhile went out against the old reference before this
    rule could hold them (``kf_stale_waits`` counts that wait).
  * After an exception the mapping thread takes no further task until the
    exception has been raised on the caller's thread (the next
    ``add_frame`` / ``finish_mapping``), so the first cause is the one
    reported and no build runs on half-written state unnoticed.
All threads launch their work on the default stream.

Loop closure attaches as in the reference: assign a
``loop.closing.LoopClosing``'s (or ``AsyncLoopClosing``'s) ``on_keyframe``
to :attr:`on_keyframe` (called for every finished keyframe with its
pyramid) and the object to :attr:`loop_closing` (relocalization of lost
frames).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ldso_tpu_torch import frame_step, lifecycle, select, telemetry, tracker
from ldso_tpu_torch.ba import marginal, solve
from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.core import bank as bank_mod
from ldso_tpu_torch.core import window as win_mod
from ldso_tpu_torch.core.window import Window, pattern
from ldso_tpu_torch.init2f import CoarseInitializer
from ldso_tpu_torch.kernels.interp import bilinear33, in_bounds
from ldso_tpu_torch.kernels.pyramid import build_pyramid
from ldso_tpu_torch.loop import orb
from ldso_tpu_torch.math import lie


def _project_points_to_slot(win: Window, slot: int):
    """Project every active point into window slot ``slot``'s frame:
    (uv' [P,2], idepth' [P], color' [P], valid [P]) — the semi-dense
    reference map for the coarse tracker."""
    T = win.current_pose()
    T_rel = T[slot] @ lie.se3_inverse(T)[win.p_host.long()]
    fx, fy, cx, cy = win.c[0], win.c[1], win.c[2], win.c[3]
    xh = torch.stack([(win.p_uv[:, 0] - cx) / fx, (win.p_uv[:, 1] - cy) / fy,
                      torch.ones_like(win.p_uv[:, 0])], dim=-1)
    X = (T_rel[:, :3, :3] @ xh[..., None])[..., 0] + T_rel[:, :3, 3] * win.p_idepth[:, None]
    z = X[..., 2]
    okz = z > 1e-6
    zs = torch.where(okz, z, torch.ones_like(z))
    uvn = torch.stack([fx * X[..., 0] / zs + cx, fy * X[..., 1] / zs + cy], dim=-1)
    h, w = win.images.shape[1], win.images.shape[2]
    # residual-less points are outliers awaiting their drop: exclude them
    valid = win.p_valid & okz & in_bounds(uvn, w, h, 3.0) & (win.p_host != slot) \
        & torch.any(win.res_mask, dim=-1)
    color = bilinear33(win.images[slot], uvn)[..., 0]
    return uvn, win.p_idepth / zs, color, valid


def _sample_pattern(img3, uv, outlier_sum: float = 2500.0):
    """Host-pattern colors + static gradient weights for new points."""
    hit = bilinear33(img3, uv[:, None, :] + pattern(uv.device)[None])  # [N,8,3]
    gsq = torch.sum(hit[..., 1:3] ** 2, dim=-1)
    return hit[..., 0], torch.sqrt(outlier_sum / (outlier_sum + gsq))


def _seed_program(pyr0, pyr1, pyr2, cfg: LdsoConfig, seed: int) -> dict:
    """Candidate seeding: corner detection + gradient selection + 8-pattern
    color/weight sampling for both pools (reference: makeNewTraces =
    FeatureDetector + PixelSelector + ImmaturePoint ctors)."""
    gsq1 = torch.sum(pyr1[..., 1:3] ** 2, dim=-1)
    gsq2 = torch.sum(pyr2[..., 1:3] ** 2, dim=-1)
    osum = float(cfg.ba.outlier_th_sum_component)
    out = {}
    if cfg.selector.corner_fraction > 0:
        feats = orb.detect(pyr0, max_features=cfg.loop.max_features,
                           fast_th=cfg.loop.orb_fast_th)
        c_color, c_weight = _sample_pattern(pyr0, feats.uv, outlier_sum=osum)
        out.update(corner_uv=feats.uv, corner_score=feats.score,
                   corner_valid=feats.valid, corner_color=c_color,
                   corner_weight=c_weight)
    uv, _, valid = select.select_pixels(
        pyr0, gsq1, gsq2, num_want=int(cfg.selector.desired_immature_density),
        block=cfg.selector.block, pot=5,
        min_cut=cfg.selector.min_grad_hist_cut,
        min_add=cfg.selector.min_grad_hist_add,
        down_weight=cfg.selector.grad_down_weight_per_level, seed=seed)
    color, weight = _sample_pattern(pyr0, uv, outlier_sum=osum)
    out.update(sel_uv=uv, sel_valid=valid, sel_color=color, sel_weight=weight)
    return out


def _pad_rows(a: np.ndarray, cap: int, fill=0.0) -> np.ndarray:
    """Pad axis 0 to ``cap``."""
    out = np.full((cap,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a[:cap]
    return out


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    ref_kf: int                   # kf_id of the tracking reference
    T_from_ref: np.ndarray        # [4,4] camFromRef (SE3)
    is_kf: bool


@dataclasses.dataclass
class KeyframeRecord:
    kf_id: int
    frame_id: int
    timestamp: float
    T_cw: np.ndarray              # [4,4] worldToCam (refreshed by BA; final at marg)
    slot: int                     # window slot while active; -1 after
    in_window: bool = True
    # full Sim(3) worldToCam from the global pose graph (reference:
    # Frame::TcwOpti); T_cw above is its center-preserving SE3 projection
    S_cw_opti: Optional[np.ndarray] = None
    # filled by the loop-closing subsystem (features, BoW vector)
    features: Optional[dict] = None


@dataclasses.dataclass
class PoseEdge:
    """Relative-pose constraint recorded at marginalization."""

    kf_a: int
    kf_b: int
    T_ab: np.ndarray              # [4,4] SE3: T_a · T_b⁻¹
    kind: str = "odom"
    scale: float = 1.0


@dataclasses.dataclass
class _MapTask:
    """One tracked frame that becomes a keyframe, handed from the
    tracking front half to the mapping back half."""

    fid: int
    ts: float
    exposure: float
    pyr: tuple                    # device pyramid of the frame (views, in batch mode)
    T_cw: np.ndarray              # [4,4] tracked worldToCam
    aff: tuple                    # (a_abs, b_abs)
    frame_rec: Optional[FrameRecord]
    status: dict


class _RefSnapshot(NamedTuple):
    """What one tracking dispatch reads, taken under ``state_lock`` so
    that a concurrent tracker-ref swap cannot tear it."""

    ref: tracker.TrackerRef
    ref_kf: int
    T_ref_np: np.ndarray
    T_ref_dev: torch.Tensor
    ref_version: int
    bank: bank_mod.Bank
    bank_version: int
    win: Window


@dataclasses.dataclass
class _Pending:
    """A dispatched tracking result awaiting its readback: one frame
    (``out`` a FusedStepOut) or one batch (a FusedBatchOut)."""

    meta: list                    # [(fid, ts, exposure)]
    out: object
    batched: bool
    ref_kf: int
    T_ref_np: np.ndarray
    ref_version: int
    diag_host: torch.Tensor       # host copy of the diag(s), valid once ready
    event: Optional[object]       # torch.cuda.Event of that copy; None on the CPU

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class FullSystem:
    """Monocular direct odometry on one torch device."""

    def __init__(self, cfg: LdsoConfig, intr, w: int, h: int, *, device,
                 async_mapping: bool = False, pipeline_depth: int = 0,
                 batch_size: int = 1):
        """``async_mapping``: build keyframes on a mapping thread.
        ``pipeline_depth`` > 0 defers each tracking readback until its copy
        has landed, by at most that many frames (only with
        ``async_mapping``). ``batch_size`` > 1 tracks and traces B frames
        per dispatch (only with both)."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.pipeline_depth = pipeline_depth if async_mapping else 0
        self.batch_size = batch_size if (async_mapping and pipeline_depth > 0) else 1
        self._fbuf: List[tuple] = []          # frames awaiting batch dispatch
        L = cfg.shapes.pyr_levels
        m = 1 << (L - 1)
        self.w = (w // m) * m
        self.h = (h // m) * m
        self.intr = np.asarray(intr, dtype=np.float32)
        self.intr_t = torch.as_tensor(self.intr, device=self.device)

        self.win = win_mod.empty_window(cfg, self.h, self.w, self.intr, self.device)
        self.HM, self.bM = marginal.empty_prior(cfg.shapes.state_dim)
        self.slot_kf: List[Optional[int]] = [None] * cfg.shapes.max_frames
        self.kfs: dict = {}
        self.frames: List[FrameRecord] = []
        self.pose_edges: List[PoseEdge] = []
        # persistent map: kf_id -> dict(xyz_cam [n,3], color [n]) of points
        # archived (in host-camera coordinates) when they left the window
        self.map_points: dict = {}
        # one record per tracked frame (its status without the word itself)
        self.metrics: List[dict] = []
        self.bank = bank_mod.empty_bank(cfg.shapes.max_immature, self.device)
        # bank-patch journal: the mapping thread's _commit_bank_patch bumps
        # the version and records (fn, args), so that the tracking thread's
        # write-back of a traced bank can re-apply every patch committed
        # since the snapshot it traced from
        self._bank_version = 0
        self._bank_patches: List[tuple] = []   # (version, fn, args)

        self.initializer = CoarseInitializer(cfg, self.intr, self.device)
        self.initialized = False
        self.init_failed = False
        self.is_lost = False
        self._init_frames: List[tuple] = []   # (frame_id, ts, T_first_to_cur)

        self.next_kf_id = 0
        self.frame_count = 0
        self.track_ref: Optional[tracker.TrackerRef] = None
        self.ref_kf: Optional[int] = None
        # relative affine of the last frame read back, and the ref version
        # it was measured against: it seeds the next track only against
        # that same ref (see _track_single)
        self.last_rel_ab = np.zeros(2, dtype=np.float32)
        self._last_rel_ab_version = -1
        self.T_last_cw: Optional[np.ndarray] = None
        self.T_prelast_cw: Optional[np.ndarray] = None
        self.first_coarse_rmse = -1.0
        # prediction state: refToNew of the last two frames relative to the
        # tracking ref the last dispatch used, and that ref's pose
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self._T_last_rel = eye
        self._T_prelast_rel = eye
        self._ab_rel_dev = torch.zeros(2, dtype=torch.float32, device=self.device)
        self._T_ref_cw_dev = eye
        self._T_ref_cw_np = np.eye(4)
        self._ref_version = 0            # bumped at every tracker-ref swap
        self._dispatch_ref_version = 0
        self._dispatch_T_ref_dev = eye
        self._n_active_cache = 0
        # submit → pose-available latency per tracked frame (deferred and
        # batched readbacks included)
        self.frame_latency_ms: List[float] = []
        self._t_submit: dict = {}
        # KF wants suppressed because max_kf_inflight keyframes were
        # already in flight, and the distinct want-windows among them
        self.kf_suppressed = 0
        self.kf_shed_events = 0
        self.kf_stale_waits = 0       # tracking waited on the staleness bound
        # motion axis for stale votes: ref version -> (frame id of the
        # keyframe that version tracks against, its position on the axis)
        self._kf_base: dict = {0: (-1, 0.0)}
        self._next_kf_version = 1
        self._pending: collections.deque = collections.deque()
        self._min_act_dist = cfg.selector.min_act_dist
        self.last_idepth_hessian: Optional[np.ndarray] = None
        # hooks the loop-closing subsystem assigns
        self.on_keyframe = None
        self.loop_closing = None
        # taken by loop closure around its reads and write-backs of the
        # host registries (slot_kf, kfs, pose_edges), as in the reference
        self.state_lock = threading.Lock()

        # track ∥ map pipeline
        self._async = bool(async_mapping)
        self._map_queue: collections.deque = collections.deque()
        self._map_cv = threading.Condition()
        self._map_busy = False
        self._map_exc: Optional[BaseException] = None
        self._kf_inflight = 0         # KFs queued or being built by mapping
        self._kf_want_streak = 0      # consecutive suppressed KF wants
        self._dispatched_past_trigger = False   # since the last KF trigger
        self._map_running = True
        self._map_thread: Optional[threading.Thread] = None
        if async_mapping:
            self._map_thread = threading.Thread(
                target=self._mapping_loop, name="ldso-mapping", daemon=True)
            self._map_thread.start()

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    @property
    def immatures(self) -> bank_mod.Bank:
        """Host snapshot of the immature bank."""
        return bank_mod.to_host(self.bank)

    def add_frame(self, img, timestamp: Optional[float] = None,
                  exposure: float = 1.0) -> dict:
        self._raise_map_exc()
        fid = self.frame_count
        self.frame_count += 1
        with telemetry.span("add_frame", frame=fid):
            return self._add_frame(fid, img, timestamp, exposure)

    def _add_frame(self, fid, img, timestamp, exposure) -> dict:
        ts = float(timestamp) if timestamp is not None else float(fid)
        # uint8 frames stay uint8 up to the pyramid build, which widens them
        img = np.ascontiguousarray(np.asarray(img)[: self.h, : self.w])
        if img.dtype != np.uint8:
            img = img.astype(np.float32, copy=False)

        if self.initialized and not self.is_lost:
            self._t_submit[fid] = time.perf_counter()
            return self._track_and_map(fid, ts, float(exposure), img)
        if self.is_lost and self.loop_closing is None:
            return dict(status="lost", frame_id=fid)
        pyr, _ = build_pyramid(torch.from_numpy(img).to(self.device),
                               self.cfg.shapes.pyr_levels)
        if self.is_lost:
            # relocalization by BoW + PnP re-anchor
            rel = self.loop_closing.relocalize(self, pyr)
            if rel is None:
                return dict(status="lost", frame_id=fid)
            self.is_lost = False
            self.T_last_cw = rel["T_cw"]
            self.T_prelast_cw = rel["T_cw"].copy()
            self.first_coarse_rmse = -1.0
            self._resync_prediction(self._T_ref_cw_np)
            return dict(status="relocalized", frame_id=fid, anchor_kf=rel["kf_id"],
                        n_inliers=rel["n_inliers"])
        with telemetry.span("bootstrap"):
            return self._initializer_step(fid, ts, float(exposure), pyr)

    def export_trajectory(self):
        """(timestamps [N], T_cw [N,4,4]) for every tracked frame — frame
        poses composed onto their reference KF's final pose."""
        ts_out, poses = [], []
        for fr in self.frames:
            kf = self.kfs.get(fr.ref_kf)
            if kf is None:
                continue
            ts_out.append(fr.timestamp)
            poses.append(fr.T_from_ref @ kf.T_cw)
        return np.asarray(ts_out), np.asarray(poses)

    def write_metrics(self, path: str):
        """One JSON line per tracked frame (``self.metrics``). Where
        ``telemetry`` recorded the frame, the line also holds ``ms``, the
        frame's milliseconds by span name (each name's spans summed), and
        ``counts``, its counters."""
        recorded = {f.id: f for f in telemetry.frames()[0]}
        with open(path, "w") as f:
            for m in self.metrics:
                rec = recorded.get(m["frame"])
                if rec is not None:
                    m = dict(m, ms={k: round(v[1] * 1e-6, 4)
                                    for k, v in telemetry.totals([rec]).items()})
                    if rec.counts:
                        m["counts"] = dict(rec.counts)
                f.write(json.dumps(m) + "\n")

    # ------------------------------------------------------------------
    # Initialization path
    # ------------------------------------------------------------------

    def _initializer_step(self, fid, ts, exposure, pyr) -> dict:
        init = self.initializer
        if init.frame_id_first is None:
            gsq = [torch.sum(p[..., 1:3] ** 2, dim=-1) for p in pyr]
            init.set_first(pyr, gsq)
            init.frame_id_first = fid
            self._init_frames = [(fid, ts, np.eye(4))]
            self._first_pyr = pyr
            self._first_exposure = exposure
            self._first_ts = ts
            return dict(status="init_first", frame_id=fid)

        st = init.track(pyr)
        self._init_frames.append((fid, ts, init.T.cpu().numpy().astype(np.float64)))
        if st["done"]:
            self._init_from_initializer(fid, ts, exposure, pyr)
            return dict(status="initialized", frame_id=fid, **st)
        # bootstrap divergence → restart from scratch on the next frame
        if init.frames_tracked > 30 and not init.snapped:
            self.init_failed = True
            init.frame_id_first = None
            init.frames_tracked = 0
            return dict(status="init_reset", frame_id=fid)
        return dict(status="initializing", frame_id=fid, **st)

    def _init_from_initializer(self, fid, ts, exposure, pyr):
        cfg = self.cfg
        res = self.initializer.results()
        rescale = res["rescale"]

        # first KF at world origin, second at the bootstrap pose
        kf0 = self._new_kf(self._init_frames[0][0], self._first_ts, np.eye(4),
                           self._first_pyr[0], self._first_exposure, aff_ab=(0.0, 0.0))
        ab1 = res["ab"]
        kf1 = self._new_kf(fid, ts, res["T_first_to_new"], pyr[0], exposure,
                           aff_ab=(float(ab1[0]), float(ab1[1])))

        # points hosted by KF0, padded to capacity (pad slot P is dropped)
        order = np.flatnonzero(np.asarray(res["good"]))
        P = cfg.shapes.max_points
        k = min(len(order), P)
        order = order[:k]
        uv = _pad_rows(np.asarray(res["uv"], np.float32)[order], P)
        idepth = _pad_rows(np.asarray(res["idepth"], np.float32)[order], P, 1.0)
        slots = np.full(P, P, np.int64)
        slots[:k] = np.arange(k)
        uv_t = torch.as_tensor(uv, device=self.device)
        color, weight = _sample_pattern(
            self.win.images[kf0.slot], uv_t,
            outlier_sum=float(cfg.ba.outlier_th_sum_component))
        self.win = win_mod.add_points(self.win, slots, kf0.slot, uv_t, color, weight,
                                      idepth)

        # polish with one BA round
        self._run_ba()
        self._refresh_kf_poses()

        # record the in-between bootstrap frames (translations rescaled)
        for i, (f_id, f_ts, T) in enumerate(self._init_frames):
            T = T.copy()
            T[:3, 3] /= rescale
            self.frames.append(FrameRecord(f_id, f_ts, kf0.kf_id, T, is_kf=(i == 0)))
        self.frames[-1] = FrameRecord(fid, ts, kf1.kf_id, np.eye(4), True)

        self._seed_new_kf(kf1.slot, pyr)
        self._update_tracker_ref(kf1)
        self.T_last_cw = np.asarray(self.kfs[kf1.kf_id].T_cw)
        self.T_prelast_cw = np.eye(4)
        self._resync_prediction(self._T_ref_cw_np)
        self._kf_base = {self._ref_version: (fid, 0.0)}
        self._next_kf_version = self._ref_version + 1
        self.initialized = True
        if self.on_keyframe is not None:
            self.on_keyframe(self, kf0, self._first_pyr)
            self.on_keyframe(self, kf1, pyr)

    # ------------------------------------------------------------------
    # Steady-state tracking
    # ------------------------------------------------------------------

    def _track_and_map(self, fid, ts, exposure, img) -> dict:
        if self.batch_size > 1:
            self._fbuf.append((fid, ts, exposure, img))
            if len(self._fbuf) >= self.batch_size:
                return self._flush_batch()
            return dict(status="pending", frame_id=fid)
        return self._track_single(fid, ts, exposure, img)

    def _snapshot(self) -> _RefSnapshot:
        with self.state_lock:     # async: the mapping thread swaps these
            return _RefSnapshot(self.track_ref, self.ref_kf, self._T_ref_cw_np,
                                self._T_ref_cw_dev, self._ref_version, self.bank,
                                self._bank_version, self.win)

    def _reexpress_carries(self, snap: _RefSnapshot):
        """The ref swapped since the last dispatch: re-express the
        prediction pair relative to the new ref,
        T_rel_new = T_rel_old · T_oldref_cw · T_newref_cw⁻¹, on the device
        and without draining the pipeline. The relative-affine carry
        resets to zero like the per-frame path's ``last_rel_ab``."""
        if self._dispatch_ref_version == snap.ref_version:
            return
        D = lie.se3_mul(self._dispatch_T_ref_dev, lie.se3_inverse(snap.T_ref_dev))
        self._T_last_rel = lie.se3_mul(self._T_last_rel, D)
        self._T_prelast_rel = lie.se3_mul(self._T_prelast_rel, D)
        self._ab_rel_dev = torch.zeros_like(self._ab_rel_dev)
        self._dispatch_ref_version = snap.ref_version
        self._dispatch_T_ref_dev = snap.T_ref_dev

    def _flush_batch(self) -> dict:
        """Dispatch the buffered frames as one ``frame_step.fused_batch``:
        one host→device copy of the stacked frames, one pyramid launch,
        and later one readback of the stacked diags. Fewer than
        ``batch_size`` frames (the tail of a sequence) take the per-frame
        path."""
        meta, self._fbuf = self._fbuf, []
        if not meta:
            return dict(status="pending")
        if len(meta) < self.batch_size:
            st: dict = dict(status="pending")
            for fid, ts, expo, img in meta:
                st = self._track_single(fid, ts, expo, img)
                if st.get("status") == "lost":
                    break
            return st
        # the triggers whose readbacks have landed are decided first, and no
        # batch goes out past a decided trigger: a batch sent against the
        # old reference would track up to 3 batch_size frames from it
        st = self._process_due(max(1, self.pipeline_depth // self.batch_size))
        if st is not None and st.get("status") == "lost":
            return st
        self._dispatched_past_trigger = True
        self._bound_ref_lag()
        snap = self._snapshot()
        self._reexpress_carries(snap)
        imgs = torch.from_numpy(np.stack([m[3] for m in meta])).to(self.device)
        out = frame_step.fused_batch(
            imgs, [m[2] for m in meta], snap.ref, self._T_last_rel,
            self._T_prelast_rel, self._ab_rel_dev, snap.bank, snap.win.T_eval,
            snap.win.x, snap.win.exposure, snap.T_ref_dev, self.intr_t, self.cfg)
        self._commit_traced_bank(out.bank, snap.bank_version)
        self._T_last_rel = out.T_last
        self._T_prelast_rel = out.T_prelast
        self._ab_rel_dev = out.ab_rel
        self._pending.append(self._pending_entry(
            [m[:3] for m in meta], out, out.diags, True, snap))
        st = self._process_due(max(1, self.pipeline_depth // self.batch_size))
        return st or dict(status="pending", frame_id=meta[-1][0])

    def _bound_ref_lag(self):
        """Async modes: once a keyframe's trigger has been decided, one more
        dispatch goes out against the old reference; the next waits for the
        new one (a departure, see the module docstring; ``_flush_batch``
        allows a batch no such dispatch). The wait ends early
        on a mapping exception and gives up after 1.2 s, as the staleness
        wait of ``_process_tracked`` does."""
        if not self._async:
            return
        if self._kf_inflight > 0 and self._dispatched_past_trigger:
            with self._map_cv:
                self._map_cv.wait_for(
                    lambda: self._kf_inflight == 0 or self._map_exc is not None,
                    timeout=1.2)
        self._dispatched_past_trigger = True

    def _track_single(self, fid, ts, exposure, img) -> dict:
        self._bound_ref_lag()
        snap = self._snapshot()
        self._reexpress_carries(snap)
        # the last relative affine seeds this track only if it was measured
        # against this dispatch's ref: a frame that was in flight across a
        # swap reports its affine against the OLD ref, and the tracker,
        # which holds (a, b) weakly, would stay near that seed (the
        # reference's per-frame async path does carry it across)
        with telemetry.span("wait.upload"):     # pageable copies end in a stream sync
            ab0 = torch.as_tensor(
                self.last_rel_ab if self._last_rel_ab_version == snap.ref_version
                else np.zeros(2, dtype=np.float32), device=self.device)
            img_dev = torch.from_numpy(img).to(self.device)
        out = frame_step.fused_step(
            img_dev, snap.ref, self._T_last_rel,
            self._T_prelast_rel, ab0, snap.bank, snap.win.T_eval, snap.win.x,
            snap.win.exposure, snap.T_ref_dev, self.intr_t, exposure, self.cfg)
        self._commit_traced_bank(out.bank, snap.bank_version)
        self._T_prelast_rel = self._T_last_rel
        self._T_last_rel = out.T
        entry = self._pending_entry([(fid, ts, exposure)], out, out.diag, False, snap)
        if self.pipeline_depth == 0:
            return self._process_entry(entry)
        # deferred decision: the copy was started at dispatch; entries are
        # read as soon as their copy has landed, pipeline_depth at most late
        self._pending.append(entry)
        st = self._process_due(self.pipeline_depth)
        return st or dict(status="pending", frame_id=fid)

    def _pending_entry(self, meta, out, diag, batched, snap: _RefSnapshot) -> _Pending:
        """Start the diag's copy to pinned host memory and mark it with an
        event; on the CPU the diag is already on the host."""
        event = None
        if diag.device.type == "cuda":
            host = torch.empty(diag.shape, dtype=diag.dtype, pin_memory=True)
            host.copy_(diag, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = diag
        return _Pending(meta, out, batched, snap.ref_kf, snap.T_ref_np,
                        snap.ref_version, host, event)

    def _process_due(self, cap: int) -> Optional[dict]:
        """Consume pending entries from the oldest on while it is ready or
        the queue is longer than ``cap``."""
        st = None
        while self._pending and (len(self._pending) > cap or self._pending[0].ready()):
            st = self._process_entry(self._pending.popleft())
            if st.get("status") == "lost":
                break
        return st

    def _process_entry(self, entry: _Pending) -> dict:
        if entry.event is not None:
            with telemetry.span("wait.diag"):
                entry.event.synchronize()
        diags = entry.diag_host.numpy().reshape(len(entry.meta), -1)
        st: dict = dict(status="pending")
        for i, (fid, ts, expo) in enumerate(entry.meta):
            st = self._process_tracked(fid, ts, expo, entry.out, entry.ref_kf,
                                       entry.T_ref_np, diags[i],
                                       batch_idx=i if entry.batched else None,
                                       ref_version=entry.ref_version)
            if st.get("status") == "lost":
                break
        return st

    def _commit_traced_bank(self, traced_bank, bank_version: int):
        """Write a traced bank back to ``self.bank``, re-applying every
        bank patch the mapping thread committed since ``bank_version`` was
        read at dispatch: the keyframe's drops and seeds must survive a
        concurrent tracking write-back. Patches apply after the trace; the
        patch functions are pure in (bank, args), so the replay equals
        what the live bank got."""
        with self.state_lock:
            if self._bank_version != bank_version:
                if self._bank_patches and bank_version < self._bank_patches[0][0] - 1:
                    raise RuntimeError(
                        f"bank-patch journal underrun: dispatch read v{bank_version}, "
                        f"oldest retained v{self._bank_patches[0][0]}")
                for ver, fn, args in self._bank_patches:
                    if ver > bank_version:
                        traced_bank = fn(traced_bank, *args)
            self.bank = traced_bank

    def _commit_bank_patch(self, fn, *args):
        """Apply a bank-surgery op to the live bank under the lock and
        journal it for the tracking thread's write-backs."""
        with self.state_lock:
            self.bank = fn(self.bank, *args)
            self._bank_version += 1
            self._bank_patches.append((self._bank_version, fn, args))
            # a keyframe commits three patches (activation drop, seeds,
            # marginalization cull); 24 entries cover every build that can
            # overlap one dispatch, and the write-back checks that they did
            del self._bank_patches[:-24]

    def _resync_prediction(self, T_ref_cw: np.ndarray):
        """Re-express the prediction pair relative to ``T_ref_cw`` from the
        host trajectory state (initialization, relocalization)."""
        inv_ref = np.linalg.inv(T_ref_cw)
        T_l = self.T_last_cw @ inv_ref if self.T_last_cw is not None else np.eye(4)
        T_p = self.T_prelast_cw @ inv_ref if self.T_prelast_cw is not None else T_l
        f32 = dict(dtype=torch.float32, device=self.device)
        self._T_last_rel = torch.as_tensor(T_l, **f32)
        self._T_prelast_rel = torch.as_tensor(T_p, **f32)
        self._ab_rel_dev = torch.zeros_like(self._ab_rel_dev)
        self._dispatch_T_ref_dev = torch.as_tensor(np.asarray(T_ref_cw, np.float64), **f32)
        self._dispatch_ref_version = self._ref_version

    def _drain_pending(self):
        if self.batch_size > 1 and self._fbuf:
            self._flush_batch()        # tail frames (per-frame path)
        while self._pending:
            self._process_entry(self._pending.popleft())

    def _effective_delta(self, fid: int, delta: float, ref_version: int) -> float:
        """Motion of frame ``fid`` since the NEWEST keyframe, from its KF
        score ``delta`` measured against the ref of ``ref_version``.

        Every ref version has a position on one motion axis: the
        position of the version its keyframe's frame was tracked against,
        plus that frame's delta (recorded when it triggers,
        ``_record_trigger``). A frame's own position is its ref's
        position plus its delta, and its distance to the newest ref's
        position is the vote. For a current frame that is ``delta``
        itself; across one swap it is delta minus the trigger's delta, as
        in the reference; across two swaps it still compares like with
        like, where the reference's single trigger delta mixes two refs."""
        cur = self._ref_version
        if ref_version == cur or cur not in self._kf_base \
                or ref_version not in self._kf_base:
            return delta
        kf_fid, base_now = self._kf_base[cur]
        if fid <= kf_fid:
            return 0.0
        return self._kf_base[ref_version][1] + delta - base_now

    def _record_trigger(self, fid: int, delta: float, ref_version: int):
        """Frame ``fid`` triggers the keyframe whose ref swap will be
        version ``_next_kf_version``: fix that version's axis position."""
        base = self._kf_base.get(ref_version, (fid, 0.0))[1]
        self._kf_base[self._next_kf_version] = (fid, base + delta)
        self._next_kf_version += 1
        for v in [v for v in self._kf_base if v < self._next_kf_version - 8]:
            del self._kf_base[v]

    def _process_tracked(self, fid, ts, exposure, out, ref_kf_id, T_ref_cw, diag,
                         batch_idx=None, ref_version=None) -> dict:
        """Consume one tracking result: lost check, trajectory record,
        KF decision, hand-off to the mapping back half."""
        cfg = self.cfg
        t_sub = self._t_submit.pop(fid, None)
        if t_sub is not None:
            self.frame_latency_ms.append(1e3 * (time.perf_counter() - t_sub))
        rmse0 = float(diag[frame_step.DIAG_RMSE0])
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = rmse0
        if not np.isfinite(rmse0) or rmse0 > 4.0 * max(self.first_coarse_rmse, 1e-3):
            self.is_lost = True
            self._pending.clear()     # later frames tracked a lost state
            self._fbuf.clear()
            self._t_submit.clear()
            return dict(status="lost", frame_id=fid, rmse=rmse0)

        T_rel = diag[frame_step.DIAG_T:].reshape(4, 4).astype(np.float64)
        T_cw = T_rel @ T_ref_cw
        if ref_version is None:
            ref_version = self._ref_version
        self.last_rel_ab = diag[frame_step.DIAG_A_REL:frame_step.DIAG_B_REL + 1] \
            .astype(np.float32)
        self._last_rel_ab_version = ref_version
        self.frames.append(FrameRecord(fid, ts, ref_kf_id, T_rel, False))

        flow = diag[frame_step.DIAG_FLOW_T:frame_step.DIAG_FLOW_R + 1]
        delta = float(diag[frame_step.DIAG_KF_DELTA])
        need_kf = delta > 1.0 or 2.0 * self.first_coarse_rmse < rmse0
        # a vote measured against a ref that has since been replaced would,
        # at face value, re-trigger a keyframe right after every swap:
        # re-evaluate it as motion since the newest keyframe
        eff_delta = self._effective_delta(fid, delta, ref_version)
        if need_kf and ref_version != self._ref_version:
            need_kf = eff_delta > 1.0
        # bounded keyframes in flight: shed further wants, unless the ref
        # is too stale in scene units, when tracking waits for the build
        max_inflight = max(int(cfg.tracker.max_kf_inflight), 1)
        if need_kf and self._async and self._kf_inflight >= max_inflight:
            self._kf_want_streak += 1
            max_sup = cfg.tracker.max_kf_suppress
            too_stale = eff_delta > cfg.tracker.max_stale_delta \
                or (max_sup > 0 and self._kf_want_streak >= max_sup)
            if too_stale:
                self.kf_stale_waits += 1
                with self._map_cv:
                    self._map_cv.wait_for(
                        lambda: self._kf_inflight < max_inflight
                        or self._map_exc is not None, timeout=1.2)
            if self._kf_inflight >= max_inflight:
                need_kf = False
                self.kf_suppressed += 1
                # distinct want-windows, not want-frames: re-evaluated
                # votes re-fire on every frame of a lag window
                if self._kf_want_streak == 1:
                    self.kf_shed_events += 1
        if need_kf:
            self._record_trigger(fid, delta, ref_version)
            self._kf_want_streak = 0
            if self._async:
                self._dispatched_past_trigger = False
                with self._map_cv:    # the mapping thread decrements under it
                    self._kf_inflight += 1

        status = dict(status="tracked", frame_id=fid, rmse=rmse0,
                      flow=flow.tolist(), need_kf=bool(need_kf),
                      n_active=self._n_active_cache)
        if need_kf:
            # the fused step traced this frame; frames that are no
            # keyframes have no mapping work left and are not delivered
            aff = (float(diag[frame_step.DIAG_A_ABS]), float(diag[frame_step.DIAG_B_ABS]))
            pyr = out.pyr if batch_idx is None else frame_step.slice_pyr(out.pyr, batch_idx)
            task = _MapTask(fid, ts, exposure, pyr, T_cw, aff, self.frames[-1], status)
            if self._async:
                self._deliver_tracked_frame(task)
            else:
                self._map_frame(task)
        self.T_prelast_cw = self.T_last_cw
        self.T_last_cw = T_cw
        self.metrics.append(dict(frame=fid, **{k: v for k, v in status.items()
                                               if k != "status"}))
        return status

    # ------------------------------------------------------------------
    # Track ∥ map pipeline
    # ------------------------------------------------------------------

    def _raise_map_exc(self):
        """Surface an exception of the mapping thread on the caller's;
        the thread takes tasks again once it has been handed over."""
        if self._map_exc is not None:
            with self._map_cv:
                exc, self._map_exc = self._map_exc, None
                self._map_cv.notify_all()
            raise exc

    def _deliver_tracked_frame(self, task: _MapTask):
        self._raise_map_exc()
        with self._map_cv:
            # keyframes only, never dropped: _process_tracked bounds the
            # backlog by suppressing wants beyond max_kf_inflight
            self._map_queue.append(task)
            self._map_cv.notify_all()

    def _mapping_loop(self):
        while True:
            with self._map_cv:
                # an exception not yet handed over holds the queue
                while self._map_running and (not self._map_queue
                                             or self._map_exc is not None):
                    self._map_cv.wait()
                if not self._map_running:
                    return
                task = self._map_queue.popleft()
                self._map_busy = True
            try:
                self._map_frame(task)
            except Exception as e:        # surfaced on the next add_frame /
                self._map_exc = e         # deliver / finish_mapping
            finally:
                with self._map_cv:
                    self._map_busy = False
                    self._map_cv.notify_all()

    def finish_mapping(self):
        """Read every tracking result still pending and block until the
        mapping backlog has drained."""
        self._raise_map_exc()
        self._drain_pending()
        if self._async:
            with self._map_cv:
                while (self._map_queue or self._map_busy) and self._map_exc is None:
                    self._map_cv.wait(0.05)
        self._raise_map_exc()

    def shutdown(self):
        """Stop the mapping thread (after ``finish_mapping``)."""
        if self._map_thread is None:
            return
        try:
            self.finish_mapping()
        finally:
            with self._map_cv:
                self._map_running = False
                self._map_queue.clear()
                self._map_cv.notify_all()
            self._map_thread.join(timeout=30.0)
            if self._map_thread.is_alive():
                raise RuntimeError("the mapping thread did not stop")
            self._map_thread = None

    def _map_frame(self, task: _MapTask):
        self._make_keyframe(task.fid, task.ts, task.exposure, task.pyr, task.T_cw,
                            task.aff, task.status, task.frame_rec)

    # ------------------------------------------------------------------
    # Keyframe path
    # ------------------------------------------------------------------

    def _make_keyframe(self, fid, ts, exposure, pyr, T_cw, aff_ab, status,
                       frame_rec: FrameRecord):
        """Build a keyframe and finish it. The tracker ref is swapped, the
        fresh candidates enter the bank and the in-flight count is
        released BEFORE the marginalization bookkeeping, so that frames
        dispatched meanwhile already track against the new keyframe."""
        with telemetry.span("kf_path", frame=fid):
            self._build_keyframe(fid, ts, exposure, pyr, T_cw, aff_ab, status, frame_rec)

    def _build_keyframe(self, fid, ts, exposure, pyr, T_cw, aff_ab, status,
                        frame_rec: FrameRecord):
        cfg = self.cfg
        kf = self._new_kf(fid, ts, T_cw, pyr[0], exposure, aff_ab)
        frame_rec.ref_kf = kf.kf_id
        frame_rec.T_from_ref = np.eye(4)
        frame_rec.is_kf = True
        self.win = win_mod.connect_new_frame(self.win, kf.slot)

        mad_px = self._update_min_act_dist()
        with telemetry.span("activate"):
            with self.state_lock:
                bank = self.bank
            self.win, act_drop, act_stats = lifecycle.kf_activate(
                self.win, bank, self.intr_t, kf.slot, mad_px, cfg)
            self._commit_bank_patch(bank_mod.drop_rows, act_drop)
        seed = self._dispatch_seed(pyr)

        active_rec = [(kid, s) for s, kid in enumerate(self.slot_kf) if kid is not None]
        self.win, stats = solve.run_ba(self.win, self.HM, self.bM, cfg,
                                       anchor_slot=self._oldest_slot())
        self.last_idepth_hessian = stats.idepth_hessian
        self._update_tracker_ref(kf)
        self._seed_new_kf(kf.slot, pyr, seed=seed)
        # the keyframe no longer blocks decisions
        if self._async:
            with self._map_cv:
                if self._kf_inflight > 0:
                    self._kf_inflight -= 1
                self._map_cv.notify_all()    # wakes a tracking thread that waits
        self._finish_kf(kf, stats, act_stats.cpu().numpy(), active_rec, status, pyr)

    @telemetry.span("kf_finish")
    def _finish_kf(self, kf, stats: solve.BAStats, act, active_rec, status, pyr):
        """Host bookkeeping of a keyframe from its BA results: pose
        records, frame flagging, point and frame marginalization; then
        the keyframe hook with the keyframe's pyramid."""
        n_act = int(act[lifecycle.ST_N_ACT])
        status.update(n_imm=int(act[lifecycle.ST_N_IMM]),
                      n_imm_good=int(act[lifecycle.ST_N_IMM_GOOD]),
                      n_imm_q=int(act[lifecycle.ST_N_IMM_Q]))
        self._refresh_kf_poses(stats.poses, active_rec)
        # the exact post-BA pose replaces the tracked estimate the swap
        # installed (same ref version: the device-side pose was exact)
        with self.state_lock:
            if self.ref_kf == kf.kf_id:
                self._T_ref_cw_np = stats.poses[kf.slot].copy()

        marg_slots = self._flag_frames_for_marginalization(stats, active_rec, kf.slot)
        n_goners = self._remove_and_marginalize_points(stats, marg_slots)
        self._n_active_cache = int(act[lifecycle.ST_N_ACTIVE]) - n_goners
        status.update(n_act=n_act, n_drop=n_goners,
                      e_per_res=stats.energy_photo / max(stats.num_residuals, 1),
                      e_prior=stats.energy_final - stats.energy_photo)
        for slot in marg_slots:
            self._marginalize_frame(slot, stats)
        if marg_slots:
            dying = torch.zeros(self.cfg.shapes.max_frames, dtype=torch.bool,
                                device=self.device)
            dying[list(marg_slots)] = True
            self._commit_bank_patch(bank_mod.drop_hosted, dying)
        status.update(ba_energy=stats.energy_final, ba_iters=stats.iterations,
                      n_res=stats.num_residuals, kf_id=kf.kf_id,
                      n_window=sum(k is not None for k in self.slot_kf),
                      n_corner_act=int(act[lifecycle.ST_N_CORNER_ACT]),
                      min_act_dist=self._min_act_dist)
        if self.on_keyframe is not None:
            self.on_keyframe(self, kf, pyr)

    def _free_slot(self) -> Optional[int]:
        for i, k in enumerate(self.slot_kf):
            if k is None:
                return i
        return None

    def _new_kf(self, fid, ts, T_cw, img3, exposure, aff_ab) -> KeyframeRecord:
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError("no free window slot")
        kf = KeyframeRecord(self.next_kf_id, fid, ts, np.asarray(T_cw, np.float64), slot)
        self.next_kf_id += 1
        self.slot_kf[slot] = kf.kf_id
        with self.state_lock:
            self.kfs[kf.kf_id] = kf
        self.win = win_mod.insert_frame(
            self.win, slot, torch.as_tensor(np.asarray(T_cw, np.float32)), img3,
            exposure, aff_ab=aff_ab)
        return kf

    def _run_ba(self) -> solve.BAStats:
        self.win, stats = solve.run_ba(self.win, self.HM, self.bM, self.cfg,
                                       anchor_slot=self._oldest_slot())
        self.last_idepth_hessian = stats.idepth_hessian
        return stats

    def _oldest_slot(self) -> int:
        act = [(kid, s) for s, kid in enumerate(self.slot_kf) if kid is not None]
        return min(act)[1] if act else 0

    def _refresh_kf_poses(self, poses: Optional[np.ndarray] = None,
                          active_rec: Optional[list] = None):
        """Write BA poses back to the host records of the frames that BA solved."""
        T = (np.asarray(poses, dtype=np.float64) if poses is not None
             else self.win.current_pose().cpu().numpy().astype(np.float64))
        rec = (active_rec if active_rec is not None
               else [(kid, s) for s, kid in enumerate(self.slot_kf) if kid is not None])
        with self.state_lock:
            for kid, slot in rec:
                if self.slot_kf[slot] == kid:
                    self.kfs[kid].T_cw = T[slot]

    # ------------------------------------------------------------------
    # Window management (reference: flagFramesForMarginalization)
    # ------------------------------------------------------------------

    def _flag_frames_for_marginalization(self, stats: solve.BAStats,
                                         active_rec: List[tuple],
                                         newest_slot: int) -> List[int]:
        cfg = self.cfg
        current = sorted((kid, s) for s, kid in enumerate(self.slot_kf) if kid is not None)
        if len(current) <= cfg.window.max_kf:
            return []
        newest2 = {s for _, s in current[-2:]}
        cand = [s for kid, s in sorted(active_rec)
                if self.slot_kf[s] == kid and s not in newest2 and s != newest_slot]
        p_host, p_valid, vp = stats.p_host, stats.p_valid, stats.valid_pair

        flagged: List[int] = []
        n_keep = len(current)
        # rule 1: almost no points visible in the newest KF, or a large
        # affine gap to it (reference: <5% in-view, maxLogAffFac)
        x = stats.x
        for s in cand:
            if n_keep - len(flagged) <= cfg.window.min_kf:
                continue
            hosted = p_valid & (p_host == s)
            n_hosted = int(hosted.sum())
            vis = int((vp[:, newest_slot] & hosted).sum()) / n_hosted if n_hosted else 1.0
            aff_gap = abs(float(x[s, 6] - x[newest_slot, 6]))
            if n_hosted == 0 or vis < cfg.window.min_inlier_visible_frac \
                    or aff_gap > cfg.window.max_log_aff_fac:
                flagged.append(s)
        # rule 2: drop the frame crowded among the others but far from the newest
        T = np.asarray(stats.poses, dtype=np.float64)
        while n_keep - len(flagged) > cfg.window.max_kf:
            centers = {s: -T[s, :3, :3].T @ T[s, :3, 3] for s in cand}
            centers[newest_slot] = -T[newest_slot, :3, :3].T @ T[newest_slot, :3, 3]
            best, best_score = None, -np.inf
            for s in cand:
                if s in flagged:
                    continue
                d_new = np.linalg.norm(centers[s] - centers[newest_slot])
                crowd = sum(1.0 / (1e-5 + np.linalg.norm(centers[s] - centers[o]))
                            for o in cand if o != s and o not in flagged)
                score = np.sqrt(d_new) * crowd
                if score > best_score:
                    best, best_score = s, score
            if best is None:
                break
            flagged.append(best)
        return flagged

    def _remove_and_marginalize_points(self, stats: solve.BAStats,
                                       marg_slots: List[int]) -> int:
        """Points that lost their residuals or whose host dies: fold the
        well-constrained ones into the prior, drop the rest. Returns the
        number removed."""
        cfg = self.cfg
        p_valid, p_host, res_mask = stats.p_valid, stats.p_host, stats.res_mask
        goners = (np.isin(p_host, marg_slots) & p_valid) \
            | ((res_mask.sum(axis=1) == 0) & p_valid)
        if not goners.any():
            return 0
        # rows the BA tail already retired (junk) count as removed but are
        # not dropped again
        junk = stats.junk
        hdd = stats.idepth_hessian
        # maxRelBaseline gate: only points observed with enough relative
        # baseline × idepth are folded into the prior; the rest drop
        T = np.asarray(stats.poses, dtype=np.float64)
        C = -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])
        dist = np.linalg.norm(C[p_host][:, None, :] - C[None, :, :], axis=-1)
        rel_b = np.max(np.where(res_mask, dist, 0.0), axis=1) * stats.p_idepth
        marg_mask = goners & (hdd > cfg.ba.min_idepth_hessian) \
            & (rel_b > cfg.ba.min_rel_baseline)
        self._archive_map_points(stats, goners & (hdd > cfg.ba.min_idepth_hessian))
        if marg_mask.any():
            self.HM, self.bM = marginal.marginalize_points(
                self.win, marg_mask, self.HM, self.bM, cfg)
        self.win = win_mod.drop_points(self.win, torch.as_tensor(goners & ~junk))
        return int(goners.sum())

    def _archive_map_points(self, stats: solve.BAStats, mask: np.ndarray):
        """Snapshot dying points into the persistent map, in host-camera
        coordinates grouped by host kf_id."""
        if not mask.any():
            return
        uv = stats.p_uv[mask]
        idep = np.maximum(stats.p_idepth[mask], 1e-6)
        color = stats.p_color[mask]
        hosts = stats.p_host[mask]
        fx, fy, cx, cy = (float(v) for v in stats.c)
        z = 1.0 / idep
        xyz = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], axis=-1)
        with self.state_lock:
            for s in np.unique(hosts):
                kid = self.slot_kf[s]
                if kid is None:
                    continue
                m = hosts == s
                prev = self.map_points.get(kid)
                if prev is None:
                    self.map_points[kid] = dict(xyz_cam=xyz[m], color=color[m])
                else:
                    prev["xyz_cam"] = np.concatenate([prev["xyz_cam"], xyz[m]])
                    prev["color"] = np.concatenate([prev["color"], color[m]])

    def global_map_points(self, include_window: bool = True):
        """World point cloud of the persistent map (+ optionally the live
        window), composed through each KF's latest pose-graph-optimized
        Sim3, so positions are always current. Returns (xyz [N,3],
        intensity [N]). In async mode the mapping thread owns the window:
        call this after ``finish_mapping()``."""
        xyz_out, col_out = [], []
        with self.state_lock:
            arch = [(kid, d["xyz_cam"].copy(), d["color"].copy(),
                     self.kfs[kid].S_cw_opti if self.kfs[kid].S_cw_opti
                     is not None else self.kfs[kid].T_cw)
                    for kid, d in self.map_points.items() if kid in self.kfs]
            win = self.win
        for _, xc, col, S_cw in arch:
            S_wc = np.linalg.inv(np.asarray(S_cw, np.float64))
            xyz_out.append(xc @ S_wc[:3, :3].T + S_wc[:3, 3])
            col_out.append(col)
        if include_window:
            # one stacked copy: per point (valid, host, u, v, idepth, color),
            # then the 16 entries of every pose and the 4 intrinsics
            f32 = torch.float32
            snap = torch.cat([
                torch.stack([win.p_valid.to(f32), win.p_host.to(f32), win.p_uv[:, 0],
                             win.p_uv[:, 1], win.p_idepth, win.p_color[:, 4]],
                            dim=1).reshape(-1),
                win.current_pose().reshape(-1), win.c]).cpu().numpy()
            P, F = win.p_valid.shape[0], win.frame_valid.shape[0]
            pts = snap[: 6 * P].reshape(P, 6)
            T_all = snap[6 * P: 6 * P + 16 * F].reshape(F, 4, 4).astype(np.float64)
            fx, fy, cx, cy = (float(v) for v in snap[6 * P + 16 * F:])
            pts = pts[pts[:, 0] > 0]
            if len(pts):
                z = 1.0 / np.maximum(pts[:, 4], 1e-6)
                Xc = np.stack([(pts[:, 2] - cx) / fx * z,
                               (pts[:, 3] - cy) / fy * z, z], -1)
                T = T_all[pts[:, 1].astype(np.int64)]
                xyz_out.append(np.einsum("pji,pj->pi", T[:, :3, :3],
                                         Xc - T[:, :3, 3]))
                col_out.append(pts[:, 5])
        if not xyz_out:
            return np.zeros((0, 3)), np.zeros(0)
        return np.concatenate(xyz_out), np.concatenate(col_out)

    def _marginalize_frame(self, slot: int, stats: solve.BAStats):
        cfg = self.cfg
        kid = self.slot_kf[slot]
        kf = self.kfs[kid]
        T = np.asarray(stats.poses, dtype=np.float64)
        others = sorted((self.slot_kf[s], s) for s in range(len(self.slot_kf))
                        if self.slot_kf[s] is not None and s != slot)
        with self.state_lock:
            kf.T_cw = T[slot]
            kf.in_window = False
            kf.slot = -1
            for okid, oslot in others[: cfg.loop.max_edges_per_kf]:
                self.pose_edges.append(
                    PoseEdge(kid, okid, T[slot] @ np.linalg.inv(T[oslot])))
        aff_prior = np.array([0.0] * 6 + [cfg.ba.affine_prior_a, cfg.ba.affine_prior_b])
        # the diagonal prior pins ABSOLUTE a,b to zero: in delta coordinates
        # its gradient at Δ=0 is λ·x_zero
        aff_delta = np.asarray(stats.x_zero[slot], dtype=np.float64)
        aff_delta[:6] = 0.0
        self.HM, self.bM = marginal.marginalize_frame(
            slot, self.HM, self.bM, frame_prior_diag=aff_prior,
            frame_prior_delta=aff_delta)
        self.win = win_mod.remove_frame(self.win, slot)
        self.slot_kf[slot] = None

    # ------------------------------------------------------------------
    # Immature-point lifecycle
    # ------------------------------------------------------------------

    def _update_min_act_dist(self) -> float:
        """Adaptive activation-spacing ladder (reference: currentMinActDist):
        the radius grows when the window is over-full and shrinks when
        starved. Returns the occupancy-cell size in pixels (2·mad)."""
        cfg = self.cfg
        n_now = float(self._n_active_cache)
        desired = min(cfg.selector.desired_point_density, float(cfg.shapes.max_points))
        mad = self._min_act_dist
        if n_now < desired * 0.66:
            mad -= 0.8
        elif n_now < desired * 0.8:
            mad -= 0.5
        elif n_now < desired * 0.9:
            mad -= 0.2
        if n_now > desired:
            mad += 0.2
        self._min_act_dist = mad = float(np.clip(mad, 0.0, 4.0))
        return 2.0 * mad

    @telemetry.span("seed_select")
    def _dispatch_seed(self, pyr) -> dict:
        return _seed_program(pyr[0], pyr[1], pyr[2], self.cfg,
                             seed=int(self.cfg.seed + (self.frame_count & 3)))

    @telemetry.span("seed_patch")
    def _seed_new_kf(self, slot: int, pyr, seed: Optional[dict] = None):
        """Candidate reseed for a keyframe: scatter the fresh candidates
        into free bank slots."""
        if seed is None:
            seed = self._dispatch_seed(pyr)
        dying = torch.zeros(self.cfg.shapes.max_frames, dtype=torch.bool,
                            device=self.device)
        with self.state_lock:
            bank = self.bank
        drop, slots, s_uv, s_col, s_wgt, s_corner = lifecycle.compute_seed_patch(
            bank, seed, slot, dying, self.cfg)
        self._commit_bank_patch(bank_mod.apply_patch, drop, slots, s_uv, s_col, s_wgt,
                                slot, s_corner)

    # ------------------------------------------------------------------
    # Tracker reference
    # ------------------------------------------------------------------

    @telemetry.span("tracker_ref")
    def _update_tracker_ref(self, kf: KeyframeRecord):
        """Rebuild the tracking reference from the keyframe's window state."""
        uv, idep, color, valid = _project_points_to_slot(self.win, kf.slot)
        new_ref = tracker.make_tracker_ref(
            uv, idep, color, valid, self.cfg.shapes.pyr_levels,
            exposure=self.win.exposure[kf.slot], aff_ab=self.win.x[kf.slot, 6:8])
        T_ref_dev = self.win.current_pose(kf.slot)
        with self.state_lock:     # one swap of the whole bundle
            self.track_ref = new_ref
            self.ref_kf = kf.kf_id
            self._T_ref_cw_np = np.asarray(kf.T_cw, np.float64).copy()
            self._T_ref_cw_dev = T_ref_dev
            self._ref_version += 1
