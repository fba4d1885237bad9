"""Loop detection + correction orchestration, inline or on a worker.

Port of ``LoopClosing`` and ``AsyncLoopClosing`` from
``ldso_tpu/loop/closing.py``: the host conductor is called once per
keyframe (``LoopClosing`` processes it inline, ``AsyncLoopClosing``
snapshots it and processes it on its own thread), and every numeric stage runs as
torch on the system's device — feature detection, BoW assignment and
scoring, Hamming matching, batched Sim3/PnP RANSAC, GN refine and the
CG pose graph. The vocabulary is trained lazily from the first
keyframes and retrained at larger tree sizes on a background thread;
detection never waits for a retrain.

Point depth for matched features comes from the engine at keyframe time:
each KF snapshot transfers the depth of the nearest well-constrained
active point (or converged immature candidate) to every corner feature.

Hypothesis sampling draws from a ``torch.Generator`` on the system's
device, seeded from ``cfg.seed`` (the reference splits a
``jax.random`` key per draw).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import traceback
from typing import List, Optional

import numpy as np
import torch

from ldso_tpu_torch import trace as trace_mod
from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.loop import bow, match, orb, posegraph, sim3
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.system import PoseEdge, _project_points_to_slot


@dataclasses.dataclass
class KFSnapshot:
    """Per-keyframe loop-closure payload (reference: Frame's features,
    bowVec, and the depth its corners inherit from nearby points)."""

    kf_id: int
    feats: orb.Features                # device tensors
    bow_vec: Optional[torch.Tensor]    # None until the vocabulary exists
    # features with depth (camera-frame 3D), for geometric verification
    X_cam: np.ndarray                  # [N, 3]
    has_depth: np.ndarray              # bool [N]
    n_valid: int = 0                   # valid features (host copy)


def _assign_depth(feat_uv: np.ndarray, pt_uv: np.ndarray,
                  pt_idepth: np.ndarray, pt_valid: np.ndarray,
                  intr, max_px: float = 8.0):
    """Nearest-active-point depth transfer to corner features."""
    n = feat_uv.shape[0]
    X = np.zeros((n, 3), np.float64)
    ok = np.zeros(n, bool)
    pu = pt_uv[pt_valid]
    pd = pt_idepth[pt_valid]
    if len(pu) == 0:
        return X, ok
    d2 = ((feat_uv[:, None, :] - pu[None, :, :]) ** 2).sum(-1)
    j = d2.argmin(1)
    near = np.sqrt(d2[np.arange(n), j]) < max_px
    idep = np.maximum(pd[j], 1e-6)
    fx, fy, cx, cy = (float(v) for v in intr)
    z = 1.0 / idep
    X[:, 0] = (feat_uv[:, 0] - cx) / fx * z
    X[:, 1] = (feat_uv[:, 1] - cy) / fy * z
    X[:, 2] = z
    ok = near
    return X, ok


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class LoopClosing:
    """Host conductor for loop closure; attach with
    ``system.on_keyframe = lc.on_keyframe`` and ``system.loop_closing = lc``.
    It runs on the attached system's device. A ``vocab`` handed in must
    already live there."""

    def __init__(self, cfg: LdsoConfig, intr,
                 vocab: Optional[bow.Vocabulary] = None,
                 train_after: int = 8):
        self.cfg = cfg
        self.intr = np.asarray(intr, np.float32)
        self.vocab = vocab
        self.train_after = train_after
        self.device: Optional[torch.device] = None
        self.db: Optional[bow.KeyframeDatabase] = (
            bow.KeyframeDatabase(vocab) if vocab is not None else None)
        self.snapshots: dict[int, KFSnapshot] = {}
        self.loops_closed: List[tuple] = []    # (kf_cur, kf_cand, S_cur_cand)
        # consistency groups (reference: DetectLoop's mvConsistentGroups —
        # MULTIPLE concurrent groups, each the covisible region of a past
        # candidate with the length of the chain of consecutive recent
        # KFs that proposed an overlapping region)
        self._consistent_groups: List[tuple] = []   # (frozenset[kf_id], count)
        self.rejected: List[dict] = []         # gate decisions (diagnostics)
        self._trained_on = 0                   # descriptor count at last train
        self._gen: Optional[torch.Generator] = None
        self._intr_t: Optional[torch.Tensor] = None
        # vocabulary swap guard: retrains run on a background thread and
        # swap (vocab, db, snapshot signatures) atomically under this lock
        self._vocab_lock = threading.Lock()
        self._retrain_thread: Optional[threading.Thread] = None
        # failed background retrains, (exc_name, traceback) — surfaced to
        # callers instead of silently keeping the old tree
        self.retrain_errors: List[tuple] = []

    # ------------------------------------------------------------------

    def _bind_device(self, system) -> None:
        """The system's device, a generator and the intrinsics tensor
        there, at first use."""
        if self.device is None:
            self.device = system.device
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(self.cfg.seed))
            self._intr_t = torch.as_tensor(self.intr, device=self.device)

    def on_keyframe(self, system, kf, pyr) -> Optional[dict]:
        """Per-new-KF hook (reference: InsertKeyFrame + Run loop body):
        detect + close inline."""
        return self._process(*self._snapshot(system, kf, pyr))

    @staticmethod
    def _snapshot(system, kf, pyr) -> tuple:
        """What ``_process`` reads of the engine, taken at keyframe time:
        the keyframe's finest level, the window, its slot, the bank and
        the idepth Hessians of the BA that just ran."""
        return (system, kf, pyr[0], system.win, kf.slot, system.bank,
                system.last_idepth_hessian)

    @staticmethod
    def _immature_depth_sources(win, bank, slot):
        """Project converged immature candidates into ``slot``'s frame —
        extra (uv, idepth) depth sources for feature-depth transfer (the
        reference reads immature AND active depths around each corner;
        active points alone starve the transfer on low-parallax legs)."""
        v = _np(bank.valid)
        st = _np(bank.last_status)
        d_min = _np(bank.idepth_min)
        d_max = _np(bank.idepth_max)
        mid = 0.5 * (d_min + d_max)
        conv = (v & (st == trace_mod.GOOD) & np.isfinite(d_max)
                & (mid > 1e-4) & ((d_max - d_min) < 0.1 * np.maximum(mid, 1e-4)))
        if not conv.any():
            return np.zeros((0, 2), np.float32), np.zeros(0, np.float32)
        host = _np(bank.host_slot)[conv]
        uv = _np(bank.uv)[conv]
        d0 = mid[conv]
        T = _np(win.current_pose()).astype(np.float64)
        fx, fy, cx, cy = (float(x) for x in _np(win.c))
        T_rel = np.einsum("ij,pjk->pik", T[slot], np.linalg.inv(T)[host])
        xh = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                       np.ones(len(uv))], axis=-1)
        Xc = np.einsum("pij,pj->pi", T_rel[:, :3, :3], xh) \
            + T_rel[:, :3, 3] * d0[:, None]
        z = Xc[:, 2]
        okz = z > 1e-6
        zs = np.where(okz, z, 1.0)
        uvn = np.stack([fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy],
                       axis=-1).astype(np.float32)
        return uvn[okz], (d0 / zs)[okz].astype(np.float32)

    def _detect(self, img3) -> orb.Features:
        return orb.detect(img3, max_features=self.cfg.loop.max_features,
                          fast_th=self.cfg.loop.orb_fast_th)

    def _process(self, system, kf, pyr0, win, slot, bank, hdd) -> Optional[dict]:
        cfg = self.cfg
        self._bind_device(system)
        feats = self._detect(pyr0)
        uv_np = _np(feats.uv)
        pt_uv, pt_idep, _, pt_valid = (_np(a) for a in _project_points_to_slot(win, slot))
        # only WELL-CONSTRAINED depths may back loop geometry: points
        # whose idepth Hessian is weak (low-parallax, e.g. a distant
        # backdrop) carry map-inconsistent depths that poison the Sim3
        # scale estimate (reference: idepth_hessian gates throughout)
        if hdd is not None and len(hdd) == len(pt_valid):
            pt_valid = pt_valid & (hdd > 20.0 * cfg.ba.min_idepth_hessian)
        pt_uv, pt_idep = pt_uv[pt_valid], pt_idep[pt_valid]
        im_uv, im_idep = self._immature_depth_sources(win, bank, slot)
        pt_uv = np.concatenate([pt_uv, im_uv])
        pt_idep = np.concatenate([pt_idep, im_idep])
        pt_valid = np.ones(len(pt_uv), bool)
        X, ok = _assign_depth(uv_np, pt_uv, pt_idep, pt_valid, self.intr)
        f_valid = _np(feats.valid)
        ok &= f_valid
        snap = KFSnapshot(kf.kf_id, feats, None, X, ok, int(f_valid.sum()))
        with self._vocab_lock:       # retrain thread iterates snapshots
            self.snapshots[kf.kf_id] = snap

        # lazily train the vocabulary once enough descriptors exist, and
        # RETRAIN at a larger tree size as the corpus grows (8³ → 10³ →
        # 10⁴ → 10⁵ leaves). The FIRST train is synchronous (nothing to
        # detect with until it exists); every ladder retrain runs on a
        # background thread and swaps in atomically — detection
        # continues on the old tree
        if self.vocab is None:
            if len(self.snapshots) >= self.train_after:
                self._train_vocab()
            return None
        with self._vocab_lock:
            n_desc = sum(s.n_valid for s in self.snapshots.values())
        if n_desc >= 4 * max(self._trained_on, 1) \
                and self._vocab_shape(n_desc) != (self.vocab.k, self.vocab.levels):
            self._start_retrain()

        with self._vocab_lock:
            vocab, db = self.vocab, self.db
        snap.bow_vec = bow.bow_vector(vocab, feats.desc, feats.valid)
        result = self._detect_and_close(system, kf, snap)
        with self._vocab_lock:
            if self.db is db:                  # no swap since the query
                db.add(kf.kf_id, snap.bow_vec)
            else:                              # swapped mid-detection:
                snap.bow_vec = bow.bow_vector(  # re-encode with the new tree
                    self.vocab, feats.desc, feats.valid)
                self.db.add(kf.kf_id, snap.bow_vec)
        if result is not None and not result.get("accepted", False):
            self.rejected.append(result)
        return result

    @staticmethod
    def _vocab_shape(n_desc: int):
        """(k, levels) ladder by corpus size — larger corpora earn finer
        trees (reference vocabulary: k=10, L=5/6 ≈ 10⁵-10⁶ leaves,
        trained on millions of descriptors)."""
        if n_desc >= 300_000:
            return 10, 5            # 10⁵ leaves (KITTI-00 scale)
        if n_desc >= 30_000:
            return 10, 4            # 10⁴ leaves
        if n_desc >= 5_000:
            return 10, 3            # 10³ leaves
        return 8, 3                 # 512 leaves (small-corpus bootstrap)

    @staticmethod
    def _collect_descs(snaps):
        descs, valids = [], []
        for s in snaps:
            descs.append(_np(s.feats.desc))
            valids.append(_np(s.feats.valid))
        return np.concatenate(descs)[np.concatenate(valids)]

    def _train_vocab(self):
        """Train + re-encode + atomic swap (called synchronously for the
        first train, from the retrain thread afterwards)."""
        # snapshot list copied UNDER the lock: the detection thread
        # inserts concurrently
        with self._vocab_lock:
            snaps = sorted(self.snapshots.values(), key=lambda x: x.kf_id)
        d = self._collect_descs(snaps)
        k, levels = self._vocab_shape(len(d))
        vocab = bow.train_vocabulary(d, k=k, levels=levels, seed=self.cfg.seed,
                                     device=self.device)
        db = bow.KeyframeDatabase(vocab)
        encoded = {}
        for s in snaps:
            encoded[s.kf_id] = bow.bow_vector(vocab, s.feats.desc, s.feats.valid)
            db.add(s.kf_id, encoded[s.kf_id])
        with self._vocab_lock:
            # snapshots that arrived during the (background) train get
            # re-encoded here — a handful, not the whole map
            for s in list(self.snapshots.values()):
                if s.kf_id not in encoded and s.bow_vec is not None:
                    encoded[s.kf_id] = bow.bow_vector(vocab, s.feats.desc, s.feats.valid)
                    db.add(s.kf_id, encoded[s.kf_id])
            self.vocab, self.db = vocab, db
            self._trained_on = len(d)
            for kid, vec in encoded.items():
                if kid in self.snapshots:
                    self.snapshots[kid].bow_vec = vec

    def _start_retrain(self):
        """Ladder retrain on a background thread; atomic swap at the end."""
        if self._retrain_thread is not None and self._retrain_thread.is_alive():
            return

        def worker():
            try:
                self._train_vocab()   # trains + re-encodes + atomic swap
            except Exception as e:    # a failed retrain keeps the old tree,
                # and is recorded, not swallowed
                self.retrain_errors.append((type(e).__name__, traceback.format_exc()))

        self._retrain_thread = threading.Thread(
            target=worker, name="ldso-vocab-retrain", daemon=True)
        self._retrain_thread.start()

    def finish_retrain(self):
        """Block until a background retrain completes (tests/shutdown)."""
        t = self._retrain_thread
        if t is not None:
            t.join(timeout=120.0)

    # ------------------------------------------------------------------

    def _detect_and_close(self, system, kf, snap) -> Optional[dict]:
        """reference: DetectLoop + CorrectLoop."""
        cfg = self.cfg
        if len(self.db) == 0:
            return None
        ids, scores = self.db.query(snap.bow_vec,
                                    exclude_above=kf.kf_id - cfg.loop.min_kf_gap)
        if len(ids) == 0:
            return None
        # covisible-group score floor (reference: DetectLoop computes
        # minScore as the MINIMUM BoW similarity between the current KF
        # and its covisible neighbors — here the odometry window — and
        # only candidates scoring above it survive)
        with system.state_lock:
            win_ids = [k for k in system.slot_kf if k is not None and k != kf.kf_id]
        neigh_vecs = [self.snapshots[k].bow_vec for k in win_ids
                      if k in self.snapshots and self.snapshots[k].bow_vec is not None]
        if not neigh_vecs:
            prev = self.snapshots.get(kf.kf_id - 1)
            if prev is not None and prev.bow_vec is not None:
                neigh_vecs = [prev.bow_vec]
        ref_score = 0.1
        if neigh_vecs:
            sc = _np(bow.l1_score(snap.bow_vec, torch.stack(neigh_vecs)))
            ref_score = float(sc.min())
        th = max(0.05, cfg.loop.min_score_rel * ref_score)
        order = np.argsort(-np.asarray(scores))
        cands = [(int(ids[i]), float(scores[i])) for i in order[:5] if scores[i] >= th]
        if not cands:
            self._consistent_groups = []
            return None
        # consistency groups (reference: DetectLoop's mvConsistentGroups):
        # EVERY above-threshold candidate's neighborhood (temporally
        # adjacent KF ids — the proxy for its covisible group) extends
        # any overlapping group from previous keyframes; groups not
        # refreshed this round are pruned. A candidate whose chain
        # reaches `consistency_window` earns a geometry check.
        new_groups: List[tuple] = []
        ready: List[tuple] = []
        for cand_id, sc in cands:
            cand_group = frozenset(c for c in range(cand_id - 3, cand_id + 4)
                                   if c in self.snapshots)
            chain = 1
            for grp, cnt in self._consistent_groups:
                if cand_group & grp:
                    chain = max(chain, cnt + 1)
            new_groups.append((cand_group, chain))
            if chain >= cfg.loop.consistency_window:
                ready.append((cand_id, sc, chain))
        self._consistent_groups = new_groups
        if not ready:
            return dict(candidate=cands[0][0], score=cands[0][1], accepted=False,
                        reason="consistency", chain=max(c for _, c in new_groups))

        # geometry-check the matured candidates best-first; the first one
        # that passes closes the loop
        result = None
        for cand_id, sc, _ in ready:
            result = self._geometric_check(system, kf, snap, cand_id, sc)
            if result.get("accepted", False):
                return result
        return result

    def _matches_with_depth(self, feats, cand):
        """Mutual-ratio matches of ``feats`` into candidate ``cand`` whose
        candidate side has depth: (idx_b [N] host, pair mask [N] host)."""
        m = match.match(feats.desc, feats.valid, cand.feats.desc, cand.feats.valid)
        idx_b = _np(m.idx_b)
        return idx_b, _np(m.valid) & cand.has_depth[idx_b]

    def _geometric_check(self, system, kf, snap, cand_id, score):
        """PnP-first geometric verification (reference flow: matched
        candidate 3D points → cv::solvePnPRansac for the SE3 seed, then
        the Sim(3) refine with reprojection residuals on BOTH frames).
        Scale comes from the two-sided-depth subset; with too few such
        pairs the edge falls back to scale 1."""
        cfg = self.cfg
        dev, intr = self.device, self._intr_t
        cand = self.snapshots[cand_id]
        idx_b, pair_pnp = self._matches_with_depth(snap.feats, cand)
        if pair_pnp.sum() < cfg.loop.min_matches:
            return dict(candidate=cand_id, score=score, accepted=False,
                        reason="matches", n=int(pair_pnp.sum()))

        X_a = torch.as_tensor(snap.X_cam, dtype=torch.float32, device=dev)
        uv_a = snap.feats.uv
        X_b = torch.as_tensor(cand.X_cam[idx_b], dtype=torch.float32, device=dev)
        uv_b = cand.feats.uv[torch.as_tensor(idx_b, device=dev).long()]
        pair_pnp_t = torch.as_tensor(pair_pnp, device=dev)

        r = sim3.ransac_pnp(X_b, uv_a, pair_pnp_t, intr, self._gen,
                            n_hyps=cfg.loop.ransac_hypotheses,
                            threshold=cfg.loop.ransac_threshold)
        if int(r.n_inliers) < cfg.loop.min_inliers:
            return dict(candidate=cand_id, score=score, accepted=False,
                        reason="ransac", n_inliers=int(r.n_inliers))

        # Sim3 refine over the two-sided-depth inlier subset
        pair_both = pair_pnp & snap.has_depth
        two_sided = _np(r.inliers) & pair_both
        if two_sided.sum() >= max(8, cfg.loop.min_inliers // 2):
            rf = sim3.refine_sim3(r.S_ab, X_a, uv_a, X_b, uv_b,
                                  torch.as_tensor(two_sided, device=dev),
                                  torch.as_tensor(pair_both, device=dev), intr,
                                  iters=cfg.loop.sim3_iterations)
            if int(rf.n_inliers) < max(6, cfg.loop.min_inliers // 2):
                return dict(candidate=cand_id, score=score, accepted=False,
                            reason="refine", n_inliers=int(rf.n_inliers))
        else:
            # scale-1 fallback: refine the SE3 on the PnP inliers
            rf = sim3.refine_pnp(r.S_ab, X_b, uv_a, r.inliers, pair_pnp_t, intr,
                                 iters=cfg.loop.sim3_iterations)
            if int(rf.n_inliers) < cfg.loop.min_inliers:
                return dict(candidate=cand_id, score=score, accepted=False,
                            reason="refine", n_inliers=int(rf.n_inliers))

        # S_cur_cand maps candidate-camera points into current camera:
        # as a pose constraint, S_cur_w = S_cur_cand · S_cand_w
        S_cur_cand = _np(rf.S_ab).astype(np.float64)
        with system.state_lock:
            system.pose_edges.append(PoseEdge(
                kf.kf_id, cand_id, S_cur_cand, kind="loop",
                scale=float(np.linalg.norm(S_cur_cand[0, :3]))))
        self.loops_closed.append((kf.kf_id, cand_id, S_cur_cand))
        self._consistent_groups = []

        self.run_pose_graph(system)
        return dict(candidate=cand_id, score=score, accepted=True,
                    n_inliers=int(rf.n_inliers))

    # ------------------------------------------------------------------

    def relocalize(self, system, pyr) -> Optional[dict]:
        """Lost-tracking recovery: BoW query against the whole KF database,
        geometric (PnP) verification against the best candidates, and
        re-anchoring of the tracker on the first that passes."""
        cfg = self.cfg
        if self.vocab is None or len(self.db) == 0:
            return None
        self._bind_device(system)
        dev, intr = self.device, self._intr_t
        feats = self._detect(pyr[0])
        bv = bow.bow_vector(self.vocab, feats.desc, feats.valid)
        ids, scores = self.db.query(bv)
        if len(ids) == 0:
            return None
        order = np.argsort(-scores)[:3]
        for oi in order:
            cand_id = int(ids[oi])
            cand = self.snapshots.get(cand_id)
            if cand is None or not cand.has_depth.any():
                continue
            idx_b, pair_ok = self._matches_with_depth(feats, cand)
            if pair_ok.sum() < cfg.loop.min_matches:
                continue
            # 2D-3D: candidate's 3D points observed in the lost frame
            X_b = torch.as_tensor(cand.X_cam[idx_b], dtype=torch.float32, device=dev)
            uv_a = feats.uv
            pair_ok_t = torch.as_tensor(pair_ok, device=dev)
            r = sim3.ransac_pnp(X_b, uv_a, pair_ok_t, intr, self._gen,
                                n_hyps=cfg.loop.ransac_hypotheses,
                                threshold=cfg.loop.ransac_threshold * 2)
            if int(r.n_inliers) < cfg.loop.min_inliers:
                continue
            rf = sim3.refine_pnp(r.S_ab, X_b, uv_a, r.inliers, pair_ok_t, intr,
                                 iters=cfg.loop.sim3_iterations)
            if int(rf.n_inliers) < cfg.loop.min_inliers:
                continue
            S_cur_cand = _np(lie.sim3_to_se3(rf.S_ab)).astype(np.float64)
            T_cw = S_cur_cand @ system.kfs[cand_id].T_cw
            return dict(kf_id=cand_id, T_cw=T_cw, n_inliers=int(rf.n_inliers))
        return None

    def run_pose_graph(self, system) -> None:
        """reference: Map::OptimizeALLKFs — window KFs + first KF fixed;
        optimized Sim3 poses written back to the (out-of-window) KF
        registry only. Snapshot under the system state lock; optimize
        lock-free; write back under the lock, skipping any KF that
        (re-)entered the window meanwhile."""
        cfg = self.cfg
        with system.state_lock:
            kf_ids = sorted(system.kfs.keys())
            if len(kf_ids) < 3:
                return
            kf_index = {k: i for i, k in enumerate(kf_ids)}
            K = len(kf_ids)
            S = np.stack([np.asarray(system.kfs[k].T_cw, np.float64) for k in kf_ids])
            fixed = np.zeros(K, bool)
            fixed[0] = True
            for k in kf_ids:
                if system.kfs[k].in_window:
                    fixed[kf_index[k]] = True
            edges = list(system.pose_edges)

        # static edge capacity: next power of two over the edge count
        n_e = len(edges)
        cap = 1 << max(4, (n_e - 1).bit_length())
        ei, ej, S_meas, w = posegraph.build_edges(edges, kf_index, cap)
        dev = self.device
        out = posegraph.optimize_pose_graph(
            torch.as_tensor(S, device=dev), torch.as_tensor(ei, device=dev),
            torch.as_tensor(ej, device=dev), torch.as_tensor(S_meas, device=dev),
            torch.as_tensor(w, device=dev), torch.as_tensor(fixed, device=dev),
            lm_iters=cfg.loop.pgo_iterations)
        S_opt = _np(out.S)
        T_opt = _np(lie.sim3_to_se3(out.S))
        with system.state_lock:
            for k in kf_ids:
                i = kf_index[k]
                if not fixed[i] and not system.kfs[k].in_window:
                    # keep the full Sim3 (scale-aware map consumers) and
                    # its center-preserving SE3 projection for trajectory
                    system.kfs[k].S_cw_opti = S_opt[i].copy()
                    system.kfs[k].T_cw = T_opt[i].astype(np.float64)


class AsyncLoopClosing(LoopClosing):
    """Loop closure on a worker thread: keyframes are snapshotted at the
    mapping boundary (``on_keyframe``) and processed — ORB, BoW, matching,
    Sim3 RANSAC and refine, pose graph — off the tracking and mapping
    path. Write-backs (pose edges, optimized out-of-window KF poses) go
    through ``system.state_lock`` exactly like the synchronous variant.
    An exception of the worker is raised by the next ``on_keyframe`` or
    ``finish``; until then the worker takes no further keyframe, so the
    first cause is the one reported."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._queue: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._busy = False
        self._running = True
        self._exc: Optional[BaseException] = None
        self.results: List[dict] = []
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._worker, name="ldso-loop", daemon=True)
        self._thread.start()

    def _raise_exc(self):
        if self._exc is not None:
            with self._cv:
                exc, self._exc = self._exc, None
                self._cv.notify_all()
            raise exc

    def on_keyframe(self, system, kf, pyr) -> None:
        """Snapshot the engine state now; process it on the worker."""
        self._raise_exc()
        with self._cv:
            self._queue.append(self._snapshot(system, kf, pyr))
            self._cv.notify_all()

    def _worker(self):
        while True:
            with self._cv:
                # an exception not yet handed over holds the queue
                while self._running and (not self._queue or self._exc is not None):
                    self._cv.wait()
                if not self._running:
                    return
                item = self._queue.popleft()
                self._busy = True
            try:
                r = self._process(*item)
                if r is not None:
                    self.results.append(r)
            except Exception as e:        # raised by the next on_keyframe / finish
                self._exc = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def finish(self):
        """Block until the queue has drained (sequence end, tests)."""
        with self._cv:
            while (self._queue or self._busy) and self._exc is None:
                self._cv.wait(0.05)
        self._raise_exc()

    def shutdown(self):
        """``finish``, then stop the worker."""
        if self._thread is None:
            return
        try:
            self.finish()
        finally:
            with self._cv:
                self._running = False
                self._queue.clear()
                self._cv.notify_all()
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("the loop-closure thread did not stop")
            self._thread = None
