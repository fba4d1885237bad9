"""Bag-of-binary-words vocabulary + keyframe database.

Port of ``ldso_tpu/loop/bow.py``. The k-ary vocabulary tree is flattened
to dense per-level descriptor tables, so leaf assignment is a
popcount-argmin descent (each descriptor against its node's k children
only, batched over features), and keyframe signatures are dense
L1-normalized tf-idf vectors over the leaves, so database scoring is one
batched reduction instead of an inverted-index walk.

Training (hierarchical k-majority, host numpy) and the DBoW text
converter are framework-neutral and copied from the reference; they
return torch tensors on the requested device. The package tests pin
them to their originals.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ldso_tpu_torch.loop.orb import DESC_BYTES, unpack_bits


class Vocabulary(NamedTuple):
    """Flattened k-ary tree. Level l has k^(l+1) slots (dense, padded):
    node (l, i) has children (l+1, i*k ... i*k+k-1)."""
    tables: Tuple[torch.Tensor, ...]       # per level: u8 [k^(l+1), 32]
    table_valid: Tuple[torch.Tensor, ...]  # per level: bool [k^(l+1)]
    k: int
    levels: int
    idf: torch.Tensor                      # f32 [n_leaves] inverse doc frequency

    @property
    def n_leaves(self) -> int:
        return self.tables[-1].shape[0]


def _kmajority(desc_bits: np.ndarray, k: int, iters: int,
               rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """k-majority clustering of binary descriptors (bits in {0,1} [N, 256]).
    Returns (centers_bits [k, 256], assignment [N])."""
    n = desc_bits.shape[0]
    k_eff = min(k, n)
    centers = desc_bits[rng.choice(n, size=k_eff, replace=False)].copy()
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        # Hamming via dot products
        ab = desc_bits @ centers.T
        d = desc_bits.sum(1, keepdims=True) + centers.sum(1)[None, :] - 2 * ab
        assign = d.argmin(1)
        for c in range(k_eff):
            m = assign == c
            if m.any():
                centers[c] = (desc_bits[m].mean(0) > 0.5).astype(desc_bits.dtype)
            else:  # re-seed empty cluster
                centers[c] = desc_bits[rng.integers(n)]
    if k_eff < k:
        centers = np.concatenate(
            [centers, np.zeros((k - k_eff, desc_bits.shape[1]), desc_bits.dtype)])
    return centers, assign


def _pack(bits: np.ndarray) -> np.ndarray:
    """[..., 256] {0,1} -> u8 [..., 32]."""
    b = bits.reshape(*bits.shape[:-1], DESC_BYTES, 8).astype(np.uint8)
    w = np.asarray([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)
    return (b * w).sum(-1).astype(np.uint8)


def _to_vocab(tables, valids, k: int, levels: int, idf: np.ndarray,
              device) -> Vocabulary:
    return Vocabulary(
        tables=tuple(torch.as_tensor(t, device=device) for t in tables),
        table_valid=tuple(torch.as_tensor(v, device=device) for v in valids),
        k=k, levels=levels, idf=torch.as_tensor(idf, device=device))


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     iters: int = 8, seed: int = 0,
                     max_train: int = 60000, *, device) -> Vocabulary:
    """Hierarchical k-majority tree (reference: DBoW3 Vocabulary::create
    with k=10, L=5; defaults here are smaller because the vocabulary is
    trained per-corpus rather than on millions of externals)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, dtype=np.uint8).reshape(-1, DESC_BYTES)
    if len(desc) > max_train:
        desc = desc[rng.choice(len(desc), size=max_train, replace=False)]
    bits = np.unpackbits(desc, axis=-1, bitorder="little").astype(np.float32)

    tables: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    # node assignment of every training descriptor at the current level
    groups = {0: np.arange(len(bits))}
    for l in range(levels):
        n_slots = k ** (l + 1)
        table = np.zeros((n_slots, bits.shape[1]), dtype=np.float32)
        valid = np.zeros(n_slots, dtype=bool)
        new_groups = {}
        for node, idx in groups.items():
            if len(idx) == 0:
                continue
            centers, assign = _kmajority(bits[idx], k, iters, rng)
            for c in range(k):
                slot = node * k + c
                table[slot] = centers[c]
                members = idx[assign == c]
                valid[slot] = len(members) > 0 or len(idx) >= k
                new_groups[slot] = members
        tables.append(_pack(table))
        valids.append(valid)
        groups = new_groups

    # idf over training corpus treating each descriptor as one "document hit"
    leaf_counts = np.zeros(k ** levels, dtype=np.float64)
    for slot, idx in groups.items():
        leaf_counts[slot] = len(idx)
    n_total = max(leaf_counts.sum(), 1.0)
    idf = np.log(n_total / np.maximum(leaf_counts, 1.0)).astype(np.float32)
    return _to_vocab(tables, valids, k, levels, idf, device)


def _assign_leaves(desc, valid, tables, table_valids, k: int, levels: int):
    """[N, 32] descriptors -> (leaf ids [N], node path [N, levels]).

    Per level, each descriptor is compared against ONLY its current
    node's k children (one gather of [N, k, 32] + a popcount) — cost
    O(N·k·levels), depth-scaled like the reference's DBoW3 descent.
    Ties go to the first child (torch.argmin, as jnp.argmin)."""
    N = desc.shape[0]
    dev = desc.device
    bits = unpack_bits(desc)                                 # [N, 256] f32
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    kk = torch.arange(k, device=dev)
    rows_i = torch.arange(N, device=dev)
    path = []
    for l in range(levels):
        child = node[:, None] * k + kk[None, :]              # [N, k]
        crows = unpack_bits(tables[l][child].reshape(N * k, -1)).reshape(N, k, -1)
        ab = torch.einsum("nb,nkb->nk", bits, crows)
        d = torch.sum(bits, dim=-1)[:, None] + torch.sum(crows, dim=-1) - 2.0 * ab
        d = torch.where(table_valids[l][child], d, torch.full_like(d, 1e9))
        node = child[rows_i, torch.argmin(d, dim=1)]
        path.append(node)
    return node.to(torch.int32), torch.stack(path, dim=-1).to(torch.int32)


def assign_leaves(vocab: Vocabulary, desc, valid):
    return _assign_leaves(desc, valid, vocab.tables, vocab.table_valid,
                          vocab.k, vocab.levels)


def _bow_vector(leaves, valid, idf, n_leaves: int):
    w = torch.where(valid, idf[leaves.long()], torch.zeros((), dtype=idf.dtype,
                                                          device=idf.device))
    v = torch.zeros(n_leaves, dtype=torch.float32, device=idf.device)
    v = v.index_add(0, leaves.long(), w)
    n = torch.sum(torch.abs(v))
    return v / torch.clamp(n, min=1e-12)


def bow_vector(vocab: Vocabulary, desc, valid) -> torch.Tensor:
    """Dense L1-normalized tf-idf signature [n_leaves]."""
    leaves, _ = assign_leaves(vocab, desc, valid)
    return _bow_vector(leaves, valid, vocab.idf, vocab.n_leaves)


def l1_score(va, vb):
    """DBoW L1 similarity in [0, 1]: 1 − ½‖va − vb‖₁ (for L1-normalized
    vectors). Batched over vb's leading axis if 2D."""
    if vb.ndim == 2:
        return 1.0 - 0.5 * torch.sum(torch.abs(va[None, :] - vb), dim=-1)
    return 1.0 - 0.5 * torch.sum(torch.abs(va - vb))


@dataclasses.dataclass
class KeyframeDatabase:
    """BoW database over keyframes (reference: DBoW3::Database + the
    kfDB usage in LoopClosing::DetectLoop). Signatures are device
    vectors stacked at query time; a query is one batched reduction."""

    vocab: Vocabulary

    def __post_init__(self):
        self._vecs: List[torch.Tensor] = []
        self._kf_ids: List[int] = []
        self._id_set: set = set()

    def add(self, kf_id: int, bow_vec) -> None:
        """Idempotent per kf_id: a vocabulary swap landing mid-detection
        can try to insert the in-flight keyframe twice (once from the
        retrain backfill, once from the detection tail)."""
        if kf_id in self._id_set:
            return
        self._vecs.append(bow_vec)
        self._kf_ids.append(kf_id)
        self._id_set.add(kf_id)

    def __len__(self) -> int:
        return len(self._kf_ids)

    def query(self, bow_vec, exclude_above: Optional[int] = None):
        """Scores vs every stored KF; returns (kf_ids [K], scores [K]) as
        numpy. `exclude_above`: ignore KFs with id >= this (skip recent
        window)."""
        if not self._vecs:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        ids = np.asarray(self._kf_ids)
        scores = l1_score(bow_vec, torch.stack(self._vecs)).cpu().numpy()
        if exclude_above is not None:
            keep = ids < exclude_above
            ids, scores = ids[keep], scores[keep]
        return ids, scores


# ---------------------------------------------------------------------------
# DBoW text-format converter
# ---------------------------------------------------------------------------
#
# The public ORB vocabularies (ORBvoc.txt of ORB-SLAM2) use the DBoW2/3
# text format:
#   line 0:  k L scoring_type weighting_type
#   line i:  parent_id is_leaf b0 b1 ... b31 weight
# with nodes listed so that node ids are 1..N in file order, node 0 the
# implicit root, `parent_id` a file node id, and `weight` the tf-idf
# weight of leaves. The loader folds that pointer tree into this
# module's dense per-level table layout (node (l, i) has children
# (l+1, i*k .. i*k+k-1)); sub-branching nodes are padded invalid and
# early leaves are propagated down a single-child chain to the leaf
# level so every descriptor resolves to one final-level leaf.


def load_vocabulary_text(text: str, truncate_levels: Optional[int] = None, *,
                         device) -> Vocabulary:
    """Parse a DBoW2/DBoW3 text vocabulary into a :class:`Vocabulary`.

    ``truncate_levels``: cap the tree depth (public ORB vocabs are
    k=10, L=6 → 10⁶ leaves; the dense-signature pipeline wants ≤ ~10⁴
    leaves, so L is typically truncated to 3-4; truncated subtrees
    become leaves carrying their subtree's summed weight)."""
    lines = [l.split() for l in text.strip().splitlines() if l.strip()]
    k, L_file = int(lines[0][0]), int(lines[0][1])
    L = min(L_file, truncate_levels) if truncate_levels else L_file
    n = len(lines) - 1
    parent = np.zeros(n + 1, np.int64)
    is_leaf = np.zeros(n + 1, bool)
    desc = np.zeros((n + 1, DESC_BYTES), np.uint8)
    weight = np.zeros(n + 1, np.float64)
    children: dict = {}
    for i, row in enumerate(lines[1:], start=1):
        parent[i] = int(row[0])
        is_leaf[i] = bool(int(float(row[1])))
        desc[i] = np.asarray([int(float(x)) for x in row[2:2 + DESC_BYTES]],
                             np.uint8)
        weight[i] = float(row[2 + DESC_BYTES])
        children.setdefault(int(row[0]), []).append(i)

    def subtree_weight(node: int) -> float:
        kids = children.get(node, [])
        if not kids:
            return float(weight[node])
        return float(sum(subtree_weight(c) for c in kids))

    tables = [np.zeros((k ** (l + 1), 8 * DESC_BYTES), np.float32)
              for l in range(L)]
    valids = [np.zeros(k ** (l + 1), bool) for l in range(L)]
    idf = np.zeros(k ** L, np.float64)

    def bits(d: np.ndarray) -> np.ndarray:
        return np.unpackbits(d, bitorder="little").astype(np.float32)

    def place_leaf(lvl: int, didx: int, node: int, w: float) -> None:
        """Propagate a leaf down a child-0 chain to the final level."""
        dd = didx
        for l2 in range(lvl + 1, L):
            dd = dd * k
            tables[l2][dd] = bits(desc[node])
            valids[l2][dd] = True
        idf[dd] = w             # dd == didx when the leaf is final-level

    stack = [(0, -1, 0)]        # (file node, level, dense index)
    while stack:
        fnode, lvl, didx = stack.pop()
        for ci, kid in enumerate(children.get(fnode, [])[:k]):
            kd = didx * k + ci
            tables[lvl + 1][kd] = bits(desc[kid])
            valids[lvl + 1][kd] = True
            if lvl + 1 == L - 1 or is_leaf[kid] or kid not in children:
                place_leaf(lvl + 1, kd, kid,
                           subtree_weight(kid) if lvl + 1 < L_file else
                           float(weight[kid]))
            else:
                stack.append((kid, lvl + 1, kd))

    return _to_vocab([_pack(t) for t in tables], valids, k, L,
                     idf.astype(np.float32), device)


def save_vocabulary_text(vocab: Vocabulary) -> str:
    """Serialize to the DBoW text format (round-trips with the loader;
    also lets a trained vocabulary be inspected with DBoW tooling)."""
    k, L = vocab.k, vocab.levels
    lines = [f"{k} {L} 0 0"]
    file_id = {(-1, 0): 0}      # (level, dense idx) -> file node id
    next_id = 1
    idf = vocab.idf.cpu().numpy()
    for l in range(L):
        tab = vocab.tables[l].cpu().numpy()
        val = vocab.table_valid[l].cpu().numpy()
        for i in np.flatnonzero(val):
            file_id[(l, int(i))] = next_id
            parent = file_id[(l - 1, int(i) // k)]
            leaf = 1 if l == L - 1 else 0
            w = float(idf[int(i)]) if leaf else 0.0
            d = " ".join(str(int(b)) for b in tab[int(i)])
            lines.append(f"{parent} {leaf} {d} {w:.6f}")
            next_id += 1
    return "\n".join(lines) + "\n"
