#!/usr/bin/env python3
"""How torch sums the small matrix products of the slot tables on a device,
read off its results: for each product and each slot count F = 1..32, which
order gives torch's own result bit for bit, against the order the hand
kernels write out (``ldso_tpu_torch/csrc/lie.cuh``'s ``Rules``).

    python3 scripts/torch_table_rules.py [--device cuda|cpu]

The orders (``tests/table_replay.dot``): "seq" rounds each product and
sum, "fma" chains fused multiply-adds in index order from zero, "split"
sums terms 0-1 and the rest in two such chains, then adds. Each product is
taken on torch's own operands (random poses of rotations of about 1 rad, a
seed per F), as the plain versions form it: se3_exp's K K and V rho, the
exponential times T_eval, se3_inverse's R^T t, the activation's einsum
"fij,hjk->fhik" and K4's "tij,hjk->htik" of T_all and its inverse, the
adjoint's hat(t) R, and the trace's T_new_cw @ T_all^-1. A line per product
lists the slot counts each order matches; a product whose order at some F
is not the kernels' is listed as a mismatch (the kernels' tables then part
from the plain versions' there). Then the motion prediction's (K7,
``csrc/predict.cu``) products and reductions of one pose, each on 256
random operands: se3_inverse's R^T t, the product of two poses,
so3_left_jacobian's K K, torch.sum of three squares and torch.linalg.norm
of a quaternion, against lie.cuh's ``OneRules`` and ``log34`` (``PREDICT``).
Runs on the card (``--device cuda``, the default) or on this CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

MODES = ("seq", "fma", "split")
# lie.cuh's Rules: the order each product takes at F slots on the card
KERNEL = {"KK": lambda F: "split" if F == 1 else "fma", "Vrho": lambda F: "split",
          "ET": lambda F: "split" if F == 1 else "fma",
          "inv": lambda F: "split" if F == 1 else "fma",
          "rel_act": lambda F: "split" if F <= 4 else "fma",
          "rel_ba": lambda F: "split" if F <= 4 else "fma",
          "adj": lambda F: "split" if F == 1 else "fma",
          "hn": lambda F: "split" if F == 1 else "fma"}


def _products(F: int, dev) -> dict:
    """{name: (torch's result, [(a, b), ...] per entry as the kernels'
    dot product takes them)} for one random window of F slots."""
    import numpy as np
    import torch

    from ldso_tpu_torch.math import lie

    rng = np.random.default_rng(F)
    f32 = dict(dtype=torch.float32, device=dev)

    def pose(n):
        return lie.se3_exp(torch.as_tensor(np.concatenate(
            [rng.normal(size=(n, 3)), rng.normal(size=(n, 3))], 1), **f32))

    T_eval, T_all, Tn = pose(F), pose(F), pose(1)[0]
    xi = torch.as_tensor(rng.normal(size=(F, 6)), **f32)
    rho, phi = xi[:, :3], xi[:, 3:]
    K = lie.hat(phi)
    V = lie.so3_left_jacobian(phi)
    E = lie.se3_exp(xi)
    inv = lie.se3_inverse(T_all)
    R, t = T_all[:, :3, :3], T_all[:, :3, 3]
    rel = torch.einsum("fij,hjk->fhik", T_all, inv)
    ht = lie.hat(rel[..., :3, 3])
    unit = torch.tensor([0.0, 0.0, 0.0, 1.0], **f32)
    out = {
        "KK": (K @ K, lambda i, k: [(K[:, i, j], K[:, j, k]) for j in range(3)], 3, 3),
        "Vrho": (V @ rho[..., None],
                 lambda i, k: [(V[:, i, j], rho[:, j]) for j in range(3)], 3, 1),
        "ET": (lie.se3_mul(E, T_eval),
               lambda i, k: [(E[:, i, j], T_eval[:, j, k]) for j in range(4)], 4, 4),
        "inv": (R.transpose(-1, -2) @ t[..., None],
                lambda i, k: [(R[:, j, i], t[:, j]) for j in range(3)], 3, 1),
        "rel_act": (rel, lambda i, k: [(T_all[:, None, i, j], inv[None, :, j, k])
                                       for j in range(3)]
                    + [(T_all[:, None, i, 3], unit[k])], 4, 4),
        "rel_ba": (torch.einsum("tij,hjk->htik", T_all, inv),
                   lambda i, k: [(T_all[None, :, i, j], inv[:, None, j, k]) for j in range(3)]
                   + [(T_all[None, :, i, 3], unit[k])], 4, 4),
        "adj": (ht @ rel[..., :3, :3],
                lambda i, k: [(ht[..., i, j], rel[..., j, k]) for j in range(3)], 3, 3),
        "hn": (Tn @ inv, lambda i, k: [(Tn[i, j], inv[:, j, k]) for j in range(3)]
               + [(Tn[i, 3], unit[k])], 4, 4),
    }
    return out


# the motion prediction's products and reductions of one pose (lie.cuh's
# OneRules and log34): the order each takes on the card
PREDICT = {"inv1": "split", "mul1": "split", "kk1": "split", "sum3": "x0x2", "norm4": "tree2"}
# the orders of a torch.sum of 3 rounded squares and of the 4 of
# torch.linalg.norm: "seq" adds in index order, "x0x2" (x0 + x2) + x1,
# "tree" (x0 + x1) + (x2 + x3), "tree2" (x0 + x2) + (x1 + x3); "fma" and
# "split" as for the products
SUMS = {"seq": lambda r: sum(r[1:], r[0]), "x0x2": lambda r: (r[0] + r[2]) + r[1],
        "tree": lambda r: (r[0] + r[1]) + (r[2] + r[3]),
        "tree2": lambda r: (r[0] + r[2]) + (r[1] + r[3])}
PREDICT_MODES = {"inv1": MODES, "mul1": MODES, "kk1": MODES, "sum3": ("seq", "x0x2", "fma"),
                 "norm4": ("seq", "tree", "tree2", "fma", "split")}


def predict_matches(dev, n: int = 256) -> dict:
    """{name: the orders that give torch's result bit for bit} for the
    prediction's un-batched products (se3_inverse's R^T t, the products of
    two [4, 4] poses, so3_left_jacobian's K K) and its reductions (the 3
    squares of torch.sum, the quaternion's 4 of torch.linalg.norm), each
    taken on ``n`` random operands one call at a time, as the prediction
    takes them."""
    import numpy as np
    import torch
    import table_replay as tr

    from ldso_tpu_torch.math import lie

    rng = np.random.default_rng(2026)
    f32 = dict(dtype=torch.float32, device=dev)
    cases = {k: ([], []) for k in PREDICT_MODES}
    for _ in range(n):
        A, B = (lie.se3_exp(torch.as_tensor(rng.normal(size=6), **f32)) for _ in range(2))
        R, t = B[:3, :3], B[:3, 3]
        phi = torch.as_tensor(rng.normal(size=3), **f32)
        K = lie.hat(phi)
        q = torch.as_tensor(rng.normal(size=4), **f32)
        for name, ref, terms in (
                ("inv1", (R.transpose(-1, -2) @ t[..., None])[:, 0],
                 [[(R[j, i], t[j]) for j in range(3)] for i in range(3)]),
                ("mul1", A @ B, [[(A[i, j], B[j, k]) for j in range(4)]
                                 for i in range(4) for k in range(4)]),
                ("kk1", K @ K, [[(K[i, j], K[j, k]) for j in range(3)]
                                for i in range(3) for k in range(3)]),
                ("sum3", torch.sum(phi * phi, dim=-1), [[(phi[j], phi[j]) for j in range(3)]]),
                ("norm4", torch.linalg.norm(q, dim=-1, keepdim=True),
                 [[(q[j], q[j]) for j in range(4)]])):
            cases[name][0].append(ref.reshape(-1))
            cases[name][1].append(terms)
    found = {}
    for name, (refs, terms) in cases.items():
        ref = torch.cat(refs)
        ok = []
        for mode in PREDICT_MODES[name]:
            if mode in SUMS:
                got = [SUMS[mode]([a * b for a, b in entry]) for ts in terms for entry in ts]
            else:
                got = [tr.dot(entry, mode) for ts in terms for entry in ts]
            got = torch.stack(got)
            if name == "norm4":
                got = torch.sqrt(got)
            if torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                ok.append(mode)
        found[name] = ok
    return found


def matches(F: int, dev) -> dict:
    """{product: the orders that give torch's result bit for bit at F}."""
    import torch
    import table_replay as tr

    found = {}
    for name, (ref, terms, n, m) in _products(F, dev).items():
        ref = ref.contiguous()
        ok = []
        for mode in MODES:
            got = torch.stack([torch.stack([tr.dot(terms(i, k), mode) for k in range(m)], -1)
                               for i in range(n)], -2)
            if torch.equal(got.reshape(ref.shape).contiguous().view(torch.int32),
                           ref.view(torch.int32)):
                ok.append(mode)
        found[name] = ok
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_table_rules.py: needs a CUDA card (or --device cpu)")
    dev = torch.device(a.device)
    per_f = {F: matches(F, dev) for F in range(1, 33)}
    bad = []
    for name in KERNEL:
        by_mode = {m: [F for F in per_f if m in per_f[F][name]] for m in MODES}
        none = [F for F in per_f if not per_f[F][name]]
        print(f"{name}: " + "; ".join(f"{m} at F = {_ranges(fs)}" for m, fs in by_mode.items()
                                      if fs)
              + (f"; no order at F = {_ranges(none)}" if none else ""), flush=True)
        if a.device == "cuda":
            bad += [f"{name} at F = {F} ({KERNEL[name](F)} written, torch "
                    f"{'/'.join(per_f[F][name]) or 'none'})"
                    for F in per_f if KERNEL[name](F) not in per_f[F][name]]
    found = predict_matches(dev)
    for name, ok in found.items():
        print(f"predict {name}: {'/'.join(ok) or 'no order'}", flush=True)
        if a.device == "cuda" and PREDICT[name] not in ok:
            bad.append(f"predict {name} ({PREDICT[name]} written, torch {'/'.join(ok) or 'none'})")
    if a.device == "cuda":
        print("kernel rules: " + ("all match" if not bad else "MISMATCH " + "; ".join(bad)),
              flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return 1 if bad else 0


def _ranges(fs: list) -> str:
    out, i = [], 0
    while i < len(fs):
        j = i
        while j + 1 < len(fs) and fs[j + 1] == fs[j] + 1:
            j += 1
        out.append(str(fs[i]) if i == j else f"{fs[i]}-{fs[j]}")
        i = j + 1
    return ", ".join(out)


if __name__ == "__main__":
    sys.exit(main())
