"""The slot tables the hand kernels make from the window's state
(``csrc/lie.cuh``'s expressions: K4's pair tables in ``csrc/ba.cu``, the
trace's and the activation's slot tables in ``csrc/trace.cu``), replayed in
torch ops in the kernels' order. How a device sums torch's small products
and its 3-value sum comes in as RULES = (modes, sum3, divk): each product's
dot products by ``modes[product]`` ("seq": each product and sum rounded;
"fma": fused multiply-adds in index order from zero; "split": terms 0-1 and
the rest in two such chains, then added), ``sum3`` the sum of three values,
``divk`` x / k for a python float k. The card's rules are the kernels'
(``lie.cuh``'s ``Rules``; the ``gpu`` tests hold the kernels' tables to the
plain versions, ``scripts/torch_table_rules.py`` reads each product's rule
off a device); ``cpu_rules`` are this CPU's, read off torch here. A pose is
a list of its rows 0-2, each a list of 4 tensors (row 3 is (0, 0, 0, 1)).
"""

import torch

import chip_smoke as cs

# se3_exp's K K and V rho, the exponential times T_eval, the inverse's
# R^T t, the products of one slot's pose by another's inverse (K4's and the
# activation's einsum), the adjoint's hat(t) R, and the trace's T_new_cw @
# T_all^-1
PRODUCTS = ("KK", "Vrho", "ET", "inv", "rel", "adj", "hn")


def cpu_rules(F: int) -> tuple:
    """This CPU's rules (``scripts/torch_table_rules.py --device cpu``): its
    batched products round each product and sum, MKL's sgemm under the
    einsums chains fused multiply-adds except at F <= 2 (computed as the
    batched ones), torch.sum adds (x0 + x1) + x2, x / k divides."""
    modes = {k: "seq" for k in PRODUCTS}
    modes["rel"] = "fma" if F > 2 else "seq"
    return modes, lambda q: (q[0] + q[1]) + q[2], lambda t, k: t / k


def dot(pairs, mode: str):
    """A dot product accumulated from +0 in index order (the start shows
    only in the sign of an exact zero), by ``mode``."""
    if mode == "split":
        return dot(pairs[:2], "fma") + dot(pairs[2:], "fma")
    acc = torch.zeros_like(pairs[0][0] * pairs[0][1])
    for a, b in pairs:
        acc = cs.fma32(a, b, acc) if mode == "fma" else acc + a * b
    return acc


def exp_times(x, Te, rules: tuple) -> list:
    """Rows 0-2 of se3_exp(x[:, :6]) T_eval (``lie.exp_times34``)."""
    modes = rules[0]
    E = exp_rows(x, rules)
    return [[dot([(E[i][j], Te[:, j, k]) for j in range(4)], modes["ET"]) for k in range(4)]
            for i in range(3)]


def exp_rows(x, rules: tuple) -> list:
    """Rows 0-2 of se3_exp(x[:, :6]) (``lie.exp34``)."""
    modes, sum3, divk = rules
    r, p = [x[:, i] for i in range(3)], [x[:, 3 + i] for i in range(3)]
    tsq = sum3([pi * pi for pi in p])
    small = tsq < 1e-8
    safe = torch.where(small, torch.ones_like(tsq), tsq)
    th = torch.sqrt(safe)
    sn, cs_ = torch.sin(th), torch.cos(th)
    A = torch.where(small, 1.0 - divk(tsq, 6.0), sn / th)
    B = torch.where(small, 0.5 - divk(tsq, 24.0), (1.0 - cs_) / safe)
    C = torch.where(small, 1.0 / 6.0 - divk(tsq, 120.0), (th - sn) / (safe * th))
    z = torch.zeros_like(tsq)
    K = [[z, -p[2], p[1]], [p[2], z, -p[0]], [-p[1], p[0], z]]
    R = [[None] * 3 for _ in range(3)]
    V = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            kk = dot([(K[i][m], K[m][j]) for m in range(3)], modes["KK"])
            e = 1.0 if i == j else 0.0
            R[i][j] = (e + A * K[i][j]) + B * kk
            V[i][j] = (e + B * K[i][j]) + C * kk
    t = [dot([(V[i][j], r[j]) for j in range(3)], modes["Vrho"]) for i in range(3)]
    return [[R[i][0], R[i][1], R[i][2], t[i]] for i in range(3)]


def rows(T) -> list:
    """Rows 0-2 of a [..., 4, 4] pose tensor."""
    return [[T[..., i, k] for k in range(4)] for i in range(3)]


def inverse(T: list, mode: str) -> list:
    """Rows 0-2 of lie.se3_inverse (``lie.inverse34``)."""
    return [[T[j][i] for j in range(3)]
            + [-dot([(T[j][i], T[j][3]) for j in range(3)], mode)] for i in range(3)]


def mul(A: list, B: list, mode: str) -> list:
    """The rows of A times B (``lie.mul34``): A's rows (4 entries each), B's
    rows 0-2 (its row 3 (0, 0, 0, 1)); entries broadcast."""
    unit = [torch.tensor(1.0 if k == 3 else 0.0) for k in range(4)]
    return [[dot([(a[j], B[j][k]) for j in range(3)] + [(a[3], unit[k])], mode)
             for k in range(4)] for a in A]


def stack_pose(T: list):
    """[..., 4, 4] from its 4 rows."""
    shape = torch.broadcast_shapes(*(e.shape for r in T for e in r))
    return torch.stack([torch.stack([e.expand(shape) for e in r], -1) for r in T], -2)


def trace_tables(T_eval, x, exposure, T_new_cw, ab_abs, exposure_new, rules: tuple) -> tuple:
    """``frame_step.trace_slot_tables`` by the trace kernel's expression
    (csrc/trace.cu trace_slot): T_hn [F, 4, 4], ab [F, 2]."""
    modes = rules[0]
    Ti = inverse(exp_times(x, T_eval, rules), modes["inv"])
    Tn = [[T_new_cw[i, k] for k in range(4)] for i in range(4)]
    T_hn = mul(Tn, Ti, modes["hn"])
    ea = exposure * torch.exp(x[:, 6])
    alpha = (exposure_new * torch.exp(ab_abs[0])) / torch.clamp(ea, min=1e-12)
    beta = ab_abs[1] - alpha * x[:, 7]
    return stack_pose(T_hn), torch.stack([alpha, beta], -1)


def activation_tables(T_all, x, exposure, rules: tuple) -> tuple:
    """``trace.activation_slot_tables`` by the activation kernel's
    expression (csrc/trace.cu act_slot, act_pair): T_rel [F, F, 4, 4]
    ([f, h] = T_all[f] T_all[h]^-1), alpha, beta [F, F]."""
    modes = rules[0]
    Ti = [[e[None, :] for e in r] for r in inverse(rows(T_all), modes["inv"])]
    Tf = [[T_all[:, i, k][:, None] for k in range(4)] for i in range(4)]
    rel = mul(Tf, Ti, modes["rel"])
    ea = exposure * torch.exp(x[:, 6])
    alpha = ea[:, None] / torch.clamp(ea, min=1e-12)[None, :]
    beta = x[:, None, 7] - alpha * x[None, :, 7]
    return stack_pose(rel), alpha, beta


def mul4(A: list, B: list, mode: str) -> list:
    """The rows of A times a whole pose B, its 4 rows (``lie.mul4``)."""
    return [[dot([(a[j], B[j][k]) for j in range(4)], mode) for k in range(4)] for a in A]


def log_rows(T: list, rules: tuple) -> list:
    """se3_log of a pose's rows 0-2 (``lie.log34``): [rho, phi], 6 entries.
    ``rules`` = (modes, sum3, divk, norm4): ``modes["kk1"]`` the order of
    the one K K, ``norm4`` the sum of a quaternion's 4 squares."""
    modes, sum3, divk, norm4 = rules
    m = [[T[i][j] for j in range(3)] for i in range(3)]

    def cl(x, lo=1e-12):
        return torch.clamp(x, min=lo)

    tr = (m[0][0] + m[1][1]) + m[2][2]
    qw = divk(torch.sqrt(cl(1.0 + tr)), 2.0)
    qx = divk(torch.sqrt(cl(((1.0 + m[0][0]) - m[1][1]) - m[2][2])), 2.0)
    qy = divk(torch.sqrt(cl(((1.0 - m[0][0]) + m[1][1]) - m[2][2])), 2.0)
    qz = divk(torch.sqrt(cl(((1.0 - m[0][0]) - m[1][1]) + m[2][2])), 2.0)
    # the first largest, as the kernel takes it
    c, top = torch.zeros_like(qw, dtype=torch.int64), qw
    for k, qk in ((1, qx), (2, qy), (3, qz)):
        c, top = torch.where(qk > top, k, c), torch.where(qk > top, qk, top)
    d = [4 * cl(qk) for qk in (qw, qx, qy, qz)]
    cases = [[(m[2][1] - m[1][2]) / d[0], (m[0][2] - m[2][0]) / d[0], (m[1][0] - m[0][1]) / d[0],
              qw],
             [qx, (m[0][1] + m[1][0]) / d[1], (m[0][2] + m[2][0]) / d[1],
              (m[2][1] - m[1][2]) / d[1]],
             [(m[0][1] + m[1][0]) / d[2], qy, (m[1][2] + m[2][1]) / d[2],
              (m[0][2] - m[2][0]) / d[2]],
             [(m[0][2] + m[2][0]) / d[3], (m[1][2] + m[2][1]) / d[3], qz,
              (m[1][0] - m[0][1]) / d[3]]]
    q = [torch.where(c == 0, cases[0][i], torch.where(c == 1, cases[1][i], torch.where(
        c == 2, cases[2][i], cases[3][i]))) for i in range(4)]
    nq = torch.sqrt(norm4([qi * qi for qi in q]))
    q = [qi / nq for qi in q]
    sgn = torch.where(q[3] < 0, -1.0, 1.0)
    v, w = [qi * sgn for qi in q[:3]], q[3] * sgn
    nsq = sum3([vi * vi for vi in v])
    small = nsq < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq))
    scale = torch.where(small, (torch.reciprocal(cl(w)) * 2.0)
                        * (1.0 - nsq / (3.0 * cl(w * w))),
                        (2.0 * torch.atan2(n, w)) / n)
    p = [scale * vi for vi in v]
    tsq = sum3([pi * pi for pi in p])
    tsmall = tsq < 1e-8
    safe = torch.where(tsmall, torch.ones_like(tsq), tsq)
    th = torch.sqrt(safe)
    B = torch.where(tsmall, 0.5 - divk(tsq, 24.0), (1.0 - torch.cos(th)) / safe)
    C = torch.where(tsmall, 1.0 / 6.0 - divk(tsq, 120.0), (th - torch.sin(th)) / (safe * th))
    z = torch.zeros_like(tsq)
    K = [[z, -p[2], p[1]], [p[2], z, -p[0]], [-p[1], p[0], z]]
    a = [[((1.0 if i == j else 0.0) + B * K[i][j])
          + C * dot([(K[i][k], K[k][j]) for k in range(3)], modes["kk1"]) for j in range(3)]
         for i in range(3)]
    cof = [[a[1][1] * a[2][2] - a[1][2] * a[2][1], a[0][2] * a[2][1] - a[0][1] * a[2][2],
            a[0][1] * a[1][2] - a[0][2] * a[1][1]],
           [a[1][2] * a[2][0] - a[1][0] * a[2][2], a[0][0] * a[2][2] - a[0][2] * a[2][0],
            a[0][2] * a[1][0] - a[0][0] * a[1][2]],
           [a[1][0] * a[2][1] - a[1][1] * a[2][0], a[0][1] * a[2][0] - a[0][0] * a[2][1],
            a[0][0] * a[1][1] - a[0][1] * a[1][0]]]
    inv_det = torch.reciprocal((a[0][0] * cof[0][0] + a[0][1] * cof[1][0]) + a[0][2] * cof[2][0])
    b = [T[i][3] for i in range(3)]
    rho = [((cof[i][0] * b[0] + cof[i][1] * b[1]) + cof[i][2] * b[2]) * inv_det for i in range(3)]
    return rho + p


def delta_signs() -> list:
    """csrc/predict.cu's ``kDeltaSign``: the sign of each rotation axis in
    each of the 18 offset rows."""
    import re

    from ldso_tpu_torch.kernels import predict

    text = open(predict.SOURCE).read()
    body = re.search(r"kDeltaSign\[kDeltas\]\[3\] = \{(.*?)\};", text, re.S).group(1)
    return [[int(v) for v in row.split(",")] for row in re.findall(r"\{([^{}]*)\}", body)]


def predict_hypotheses(T_last, T_prelast, num: int, rules: tuple):
    """The [num, 4, 4] hypotheses by the prediction kernel's expression
    (csrc/predict.cu): T_last, T_prelast [4, 4]. ``rules`` = (modes, sum3,
    divk, norm4), ``modes`` with the orders of the one-pose products
    ("inv1", "mul1", "kk1") and of the exponential's batched ones ("KK",
    "Vrho") at this ``num``."""
    modes = rules[0]
    Tl = [[T_last[i, k] for k in range(4)] for i in range(4)]
    unit = [T_last.new_tensor(1.0 if k == 3 else 0.0) for k in range(4)]
    inv = inverse(rows(T_prelast), modes["inv1"]) + [unit]
    T_cv = mul4(mul4(Tl[:3], inv, modes["mul1"]), Tl, modes["mul1"])
    xi = torch.stack(log_rows(T_cv, rules))
    signs = delta_signs()
    rot = torch.tensor(0.02, dtype=torch.float32)
    h = []
    for k in range(num):
        if k < 4:
            h.append([xi, 0.5 * xi, 2.0 * xi, torch.zeros_like(xi)][k])
        elif k < 4 + len(signs):
            d = torch.cat([torch.zeros(3), torch.tensor(signs[k - 4], dtype=torch.float32) * rot])
            h.append(xi + d.to(xi.device))
        else:
            h.append(xi)
    E = exp_rows(torch.stack(h), rules[:3])
    ones = torch.ones(num, device=T_last.device)
    return stack_pose(E + [[0.0 * ones, 0.0 * ones, 0.0 * ones, ones]])


def cpu_predict_rules(num: int) -> tuple:
    """This CPU's rules for ``predict_hypotheses`` (read off torch here):
    the one-pose products chain fused multiply-adds (MKL's sgemm), the
    exponential's batched products and torch.sum round each product and
    sum in index order, x / k divides, and torch.linalg.norm adds the
    squares in index order."""
    modes = dict(inv1="fma", mul1="fma", kk1="fma", KK="seq", Vrho="seq")
    return (modes, lambda q: (q[0] + q[1]) + q[2], lambda t, k: t / k,
            lambda r: ((r[0] + r[1]) + r[2]) + r[3])


# csrc/lie.cuh's OneRules for the prediction, in kOne's field order
CARD_ONE = {"inv1": "split", "mul1": "split", "kk1": "split"}


def card_predict_rules(num: int) -> tuple:
    """The card's rules, as the prediction kernel writes them: lie.cuh's
    ``kOne`` (``CARD_ONE``) and ``rules(num)`` for the exponential's K K and
    V rho, torch.sum's (x0 + x2) + x1, x / k as x (1 / k) in float32, and
    the norm's (x0 + x2) + (x1 + x3)."""
    import numpy as np

    modes = dict(CARD_ONE, KK="split" if num == 1 else "fma", Vrho="split")
    return (modes, lambda q: (q[0] + q[2]) + q[1],
            lambda t, k: t * float(np.float32(1.0) / np.float32(k)),
            lambda r: (r[0] + r[2]) + (r[1] + r[3]))
