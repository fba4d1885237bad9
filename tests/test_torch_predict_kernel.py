"""The motion prediction (K7): the dispatch of ``tracker.predict_hypotheses``
(CPU -> the plain chain, bit for bit the expression ``frame_step`` used
before the kernel; other devices raise), the wrapper's refusals (before
any build), the ctypes argument types against the C entry, the kernel's
offset table against ``tracker._hypothesis_deltas``, the card's rules in
``tests/table_replay.py`` against ``csrc/lie.cuh``, the kernel's expression
replayed in torch ops with this CPU's rounding rules bit for bit against the
plain chain, chip_smoke's K7 bound and launch check, and, on a card, the
kernel against the plain chain bit for bit (and the replay with the card's
rules), one launch a call.

Each case runs at the hypothesis counts of the presets (5 in ``tiny``, 27
in ``default`` and ``fast``), at 22 (the last offset row) and at 30 (padded
with the constant-velocity guess), on pose pairs that take each branch of
the logarithm and the exponential: no motion (the small-angle branches),
a walk's 0.06 units and 0.02 rad a frame, a rotation near pi about each
axis (the quaternion's x, y and z cases) and a random pair.

The card's cases: ``python -m pytest --noconftest -m gpu
tests/test_torch_predict_kernel.py``.
"""

import ctypes
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import table_replay as tr
from ldso_tpu_torch import tracker
from ldso_tpu_torch.kernels import predict
from ldso_tpu_torch.math import lie

NUMS = (5, 22, 27, 30)


def _pose(rho, phi):
    return lie.se3_exp(torch.tensor([*rho, *phi], dtype=torch.float32))


def _near_pi(axis: int):
    phi = [0.0, 0.0, 0.0]
    phi[axis] = math.pi - 0.01
    T = _pose([0.1, -0.2, 0.3], phi)
    return T, T.clone()


def _random_pair():
    rng = np.random.default_rng(2026)
    return tuple(_pose(rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.5) for _ in range(2))


def _walk():
    step = _pose([0.0, 0.0, 0.06], [0.0, 0.02, 0.0])
    return step @ step, step


PAIRS = {"zero": lambda: (torch.eye(4), torch.eye(4)), "walk": _walk,
         "pi_x": lambda: _near_pi(0), "pi_y": lambda: _near_pi(1), "pi_z": lambda: _near_pi(2),
         "random": _random_pair}
# the quaternion case (torch.argmax of matrix_to_quat's candidates w, x, y,
# z) each pair's constant-velocity pose takes
QUAT_CASE = {"zero": 0, "walk": 0, "pi_x": 1, "pi_y": 2, "pi_z": 3, "random": 0}


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_cpu_dispatch_is_the_plain_chain(num, pair):
    T_last, T_prelast = PAIRS[pair]()
    n0 = predict.LAUNCHES
    got = tracker.predict_hypotheses(T_last, T_prelast, num)
    want = tracker.motion_hypotheses(
        lie.se3_mul(lie.se3_mul(T_last, lie.se3_inverse(T_prelast)), T_last), num=num)
    assert got.shape == (num, 4, 4) and torch.equal(_bits(got), _bits(want))
    assert predict.LAUNCHES == n0


@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_kernel_expression_replayed_on_cpu(num, pair):
    # csrc/predict.cu's arithmetic in torch ops, with this CPU's orders of
    # the products and sums: bit for bit the plain chain
    T_last, T_prelast = PAIRS[pair]()
    got = tr.predict_hypotheses(T_last, T_prelast, num, tr.cpu_predict_rules(num))
    want = tracker.predict_hypotheses_torch(T_last, T_prelast, num)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_pairs_take_every_quaternion_case(pair):
    T_last, T_prelast = PAIRS[pair]()
    R = lie.se3_mul(lie.se3_mul(T_last, lie.se3_inverse(T_prelast)), T_last)[:3, :3]
    q = [torch.sqrt(torch.clamp(1.0 + s0 * R[0, 0] + s1 * R[1, 1] + s2 * R[2, 2], min=1e-12))
         for s0, s1, s2 in ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
    assert int(torch.argmax(torch.stack(q))) == QUAT_CASE[pair]


def test_offset_table_is_the_trackers():
    deltas = tracker._hypothesis_deltas("cpu")
    signs = torch.tensor(tr.delta_signs(), dtype=torch.float32)
    assert signs.shape == (18, 3)
    assert torch.equal(deltas[:, :3], torch.zeros(18, 3))
    assert torch.equal(_bits(deltas[:, 3:]), _bits(signs * torch.tensor(0.02)))


def test_card_rules_follow_lie_cuh():
    text = open(os.path.join(os.path.dirname(predict.SOURCE), "lie.cuh")).read()
    fields = re.search(r"struct OneRules \{\s*bool ([^;]*);", text).group(1).split(", ")
    values = re.search(r"constexpr OneRules kOne\{([^}]*)\};", text).group(1).split(", ")
    assert fields == list(tr.CARD_ONE)
    assert ["split" if v == "true" else "fma" for v in values] == list(tr.CARD_ONE.values())


def test_read_off_finds_this_cpus_orders():
    # scripts/torch_table_rules.py's reading of the one-pose products and
    # the 3-value sum on this CPU gives the orders the CPU replay takes
    sys.path.insert(0, os.path.join(os.path.dirname(cs.__file__), "scripts"))
    import torch_table_rules

    found = torch_table_rules.predict_matches(torch.device("cpu"), n=32)
    modes = tr.cpu_predict_rules(27)[0]
    for name in ("inv1", "mul1", "kk1"):
        assert modes[name] in found[name]
    assert "seq" in found["sum3"]


def test_argtypes_follow_the_c_entry():
    text = open(predict.SOURCE).read()
    params = re.search(r'extern "C" int ldso_predict_hypotheses\((.*?)\)\s*\{', text,
                       re.S).group(1)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    want = [types["p" if "*" in q else "f" if q.split()[0] == "float" else "i"]
            for q in params.replace("\n", " ").split(",")]
    assert predict.ARGTYPES == want


def _noncontiguous():
    return torch.eye(8)[::2, ::2]


@pytest.mark.parametrize("case, match", [
    ("cpu", "needs CUDA tensors"), ("float64", "not torch.float32"), ("shape", "has shape"),
    ("noncontiguous", "not contiguous"), ("num0", "at least 1"), ("meta", "needs CUDA tensors")])
def test_cuda_wrapper_refuses_before_any_build(monkeypatch, case, match):
    def no_build():
        raise AssertionError("the wrapper built the kernel before refusing")

    monkeypatch.setattr(predict, "_lib", no_build)
    eye = torch.eye(4)
    args = {"cpu": (eye, eye, 27), "float64": (eye.double(), eye, 27),
            "shape": (eye[:3], eye, 27), "noncontiguous": (_noncontiguous(), eye, 27),
            "num0": (eye, eye, 0), "meta": (eye.to("meta"), eye.to("meta"), 27)}[case]
    with pytest.raises((TypeError, ValueError), match=match):
        predict.predict_hypotheses_cuda(*args)


def test_dispatch_refuses_other_devices():
    eye = torch.eye(4, device="meta")
    with pytest.raises(ValueError):
        tracker.predict_hypotheses(eye, eye, 27)


def test_bound_counts_the_bytes_and_operations():
    ms, by, n_bytes, flops = cs.predict_bound_ms(27)
    assert n_bytes == 64 + 48 + 27 * 64
    assert flops == cs.PREDICT_FLOPS_ONCE + 27 * cs.PREDICT_FLOPS_HYP
    assert by == "bytes" and ms == pytest.approx(1e3 * n_bytes / cs.HBM_BYTES_PER_S)


@pytest.mark.parametrize("predicted, ok", [(4, True), (3, False), (5, False)])
def test_launch_check_counts_one_prediction_a_tracked_frame(predicted, ok):
    if ok:
        cs._check_track_launches("t", cs.TRACK_LAUNCHES * 4, 4, predicted)
    else:
        with pytest.raises(RuntimeError, match="prediction kernel"):
            cs._check_track_launches("t", cs.TRACK_LAUNCHES * 4, 4, predicted)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("num", NUMS)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_cuda_kernel_matches_the_plain_chain(num, pair):
    """One launch a call; the hypotheses equal the plain chain's on the
    card (torch.equal, and bit for bit); the replay with the card's rules
    too."""
    dev = _cuda_or_skip()
    T_last, T_prelast = (t.to(dev) for t in PAIRS[pair]())
    want = tracker.predict_hypotheses_torch(T_last, T_prelast, num)
    n0 = predict.LAUNCHES
    got = predict.predict_hypotheses_cuda(T_last, T_prelast, num)
    assert predict.LAUNCHES == n0 + 1
    assert torch.equal(got, want), cs.ulp_text(got, want)
    assert torch.equal(_bits(got), _bits(want)), cs.ulp_text(got, want)
    replay = tr.predict_hypotheses(T_last, T_prelast, num, tr.card_predict_rules(num))
    assert torch.equal(_bits(replay), _bits(want)), cs.ulp_text(replay, want)


@pytest.mark.gpu
def test_cuda_dispatch_launches_once_a_call_and_repeats_bitwise():
    dev = _cuda_or_skip()
    T_last, T_prelast = (t.to(dev) for t in _walk())
    n0 = predict.LAUNCHES
    a = tracker.predict_hypotheses(T_last, T_prelast, 27)
    b = tracker.predict_hypotheses(T_last, T_prelast, 27)
    assert predict.LAUNCHES == n0 + 2
    assert torch.equal(_bits(a), _bits(b))
