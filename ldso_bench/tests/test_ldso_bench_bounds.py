"""The kernels' roofline counts (``harness/bounds.py``) against hand counts
on small shapes."""

from types import SimpleNamespace

import pytest
import torch

from ldso_bench.harness import bounds
from ldso_bench.reference import window as r_window
from ldso_tpu_torch import config


def test_pyramid_bytes_of_the_640x480_frame():
    # 307,200 B of uint8 read, 16 B a pixel of every level written
    want = 307_200 + 16 * (307_200 + 76_800 + 19_200 + 4_800 + 1_200)
    assert want == 6_854_400
    assert bounds.pyramid_bound_ms(480, 640, 5) == pytest.approx(1e3 * want / 3.35e12)


def _level(n: int, w: int = 64, h: int = 48):
    """n points on a grid 4 px apart, idepth 1, identity pose: each point's
    four corners are its own texels."""
    u = 4.0 + 4.0 * torch.arange(n, dtype=torch.float32)
    uv = torch.stack([u % (w - 8) + 4.25, 4.25 + 4.0 * (u // (w - 8))], -1)
    intr = torch.tensor([50.0, 50.0, w / 2, h / 2])
    T0 = torch.eye(4).expand(1, 4, 4).contiguous()
    return (torch.zeros(h, w, 3), uv, torch.ones(n), torch.zeros(n),
            torch.ones(n, dtype=torch.bool), T0, torch.zeros(1, 2), intr)


def test_track_level_count_by_hand():
    n = 10
    lv = _level(n)
    n_iter, n_ok = torch.tensor([2]), torch.tensor([3 * n])
    got = bounds.track_level_bound_ms(lv, 64, 48, lv[5].clone(), n_iter, n_ok)
    n_bytes = 12 * 4 * n + 17 * n + 16 + 72 + 112
    flops = 77 * n * (1 + 2) + 130 * 3 * n + 751 * 2
    assert got == pytest.approx(1e3 * max(n_bytes / 3.35e12, flops / 67e12))


def test_track_frame_chains_its_levels():
    """Two levels (one coarse of 2 lanes, one fine): the fine level starts
    at the coarse level's winner; the frame's count is the levels' sum."""
    lv = _level(6)
    T_inits = torch.eye(4).expand(2, 4, 4).contiguous()
    T_out = torch.eye(4).expand(2, 2, 4, 4).contiguous()
    out = SimpleNamespace(T=T_out, ab=torch.zeros(2, 2, 2),
                          n_iter=torch.tensor([[3, 4], [5, 0]]),
                          n_ok_sum=torch.tensor([[12, 18], [30, 0]]),
                          best=torch.tensor([1]))
    plan = ((SimpleNamespace(level=1, intr_row=1),), (SimpleNamespace(level=0, intr_row=0),))
    pyr = (lv[0], lv[0])
    ref = SimpleNamespace(uv=(lv[1], lv[1]), idepth=(lv[2], lv[2]), color=(lv[3], lv[3]),
                          valid=(lv[4], lv[4]))
    intr_levels = torch.stack([lv[7], lv[7]])
    got = bounds.track_frame_bound_ms((pyr, ref, plan, intr_levels, T_inits, torch.zeros(2)),
                                      out)
    coarse = bounds.track_level_bound_ms(
        lv[:5] + (T_inits, torch.zeros(2, 2), lv[7]), 64, 48, T_out[1], out.n_iter[1],
        out.n_ok_sum[1])
    fine = bounds.track_level_bound_ms(
        lv[:5] + (T_out[1][1:2], torch.zeros(1, 2), lv[7]), 64, 48, T_out[0][:1],
        out.n_iter[0][:1], out.n_ok_sum[0][:1])
    assert got == pytest.approx(coarse + fine)


@pytest.mark.parametrize("mode", ["active", "fej", "energy"])
def test_ba_count_of_a_window_without_points(mode):
    """No valid point: nothing is sampled, and the bytes are the points'
    inputs, the slots' state, the intrinsics and the outputs."""
    cfg = config.preset("tiny")
    win = r_window.empty_window(cfg, 48, 64, [50.0, 50.0, 32.0, 24.0], "cpu")
    P, F = win.p_uv.shape[0], win.images.shape[0]
    D = 8 * F + 4
    energy = mode == "energy"
    n_bytes = (P * (8 + 4 + (0 if energy else 4) + 32 + 32 + 4 + 1 + F)
               + F * (64 + 32 + 4 + (0 if energy else 32)) + F + 32
               + (12 if energy else 4 * (D * D + D + 1) + 8 + P * (4 * D + 8 + 6 * F)))
    valid_pair = torch.zeros(P, F, dtype=torch.bool)
    got = bounds.ba_bound_ms(win, mode, None if energy else valid_pair)
    assert got == pytest.approx(1e3 * n_bytes / 3.35e12)
