"""The sliding-window state: fixed-capacity tensors with validity masks.

Port of ``ldso_tpu/core/window.py``. State parameterization (as the
reference, mirroring FrameHessian::state / state_zero):
  * per frame: ``T_eval`` is the worldToCam SE(3) evaluation point fixed
    at keyframe insertion; the 8-dim state ``x = [xi(6), a, b]`` holds the
    accumulated left-tangent pose delta (``T = exp(xi)·T_eval``) and the
    affine brightness params; ``x_zero`` is the FEJ linearization state.
  * camera: 4 intrinsics ``c`` with FEJ copy ``c_zero``.
  * points: inverse depth in host frame (+ FEJ copy), 8-pattern host
    colors and static gradient weights.

All functions are out-of-place, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ldso_tpu_torch.config import PATTERN, LdsoConfig
from ldso_tpu_torch.core.scatter import scatter_drop
from ldso_tpu_torch.kernels.interp import bilinear
from ldso_tpu_torch.math import lie

PATTERN_OFFSETS = np.asarray(PATTERN, dtype=np.float32)  # [8, 2]


def pattern(device) -> torch.Tensor:
    """The 8-point residual pattern as a [8, 2] f32 tensor on ``device``."""
    return torch.as_tensor(PATTERN_OFFSETS, device=device)


class Window(NamedTuple):
    """Device-resident window state."""

    # frames — slot-indexed, capacity F
    frame_valid: torch.Tensor     # bool [F]
    T_eval: torch.Tensor          # f32 [F, 4, 4] worldToCam FEJ evaluation points
    x: torch.Tensor               # f32 [F, 8] current state [xi(6), a, b]
    x_zero: torch.Tensor          # f32 [F, 8] FEJ state
    exposure: torch.Tensor        # f32 [F] exposure times (1.0 if unknown)
    images: torch.Tensor          # f32 [F, H, W, 3] level-0 (I, dx, dy)

    # camera intrinsics (optimized: the CPARS=4 state)
    c: torch.Tensor               # f32 [4]
    c_zero: torch.Tensor          # f32 [4]

    # active point bank — capacity P
    p_valid: torch.Tensor         # bool [P]
    p_host: torch.Tensor          # i32 [P] window slot of host frame
    p_uv: torch.Tensor            # f32 [P, 2] pixel in host frame (level 0)
    p_color: torch.Tensor         # f32 [P, 8] host pattern intensities
    p_weight: torch.Tensor        # f32 [P, 8] static sqrt gradient weights
    p_idepth: torch.Tensor        # f32 [P]
    p_idepth_zero: torch.Tensor   # f32 [P]
    res_mask: torch.Tensor        # bool [P, F] active residual (point, target) pairs

    @property
    def num_frames(self) -> int:
        return self.T_eval.shape[0]

    @property
    def num_points(self) -> int:
        return self.p_uv.shape[0]

    def current_pose(self, slot=None):
        """worldToCam of slot(s): exp(xi)·T_eval."""
        T = lie.se3_mul(lie.se3_exp(self.x[:, :6]), self.T_eval)
        return T if slot is None else T[slot]


def empty_window(cfg: LdsoConfig, h: int, w: int, intr, device) -> Window:
    F = cfg.shapes.max_frames
    P = cfg.shapes.max_points
    f32 = torch.float32
    c = torch.as_tensor(np.asarray(intr, np.float32), device=device)
    return Window(
        frame_valid=torch.zeros(F, dtype=torch.bool, device=device),
        T_eval=torch.eye(4, dtype=f32, device=device).expand(F, 4, 4).clone(),
        x=torch.zeros((F, 8), dtype=f32, device=device),
        x_zero=torch.zeros((F, 8), dtype=f32, device=device),
        exposure=torch.ones(F, dtype=f32, device=device),
        images=torch.zeros((F, h, w, 3), dtype=f32, device=device),
        c=c.clone(),
        c_zero=c.clone(),
        p_valid=torch.zeros(P, dtype=torch.bool, device=device),
        p_host=torch.zeros(P, dtype=torch.int32, device=device),
        p_uv=torch.zeros((P, 2), dtype=f32, device=device),
        p_color=torch.zeros((P, 8), dtype=f32, device=device),
        p_weight=torch.ones((P, 8), dtype=f32, device=device),
        p_idepth=torch.ones(P, dtype=f32, device=device),
        p_idepth_zero=torch.ones(P, dtype=f32, device=device),
        res_mask=torch.zeros((P, F), dtype=torch.bool, device=device),
    )


def state_delta(win: Window) -> torch.Tensor:
    """Stacked delta from the FEJ linearization point, [8F + 4]: frame
    blocks (8 each, slots 0..F-1) then camera (4) — the coordinates of
    the marginalization prior HM/bM."""
    return torch.cat([(win.x - win.x_zero).reshape(-1), win.c - win.c_zero])


def insert_frame(win: Window, slot: int, T_init, image, exposure: float,
                 aff_ab=(0.0, 0.0)) -> Window:
    """Occupy a slot with a new keyframe: evaluation point = initial pose,
    pose state and FEJ state zero, affine state from ``aff_ab``."""
    dev = win.x.device
    x0 = torch.zeros(8, dtype=torch.float32, device=dev)
    x0[6] = float(aff_ab[0])
    x0[7] = float(aff_ab[1])

    def put(a, v):
        a = a.clone()
        a[slot] = v
        return a

    return win._replace(
        frame_valid=put(win.frame_valid, True),
        T_eval=put(win.T_eval, torch.as_tensor(T_init, dtype=torch.float32, device=dev)),
        x=put(win.x, x0),
        x_zero=put(win.x_zero, x0),
        exposure=put(win.exposure, float(exposure)),
        images=put(win.images, image.to(torch.float32)),
    )


def remove_frame(win: Window, slot: int) -> Window:
    """Free a slot: invalidate the frame, its hosted points, and every
    residual targeting it."""
    hosted = win.p_host == slot
    fv = win.frame_valid.clone()
    fv[slot] = False
    rm = win.res_mask & ~hosted[:, None]
    rm[:, slot] = False
    return win._replace(frame_valid=fv, p_valid=win.p_valid & ~hosted, res_mask=rm)


def add_points(win: Window, slots, host_slot: int, uv, color, weight,
               idepth) -> Window:
    """Activate points into bank slots (entries >= P are dropped);
    residuals toward all other valid frames are switched on."""
    dev = win.x.device
    slots = torch.as_tensor(slots, device=dev)
    targets = win.frame_valid.clone()
    targets[host_slot] = False
    res_rows = targets.expand(slots.shape[0], win.num_frames)
    idep = torch.as_tensor(idepth, dtype=torch.float32, device=dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return win._replace(
        p_valid=scatter_drop(win.p_valid, slots, True),
        p_host=scatter_drop(win.p_host, slots, host_slot),
        p_uv=scatter_drop(win.p_uv, slots, f32(uv)),
        p_color=scatter_drop(win.p_color, slots, f32(color)),
        p_weight=scatter_drop(win.p_weight, slots, f32(weight)),
        p_idepth=scatter_drop(win.p_idepth, slots, idep),
        p_idepth_zero=scatter_drop(win.p_idepth_zero, slots, idep),
        res_mask=scatter_drop(win.res_mask, slots, res_rows),
    )


def drop_points(win: Window, mask) -> Window:
    """Deactivate points (mask [P] True = drop)."""
    keep = ~torch.as_tensor(mask, device=win.p_valid.device)
    return win._replace(p_valid=win.p_valid & keep,
                        res_mask=win.res_mask & keep[:, None])


def connect_new_frame(win: Window, slot: int) -> Window:
    """After inserting a KF, switch on residuals from every active point
    toward it (except points it hosts)."""
    rm = win.res_mask.clone()
    rm[:, slot] = win.p_valid & (win.p_host != slot)
    return win._replace(res_mask=rm)


def activate_points_device(win: Window, slots, host, uv, idepth,
                           outlier_sum: float = 2500.0) -> Window:
    """Multi-host activation: samples each point's 8-pattern colors and
    static gradient weights from its HOST frame's image and scatters
    everything into the bank (slots >= P are dropped)."""
    F = win.num_frames
    host = host.to(torch.int32)
    uvp = uv[:, None, :] + pattern(uv.device)[None]                   # [K, 8, 2]
    hit = bilinear(win.images, uvp, frame=host[:, None].expand(-1, 8))  # [K, 8, 3]
    color = hit[..., 0]
    gsq = torch.sum(hit[..., 1:3] ** 2, dim=-1)
    weight = torch.sqrt(outlier_sum / (outlier_sum + gsq))
    res_rows = win.frame_valid[None, :] & (
        torch.arange(F, device=uv.device)[None, :] != host[:, None])
    idep = idepth.to(torch.float32)
    return win._replace(
        p_valid=scatter_drop(win.p_valid, slots, True),
        p_host=scatter_drop(win.p_host, slots, host),
        p_uv=scatter_drop(win.p_uv, slots, uv),
        p_color=scatter_drop(win.p_color, slots, color),
        p_weight=scatter_drop(win.p_weight, slots, weight),
        p_idepth=scatter_drop(win.p_idepth, slots, idep),
        p_idepth_zero=scatter_drop(win.p_idepth_zero, slots, idep),
        res_mask=scatter_drop(win.res_mask, slots, res_rows),
    )
