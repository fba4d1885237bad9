"""The corridor scene and its endless triangle-wave walk, rendered on the card.

A torch copy of the port's synthetic corridor (``io/synthetic.py``:
``value_noise_texture``, ``make_scene("corridor")``, ``SyntheticScene.render``
at supersample 1, the ``multi_pass`` path): four value-noise textured
planes (ground y = +1.5, walls x = -3 and x = +3, a backdrop z = 20), a
pinhole camera facing +z that walks out along the corridor and back. The
traffic's ``texture_seed`` draws the four textures, so every run of a
cell sees the same frames; a run's seed draws only the frame of the ring
it starts from (``ring_start``), so runs on different seeds do the same
work in another order. The path, the step and the camera are the
traffic's and the configuration's. Frames are rendered in
float64 on the device, rounded to uint8 and returned on the host, as a
camera delivers them.
"""

from __future__ import annotations

import numpy as np
import torch

TEXTURE_SIZE = 512
OCTAVES = 5
# (normal, offset, texture axis 1, texture axis 2, world units per texel):
# the plane normal . X = offset, as make_scene("corridor") lays them out
PLANES = (((0, -1, 0), -1.5, (1, 0, 0), (0, 0, 1), 0.02),
          ((1, 0, 0), -3.0, (0, 1, 0), (0, 0, 1), 0.02),
          ((-1, 0, 0), -3.0, (0, 1, 0), (0, 0, 1), 0.02),
          ((0, 0, -1), -20.0, (1, 0, 0), (0, 1, 0), 0.05))


def resize_bilinear(a: torch.Tensor, size: int) -> torch.Tensor:
    """``synthetic._resize_bilinear``: an [n, n] grid sampled at ``size``
    evenly spaced points per axis."""
    n = a.shape[0]
    x = torch.linspace(0, n - 1, size, dtype=torch.float64, device=a.device)
    x0 = torch.floor(x).long()
    x1 = torch.clamp(x0 + 1, max=n - 1)
    fx = x - x0
    gx = 1 - fx
    out = a[x0][:, x0] * (gx[:, None] * gx[None, :])
    out = out + a[x1][:, x0] * (fx[:, None] * gx[None, :])
    out = out + a[x0][:, x1] * (gx[:, None] * fx[None, :])
    out = out + a[x1][:, x1] * (fx[:, None] * fx[None, :])
    return out


def value_noise(normals, size: int = TEXTURE_SIZE) -> torch.Tensor:
    """``synthetic.value_noise_texture`` from its octaves' normal draws
    (``normals[o]`` [8 << o, 8 << o] float64): the octaves summed with
    amplitude 0.55^o, two 3x3 binomial blurs with wrap-around, scaled to
    [20, 235], float32."""
    tex = torch.zeros((size, size), dtype=torch.float64, device=normals[0].device)
    amp, total = 1.0, 0.0
    for g in normals:
        tex = tex + amp * resize_bilinear(g, size)
        total += amp
        amp *= 0.55
    tex = tex / total
    for _ in range(2):
        r = torch.roll
        tex = 0.25 * tex + 0.125 * (
            r(tex, 1, 0) + r(tex, -1, 0) + r(tex, 1, 1) + r(tex, -1, 1)
        ) + 0.0625 * (
            r(r(tex, 1, 0), 1, 1) + r(r(tex, 1, 0), -1, 1)
            + r(r(tex, -1, 0), 1, 1) + r(r(tex, -1, 0), -1, 1)
        )
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (20.0 + 215.0 * tex).to(torch.float32)


def textures(seed: int, device) -> list:
    """The four planes' textures, drawn from ``seed`` by a generator on
    ``device``: per plane, per octave, an [8 << o, 8 << o] normal grid."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = []
    for _ in PLANES:
        normals = [torch.randn((8 << o, 8 << o), generator=gen, dtype=torch.float64,
                               device=device) for o in range(OCTAVES)]
        out.append(value_noise(normals))
    return out


def walk_poses(frames_each_way: int, step: float, lateral: float = 0.15,
               lateral_freq: float = 0.2) -> np.ndarray:
    """[2 * frames_each_way, 4, 4] camera-to-world poses of one period of
    the ``multi_pass`` triangle wave: z = i * step out, then back; x =
    lateral * sin(lateral_freq * pi * z); no rotation. Frame 2n follows
    frame 2n - 1 as frame 1 follows frame 0, so the ring of frames repeats
    without a seam."""
    n = int(frames_each_way)
    i = np.arange(2 * n)
    z = np.where(i < n, i, 2 * n - i) * float(step)
    T = np.tile(np.eye(4), (2 * n, 1, 1))
    T[:, 0, 3] = lateral * np.sin(lateral_freq * z * np.pi)
    T[:, 2, 3] = z
    return T


def _sample_wrap(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    t = tex.shape[0]
    u0f, v0f = torch.floor(u), torch.floor(v)
    fu, fv = u - u0f, v - v0f
    u0, v0 = torch.remainder(u0f.long(), t), torch.remainder(v0f.long(), t)
    u1, v1 = torch.remainder(u0 + 1, t), torch.remainder(v0 + 1, t)
    tex = tex.to(torch.float64)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def render(texs: list, poses_wc: np.ndarray, intr, w: int, h: int) -> torch.Tensor:
    """[N, h, w] float32 images of the corridor from camera-to-world poses
    [N, 4, 4], as ``SyntheticScene.render(..., supersample=1)``: per pixel
    the nearest plane hit at t > 0.05, its texture sampled bilinearly with
    wrap-around; 0 where no plane is hit."""
    dev = texs[0].device
    f64 = dict(dtype=torch.float64, device=dev)
    fx, fy, cx, cy = (float(x) for x in intr)
    v, u = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    dirs_c = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)  # [h, w, 3]
    T = torch.as_tensor(np.asarray(poses_wc), **f64)
    dirs_w = torch.einsum("hwj,nij->nhwi", dirs_c, T[:, :3, :3])                 # [N, h, w, 3]
    o = T[:, :3, 3]                                                              # [N, 3]
    best_t = torch.full(dirs_w.shape[:3], float("inf"), **f64)
    img = torch.zeros(dirs_w.shape[:3], **f64)
    for (normal, offset, e1, e2, scale), tex in zip(PLANES, texs):
        nrm = torch.tensor(normal, **f64)
        denom = dirs_w @ nrm
        denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        t = (offset - o @ nrm)[:, None, None] / denom
        hit = (t > 0.05) & (t < best_t)
        X = o[:, None, None, :] + t[..., None] * dirs_w
        tu = (X @ torch.tensor(e1, **f64)) / scale
        tv = (X @ torch.tensor(e2, **f64)) / scale
        col = _sample_wrap(tex, tu, tv).to(torch.float32).to(torch.float64)
        img = torch.where(hit, col, img)
        best_t = torch.where(hit, t, best_t)
    return img.to(torch.float32)


def render_ring(seed: int, poses_wc: np.ndarray, intr, w: int, h: int, device,
                chunk: int = 16) -> np.ndarray:
    """The ring of frames: [N, h, w] uint8 on the host (rounded and
    clipped as the bench sequences are), rendered on ``device`` in chunks
    of frames."""
    texs = textures(seed, device)
    out = np.empty((len(poses_wc), h, w), dtype=np.uint8)
    for lo in range(0, len(poses_wc), chunk):
        img = render(texs, poses_wc[lo:lo + chunk], intr, w, h)
        out[lo:lo + chunk] = torch.clamp(torch.round(img), 0, 255).to(torch.uint8).cpu().numpy()
    return out


def ring_start(seed: int, start_frames: int) -> int:
    """The ring frame a run starts from, drawn from the run's seed among
    the first ``start_frames`` of the walk's way out (so that the
    bootstrap's frames all move one way)."""
    return int(np.random.default_rng([int(seed), 2]).integers(0, int(start_frames)))
