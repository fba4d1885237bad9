"""frame_step.fused_step of the port against the JAX package: the packed
per-frame diag vector element-wise (DIAG_* layout) and the traced bank."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import frame_step as jfs
from ldso_tpu import trace as jtrace
from ldso_tpu import tracker as jtr
from ldso_tpu.config import preset
from ldso_tpu.core import bank as jbank
from ldso_tpu.core import window as jwin
from ldso_tpu.math import lie as jl
from ldso_tpu_torch import convert
from ldso_tpu_torch import frame_step as tfs
from ldso_tpu_torch import tracker as ttr
from ldso_tpu_torch.io import synthetic

CFG = preset("tiny")


@pytest.fixture(scope="module")
def step_inputs():
    ds = synthetic.SyntheticDataset(w=256, h=192, n=2, seed=0, supersample=1)
    ds.poses_w_c = synthetic.trajectory(2, "forward_arc", step=0.12)
    ds._cache = {}
    imgs = [np.clip(np.round(ds.get_image(i)[0]), 0, 255).astype(np.uint8) for i in range(2)]
    rng = np.random.default_rng(1)
    idep = ds.get_idepth(0)
    img0 = imgs[0].astype(np.float32)
    gy, gx = np.gradient(img0)
    g2 = gx ** 2 + gy ** 2
    ok = (idep > 1e-3) & (g2 > np.percentile(g2, 60))
    ok[:8] = ok[-8:] = False
    ok[:, :8] = ok[:, -8:] = False
    cand = np.argwhere(ok)
    sel = cand[rng.choice(len(cand), size=600, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], -1).astype(np.float32)
    d = idep[sel[:, 0], sel[:, 1]].astype(np.float32)
    # tracker reference: the first 400 points
    ref = [uv[:400], d[:400], img0[sel[:400, 0], sel[:400, 1]], np.ones(400, bool)]
    # bank: the other 200 as candidates of slot 0; half never traced,
    # half with an interval around the ground truth
    b = {f: np.array(v) for f, v in jbank.empty_bank(CFG.shapes.max_immature)._asdict().items()}
    n = 200
    b["valid"][:n] = True
    b["uv"][:n] = uv[400:]
    pu = (uv[400:, None, :] + np.asarray(jwin.PATTERN_OFFSETS)[None]).astype(int)
    b["color"][:n] = img0[pu[..., 1], pu[..., 0]]
    b["idepth_min"][100:n] = d[500:] * 0.8
    b["idepth_max"][100:n] = d[500:] * 1.25
    b["last_status"][100:n] = jtrace.GOOD
    F = CFG.shapes.max_frames
    w = dict(T_eval=np.broadcast_to(np.eye(4, dtype=np.float32), (F, 4, 4)).copy(),
             x=np.zeros((F, 8), np.float32), exposure=np.ones(F, np.float32))
    T_gt = (ds.gt_pose_c_w(1) @ ds.poses_w_c[0])
    T_last = np.asarray(jl.se3_exp(0.5 * jl.se3_log(jnp.asarray(T_gt, jnp.float64))), np.float32)
    return dict(img=imgs[1], ref=ref, bank=b, win=w, T_last=T_last,
                T_prelast=np.eye(4, dtype=np.float32), intr=ds.intrinsics(), T_gt=T_gt)


def test_fused_step_diag_and_bank(step_inputs):
    s = step_inputs
    j_ref = jtr.make_tracker_ref(*map(jnp.asarray, s["ref"]), CFG.shapes.pyr_levels)
    a = jfs.fused_step(
        jnp.asarray(s["img"]), j_ref, jnp.asarray(s["T_last"]), jnp.asarray(s["T_prelast"]),
        jnp.zeros(2, jnp.float32), jbank.Bank(**{f: jnp.asarray(v) for f, v in s["bank"].items()}),
        *(jnp.asarray(s["win"][k]) for k in ("T_eval", "x", "exposure")),
        jnp.eye(4, dtype=jnp.float32), jnp.asarray(s["intr"]), jnp.float32(1.0), CFG)
    t_ref = ttr.make_tracker_ref(*map(torch.tensor, s["ref"]), CFG.shapes.pyr_levels)
    b = tfs.fused_step(
        torch.tensor(s["img"]), t_ref, torch.tensor(s["T_last"]), torch.tensor(s["T_prelast"]),
        torch.zeros(2), convert.from_numpy("bank", s["bank"], device="cpu"),
        *(torch.tensor(s["win"][k]) for k in ("T_eval", "x", "exposure")),
        torch.eye(4), torch.tensor(s["intr"]), 1.0, CFG)

    dj, dt = np.asarray(a.diag), b.diag.numpy()
    assert dt.shape == (tfs.DIAG_LEN,) and dt.dtype == np.float32
    # the winning refToNew pose after the full LM ladder in f32
    np.testing.assert_allclose(dt[tfs.DIAG_T:], dj[jfs.DIAG_T:], atol=2e-4)
    np.testing.assert_allclose(dt[tfs.DIAG_RMSE0], dj[jfs.DIAG_RMSE0], rtol=2e-3)
    for k in (tfs.DIAG_FLOW_T, tfs.DIAG_FLOW_RT, tfs.DIAG_FLOW_R, tfs.DIAG_KF_DELTA):
        np.testing.assert_allclose(dt[k], dj[k], rtol=2e-3)
    for k in (tfs.DIAG_FRAC_SAT, tfs.DIAG_FRAC_OOB, tfs.DIAG_A_ABS, tfs.DIAG_B_ABS,
              tfs.DIAG_A_REL, tfs.DIAG_B_REL):
        np.testing.assert_allclose(dt[k], dj[k], atol=2e-3)
    T = dt[tfs.DIAG_T:].reshape(4, 4).astype(np.float64)
    assert np.abs(T - s["T_gt"]).max() < 1e-2        # and it tracked

    # the traced bank: statuses are thresholds on f32 SSDs (allow 2% flips)
    st_j, st_t = np.asarray(a.bank.last_status), b.bank.last_status.numpy()
    assert (st_j == st_t).mean() >= 0.98
    assert (np.asarray(a.bank.valid) == b.bank.valid.numpy()).mean() >= 0.98
    good = (st_j == jtrace.GOOD) & (st_t == jtrace.GOOD)
    assert good.sum() > 50
    for f in ("idepth_min", "idepth_max", "quality"):
        np.testing.assert_allclose(getattr(b.bank, f).numpy()[good],
                                   np.asarray(getattr(a.bank, f))[good], rtol=2e-3, atol=1e-4)
    # the pyramid the step built (uint8 frame widened on the way in)
    for l in range(CFG.shapes.pyr_levels):
        np.testing.assert_allclose(b.pyr[l].numpy(), np.asarray(a.pyr[l]), rtol=1e-6, atol=1e-4)
