"""The benchmark's torch renderer against the port's synthetic corridor."""

import numpy as np
import pytest
import torch

from ldso_bench.harness import scene
from ldso_tpu_torch.io import synthetic


@pytest.mark.parametrize("seed", [0, 7])
def test_render_matches_synthetic_at_a_small_size(seed):
    sc = synthetic.make_scene(seed, "corridor")
    texs = [torch.as_tensor(p.tex) for p in sc.planes]
    poses = scene.walk_poses(12, 0.06)
    w, h = 48, 32
    f = 0.88 * w
    intr = (f, f, w / 2 - 0.5, h / 2 - 0.5)
    idx = [0, 5, 11, 12, 17, 23]
    want = np.stack([sc.render(poses[i], intr, w, h, supersample=1)[0] for i in idx])
    got = scene.render(texs, poses[idx], intr, w, h).numpy()
    np.testing.assert_array_equal(got, want)


def test_value_noise_matches_synthetic():
    rng = np.random.default_rng(11)
    normals = [rng.standard_normal((8 << o, 8 << o)) for o in range(5)]
    want = synthetic.value_noise_texture(np.random.default_rng(11), size=64)
    got = scene.value_noise([torch.as_tensor(n) for n in normals], size=64).numpy()
    np.testing.assert_array_equal(got, want)


def test_walk_is_the_multi_pass_path_and_wraps_without_a_seam():
    n, step = 10, 0.06
    ring = scene.walk_poses(n, step)
    np.testing.assert_allclose(ring, synthetic.trajectory(4 * n, "multi_pass", step)[:2 * n])
    two = np.concatenate([ring, ring])
    dz = np.diff(two[:, 2, 3])
    np.testing.assert_allclose(np.abs(dz), step)


def test_textures_come_from_their_seed():
    a, b = scene.textures(1, "cpu"), scene.textures(2, "cpu")
    assert len(a) == len(scene.PLANES)
    assert not torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a, scene.textures(1, "cpu")))
    assert all(20.0 <= float(t.min()) and float(t.max()) <= 235.0 + 1e-3 for t in a)


def test_the_run_seed_draws_the_start_frame_only():
    starts = [scene.ring_start(s, 32) for s in range(3000000000, 3000000040)]
    assert all(0 <= x < 32 for x in starts)
    assert len(set(starts)) > 10
    assert starts == [scene.ring_start(s, 32) for s in range(3000000000, 3000000040)]
    assert 0 <= scene.ring_start(2 ** 31 + 12345, 32) < 32


def test_large_seed_is_taken():
    t = scene.textures(2 ** 31 + 12345, "cpu")
    assert t[0].shape == (scene.TEXTURE_SIZE, scene.TEXTURE_SIZE)
