"""Parity of `g4splat_torch.pipeline.confidence` with
`g4splat_tpu.pipeline.confidence` on the CPU: four views of a room corner
(a floor and a back wall, depths with per-view noise so that some points
disagree), the same seeded numpy inputs through both. Visibility, pixel
coordinates, covisibility counts and confident maps identical; harmonized
images identical (a copy of some view's pixel, or unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.pipeline.confidence as J
import g4splat_torch.pipeline.confidence as T
from g4splat_torch.convert import camera_from
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras
from g4splat_tpu.pipeline.planes import compute_plane_aligned_depth

V, H, W = 4, 24, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    jc = stack_cameras([lookat_camera([0.5 * np.sin(a), -0.5, -2.2], [0.0, 0.3, 0.6],
                                      [0, -1, 0], 28.0, 28.0, W, H)
                        for a in np.linspace(-0.7, 0.7, V)])
    rng = np.random.default_rng(0)
    depths, masks = [], []
    for v in range(V):
        cam = jax.tree.map(lambda x, v=v: x[v], jc)
        d1 = compute_plane_aligned_depth([0, 1, 0], [0, 0.6, 0], cam, (H, W))
        d2 = compute_plane_aligned_depth([0, 0, 1], [0, 0, 1.2], cam, (H, W))
        d1, d2 = np.where(d1 > 0, d1, np.inf), np.where(d2 > 0, d2, np.inf)
        d = np.minimum(d1, d2) * (1 + rng.normal(0, 0.04, (H, W)) * (v % 2))
        depths.append(d.astype(np.float32))
        masks.append(np.where(d1 < d2, 1, 2).astype(np.int32))
    images = rng.uniform(size=(V, H, W, 3)).astype(np.float32)
    return jc, camera_from(jc, device="cpu"), np.stack(depths), masks, images


def test_project_visibility(scene):
    jc, tc, depths, _, _ = scene
    pts = np.random.default_rng(1).uniform([-1, -0.5, -0.5], [1, 0.6, 1.2], (3000, 3))
    pts = pts.astype(np.float32)
    jv, jx = J.project_visibility(jc, jnp.asarray(pts), jnp.asarray(depths))
    tv, tx = T.project_visibility(tc, torch.from_numpy(pts), torch.from_numpy(depths))
    assert tx.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_build_visibility_masks(scene):
    jc, tc, depths, _, _ = scene
    jcnt, jm = J.build_visibility_masks(jc, depths)
    tcnt, tm = T.build_visibility_masks(tc, torch.from_numpy(depths))
    assert 0 < jm.mean() < 1
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    np.testing.assert_array_equal(tm.numpy(), jm)


@pytest.mark.parametrize("n_input", [1, 2])
def test_compute_confidence_maps(scene, n_input):
    jc, tc, depths, _, images = scene
    pts = np.concatenate([
        np.asarray(jax.tree.map(lambda x, v=v: x[v], jc).backproject(jnp.asarray(depths[v])))
        .reshape(-1, 3)[::2] for v in range(V)]).astype(np.float32)
    j = J.compute_confidence_maps(jc, pts, depths, images, n_input)
    t = T.compute_confidence_maps(tc, torch.from_numpy(pts), torch.from_numpy(depths),
                                  torch.from_numpy(images), n_input)
    assert 0 < j.confident_maps[n_input:].mean() < 1
    np.testing.assert_array_equal(t.visibility.numpy(), j.visibility)
    np.testing.assert_array_equal(t.confident_maps.numpy(), j.confident_maps)
    assert np.abs(j.harmonized_images - images).max() > 0
    np.testing.assert_array_equal(t.harmonized_images.numpy(), j.harmonized_images)


@pytest.mark.parametrize("anchors", [[2, 3], [3], [0]])
def test_anchor_plane_color_harmonize(scene, anchors):
    jc, tc, depths, masks, images = scene
    gdict = {0: [(v, 1) for v in range(V)], 1: [(v, 2) for v in range(V)]}
    j = J.anchor_plane_color_harmonize(jc, depths, images, masks, gdict, anchors)
    t = T.anchor_plane_color_harmonize(tc, torch.from_numpy(depths), torch.from_numpy(images),
                                       masks, gdict, anchors)
    assert np.abs(j - images).max() > 0
    np.testing.assert_array_equal(t.numpy(), j)
