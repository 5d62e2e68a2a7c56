"""Parity of `g4splat_torch.pipeline.gaussian_init` with
`g4splat_tpu.pipeline.gaussian_init` on the CPU: three views of a floor and
a back wall (seeded noisy depths with a block of zeros in view 1, random
images), the same numpy inputs through both. Both init paths agree within
1e-5 (means, scales, colours; quaternions up to sign, q and -q being one
rotation); `scene_from_init` drops the same non-finite rows and seeds the
same scene.

A pixel of depth ≤ 0 has no surface point in the port, and its faces are
dropped (ROADMAP C12); the JAX package keeps them. So the manifold-mesh
init is compared with the JAX init under the visibility mask depth > 0, and
the faces that mask takes out are counted: at depth 0 (view 1's block) the
three coincident vertices at the camera centre, at depth -0.5 faces behind
the camera.
"""

import jax
import numpy as np
import pytest
import torch

import g4splat_tpu.pipeline.gaussian_init as J
import g4splat_torch.pipeline.gaussian_init as T
from g4splat_torch.convert import camera_from
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras
from g4splat_tpu.pipeline.planes import compute_plane_aligned_depth

V, H, W = 3, 18, 24
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def views():
    jc = stack_cameras([lookat_camera([0.4 * np.sin(a), -0.5, -2.0], [0.0, 0.3, 0.6],
                                      [0, -1, 0], 22.0, 22.0, W, H)
                        for a in np.linspace(-0.5, 0.5, V)])
    rng = np.random.default_rng(0)
    depths = []
    for v in range(V):
        cam = jax.tree.map(lambda x, v=v: x[v], jc)
        d1 = compute_plane_aligned_depth([0, 1, 0], [0, 0.6, 0], cam, (H, W))
        d2 = compute_plane_aligned_depth([0, 0, 1], [0, 0, 1.2], cam, (H, W))
        d1, d2 = np.where(d1 > 0, d1, np.inf), np.where(d2 > 0, d2, np.inf)
        depths.append((np.minimum(d1, d2) * (1 + rng.normal(0, 0.002, (H, W))))
                      .astype(np.float32))
    depths = np.stack(depths)
    depths[1, 3:5, 4:9] = 0.0
    images = rng.uniform(size=(V, H, W, 3)).astype(np.float32)
    return jc, camera_from(jc, device="cpu"), depths, images


def same_parts(j, t):
    assert set(j) == set(t)
    for k in j:
        a, b = np.asarray(j[k]), t[k].numpy()
        assert a.shape == b.shape and len(a) > 0, k
        d = np.abs(a - b)
        if k == "quaternions":
            d = np.minimum(d, np.abs(a + b))
        assert d.max() <= TOL, (k, d.max())


# Quads of the 2×5 block: 1×4, two faces each (the faces between the block
# and its neighbours fail the altitude ratio in both packages); the voxel
# grid keeps one of the eight.
@pytest.mark.parametrize("block, voxel, dropped", [(0.0, 0.0, 8), (0.0, 0.05, 1),
                                                   (-0.5, 0.0, 8)],
                         ids=["0.0", "0.05", "behind"])
def test_manifold_mesh_init(views, block, voxel, dropped):
    jc, tc, depths, images = views
    depths = depths.copy()
    depths[1, 3:5, 4:9] = block
    j_all = J.init_from_manifold_meshes(jc, depths, images, voxel_downsample=voxel)
    j = J.init_from_manifold_meshes(jc, depths, images, visibility_masks=depths > 0,
                                    voxel_downsample=voxel)
    t = T.init_from_manifold_meshes(tc, torch.from_numpy(depths), torch.from_numpy(images),
                                    voxel_downsample=voxel)
    assert len(j_all["means"]) - len(j["means"]) == dropped
    same_parts(j, t)
    assert float(t["scales"].min()) > 1e-4


def test_manifold_mesh_init_visibility_mask(views):
    jc, tc, depths, images = views
    vis = depths > 0.0
    vis[0, :, :6] = False
    j = J.init_from_manifold_meshes(jc, depths, images, visibility_masks=vis)
    t = T.init_from_manifold_meshes(tc, torch.from_numpy(depths), torch.from_numpy(images),
                                    visibility_masks=torch.from_numpy(vis))
    same_parts(j, t)


@pytest.mark.parametrize("grid, max_scale", [(-1, 0.05), (2, 1.0)])
def test_warp_init(views, grid, max_scale):
    jc, tc, depths, images = views
    j = J.init_by_warp_from_depths(jc, depths, images, max_scale=max_scale,
                                   downsample_pixel_grid_size=grid)
    t = T.init_by_warp_from_depths(tc, torch.from_numpy(depths), torch.from_numpy(images),
                                   max_scale=max_scale, downsample_pixel_grid_size=grid)
    same_parts(j, t)


def test_scene_from_init_drops_nan_rows(views):
    jc, tc, depths, images = views
    parts = J.init_from_manifold_meshes(jc, depths, images)
    parts = {k: np.array(v) for k, v in parts.items()}
    parts["means"][[3, 17]] = np.nan
    parts["scales"][40, 1] = np.inf
    n = len(parts["means"])
    js = J.scene_from_init(parts, capacity=n + 64)
    ts = T.scene_from_init({k: torch.from_numpy(v) for k, v in parts.items()},
                           capacity=n + 64)
    assert int(ts.num_alive) == int(np.asarray(js.alive).sum()) == n - 3
    for k in ("xyz", "f_dc", "opacity_raw", "scaling_raw", "rotation_raw", "alive"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   atol=TOL, err_msg=k)
    assert torch.isfinite(ts.xyz).all()
