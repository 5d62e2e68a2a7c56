"""Parity of `g4splat_torch.pipeline.novel_views` with
`g4splat_tpu.pipeline.novel_views` on the CPU: the visibility grid
identical, the three proposers' cameras within 1e-5, covisibility and
none-visible rates equal, and `select_need_inpaint_views` (the same
`random.Random(seed)` shuffles) returning the same ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.pipeline.novel_views as J
import g4splat_torch.pipeline.novel_views as T
from g4splat_torch.core.cameras import camera_at
from g4splat_torch.eval.synthetic import inward_cameras
from g4splat_tpu.core import cameras as jcam

TOL = 1e-5
W, H = 64, 48


def jax_cameras(tc):
    return jcam.stack_cameras([
        jcam.make_camera(*(getattr(camera_at(tc, v), k).numpy()
                           for k in ("w2c", "fx", "fy", "cx", "cy")), tc.width, tc.height)
        for v in range(tc.w2c.shape[0])])


@pytest.fixture(scope="module")
def setup():
    tc = inward_cameras(4, W, H, device="cpu")
    rng = np.random.default_rng(0)
    depths = (1.5 + rng.uniform(0, 1.0, (4, 1, 1))
              + 0.3 * np.linspace(0, 1, W)[None, None, :]).astype(np.float32)
    depths = np.broadcast_to(depths, (4, H, W)).copy()
    depths[1, :5] = 0.0
    return tc, jax_cameras(tc), depths


@pytest.mark.parametrize("res", [8, 24])
def test_visibility_grid(setup, res):
    tc, jc, depths = setup
    lo, hi = np.array([-1.5, -1.0, -1.5], np.float32), np.array([1.5, 1.0, 1.5], np.float32)
    jg = J.VisibilityGrid(lo, hi, res, jc, depths)
    tg = T.VisibilityGrid(lo, hi, res, tc, torch.from_numpy(depths))
    assert 0 < jg.grid.mean() < 1
    np.testing.assert_array_equal(jg.grid, tg.grid)
    pts = np.random.default_rng(1).uniform(-2, 2, (500, 3))
    np.testing.assert_array_equal(jg.is_visible(pts), tg.is_visible(pts))


def test_degenerate_box_is_padded(setup):
    tc, jc, depths = setup
    lo = np.array([-1.0, 0.5, -1.0], np.float32)
    hi = np.array([1.0, 0.5, 1.0], np.float32)
    jg = J.VisibilityGrid(lo, hi, 8, jc, depths)
    tg = T.VisibilityGrid(lo, hi, 8, tc, torch.from_numpy(depths))
    np.testing.assert_array_equal(jg.bbox_min, tg.bbox_min)
    np.testing.assert_array_equal(jg.grid, tg.grid)


def check_cams(j, t):
    assert (j is None) == (t is None)
    if j is None:
        return
    for k in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)), atol=TOL)
    assert (t.width, t.height) == (j.width, j.height)


@pytest.mark.parametrize("with_grid", [False, True])
def test_object_centric(setup, with_grid):
    tc, jc, depths = setup
    cfg_j, cfg_t = J.ProposalConfig(n_frames=12, width=W, height=H), \
        T.ProposalConfig(n_frames=12, width=W, height=H)
    jg = tg = None
    if with_grid:
        lo, hi = np.array([-1.5, -1.0, -1.5], np.float32), np.array([1.5, 1.0, 1.5], np.float32)
        jg = J.VisibilityGrid(lo, hi, 16, jc, depths)
        tg = T.VisibilityGrid(lo, hi, 16, tc, torch.from_numpy(depths))
    check_cams(J.propose_object_centric(jc, jg, cfg=cfg_j),
               T.propose_object_centric(tc, tg, cfg=cfg_t))


def test_look_around_and_plane_targeted(setup):
    tc, jc, _ = setup
    check_cams(J.propose_look_around(jc, J.ProposalConfig(width=W, height=H), n_per_view=5),
               T.propose_look_around(tc, T.ProposalConfig(width=W, height=H), n_per_view=5))
    rng = np.random.default_rng(2)
    centers = rng.uniform(-1, 1, (6, 3))
    normals = rng.normal(size=(6, 3))
    normals[0] = [0.0, 1.0, 0.0]
    check_cams(J.propose_plane_targeted(jc, centers, normals,
                                        cfg=J.ProposalConfig(width=W, height=H)),
               T.propose_plane_targeted(tc, centers, normals,
                                        cfg=T.ProposalConfig(width=W, height=H)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection(setup, seed):
    tc, jc, _ = setup
    cand_t = T.propose_look_around(tc, T.ProposalConfig(width=W, height=H), n_per_view=6)
    cand_j = J.propose_look_around(jc, J.ProposalConfig(width=W, height=H), n_per_view=6)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.5, 1.5, (3000, 3)).astype(np.float32)
    alphas = rng.uniform(size=(24, H, W)).astype(np.float32) ** rng.uniform(0.3, 3, (24, 1, 1))
    alphas = alphas.astype(np.float32)
    rates_j = [J.none_visible_rate_from_alpha(a) for a in alphas]
    rates_t = [T.none_visible_rate_from_alpha(torch.from_numpy(a)) for a in alphas]
    assert rates_j == rates_t
    for i, k in ((0, 1), (2, 9), (5, 5)):
        assert J.covisibility_by_splats(jcam_at(cand_j, i), jcam_at(cand_j, k), jnp.asarray(xyz)) \
            == T.covisibility_by_splats(camera_at(cand_t, i), camera_at(cand_t, k),
                                        torch.from_numpy(xyz))
    for num, lo, hi in ((4, 0.05, 0.5), (10, 0.2, 0.6), (3, 0.9, 0.95)):
        j = J.select_need_inpaint_views(cand_j, rates_j, jnp.asarray(xyz), select_num=num,
                                        low_bound=lo, high_bound=hi, seed=seed)
        t = T.select_need_inpaint_views(cand_t, rates_t, torch.from_numpy(xyz), select_num=num,
                                        low_bound=lo, high_bound=hi, seed=seed)
        assert j == t and len(t) > 0


def jcam_at(c, i):
    import jax

    return jax.tree.map(lambda x: x[i], c)
