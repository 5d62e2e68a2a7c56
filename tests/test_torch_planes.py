"""Parity of `g4splat_torch.pipeline.planes` and `g4splat_torch.ops.kmeans`
with `g4splat_tpu.pipeline.planes` (and the sklearn KMeans it calls) on the
CPU, on the same seeded numpy inputs:
- k-means: labels identical to `sklearn.cluster.KMeans(8, random_state=seed,
  n_init=1)` on well-separated normals (the box room's six wall directions
  with noise), centres within 1e-4 (sklearn sums each cluster in float32,
  ~1000 rows of size ~1: up to ~6e-5 off the exact mean; the port sums in
  float64);
- normal clusters, plane instance masks and the global merge identical;
- RANSAC planes (same draws) and plane depths within 1e-5, refined depths
  within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

import g4splat_tpu.pipeline.planes as J
import g4splat_torch.pipeline.planes as T
from g4splat_torch.convert import camera_from
from g4splat_torch.ops.kmeans import kmeans
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras

DIRS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                np.float32)


def wall_normals(seed, n=6000, noise=0.03):
    rng = np.random.default_rng(seed)
    x = DIRS[rng.integers(0, 6, n)] + rng.normal(0, noise, (n, 3))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def region_normals(seed, H=48, W=64):
    """Four regions with distinct normals and a little noise."""
    n = np.zeros((H, W, 3), np.float32)
    n[: H // 2, : W // 2] = [0, 0, 1]
    n[: H // 2, W // 2:] = [0, -1, 0]
    n[H // 2:, : W // 2] = [0, 1, 0]
    n[H // 2:, W // 2:] = [1, 0, 0]
    n += np.random.RandomState(seed).randn(H, W, 3) * 0.02
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kmeans_matches_sklearn(seed):
    X = wall_normals(seed)
    km = KMeans(n_clusters=8, random_state=seed, n_init=1).fit(X)
    labels, centers = kmeans(torch.from_numpy(X), 8, seed=seed)
    np.testing.assert_array_equal(labels.numpy(), km.labels_)
    np.testing.assert_allclose(centers.numpy(), km.cluster_centers_, atol=1e-4)


def test_kmeans_zero_rows_centre_exact():
    """A cluster of identical rows (the normal maps' zero border) has its
    centre at exactly those rows in the port (ROADMAP C11: sklearn leaves a
    float32 residual there); the labels are sklearn's."""
    X = wall_normals(4, n=3000)
    X[:300] = 0.0
    km = KMeans(n_clusters=8, random_state=0, n_init=1).fit(X)
    labels, centers = kmeans(torch.from_numpy(X), 8, seed=0)
    np.testing.assert_array_equal(labels.numpy(), km.labels_)
    assert torch.all(centers[labels[0]] == 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_normals_cluster(seed):
    n = region_normals(seed)
    a = J.normals_cluster(n, n.shape[:2])
    b = T.normals_cluster(torch.from_numpy(n), n.shape[:2])
    assert len(a) == len(b) >= 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    ja, jc = J.normals_cluster_1d(n.reshape(-1, 3)[::3])
    ta, tc = T.normals_cluster_1d(torch.from_numpy(n.reshape(-1, 3)[::3].copy()))
    assert len(ja) == len(ta)
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(x, y.numpy())
    np.testing.assert_allclose(tc, jc, atol=1e-5)


@pytest.mark.parametrize("generator", [False, True])
def test_excavator(generator):
    n = region_normals(5)
    gen = None
    if generator:
        def gen(img):
            a = np.zeros(n.shape[:2], bool)
            a[:, :40] = True
            return [a, ~a]
    a = J.PlaneExcavator(J.PlaneExcavatorConfig(), mask_generator=gen)(np.zeros((48, 64, 3)), n)
    b = T.PlaneExcavator(T.PlaneExcavatorConfig(), mask_generator=gen)(
        torch.zeros(48, 64, 3), torch.from_numpy(n))
    np.testing.assert_array_equal(a["seg_mask"], b["seg_mask"])
    np.testing.assert_allclose(b["normal"], a["normal"], atol=1e-6)
    np.testing.assert_array_equal(a["areas"], b["areas"])


@pytest.mark.parametrize("shared", [False, True])
def test_merge_global_planes(shared):
    """Unique pixel ids (the pipeline's: the disjoint route) and ids shared
    across views (the general route)."""
    rng = np.random.default_rng(6)
    H, W = 16, 20
    masks, ids = [], []
    for v in range(4):
        m = np.zeros((H, W), np.int32)
        m[:8, :10], m[8:, :10], m[:, 10:] = 1, 2, 3
        m[rng.integers(0, H, 10), rng.integers(0, W, 10)] = 0
        masks.append(m)
        base = 1 if shared else 1 + v * H * W
        pid = base + np.arange(H * W).reshape(H, W)
        if shared:
            pid = np.roll(pid, v, axis=1)
        ids.append(pid)
    jp, jd = J.merge_global_planes(ids, masks)
    tp, td = T.merge_global_planes(ids, masks)
    assert jd == td
    assert len(jp) == len(tp) > 0
    for x, y in zip(jp, tp):
        np.testing.assert_array_equal(x, y)


def plane_points(seed, n=400):
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(-1, 1, (2, n))
    normal = np.array([0.2, 0.9, 0.3])
    normal /= np.linalg.norm(normal)
    a = np.cross(normal, [1, 0, 0])
    a /= np.linalg.norm(a)
    b = np.cross(normal, a)
    pts = 0.5 * normal + u[:, None] * a + v[:, None] * b + rng.normal(0, 0.002, (n, 1)) * normal
    pts[: n // 10] += rng.normal(0, 0.3, (n // 10, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("prior", [None, (0.0, 1.0, 0.0)])
def test_fit_plane_ransac(prior):
    pts = plane_points(7)
    jn, jc, ji = J.fit_plane_ransac(pts, prior_normal=prior)
    tn, tcen, ti = T.fit_plane_ransac(torch.from_numpy(pts), prior_normal=prior)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(tn, jn, atol=1e-5)
    np.testing.assert_allclose(tcen, jc, atol=1e-5)


def cameras(n=3, W=40, H=30):
    return stack_cameras([lookat_camera([0.4 * np.sin(a), -0.6, -2.5], [0.0, 0.3, 0.0],
                                        [0, -1, 0], 35.0, 35.0, W, H)
                          for a in np.linspace(-0.5, 0.5, n)])


def test_plane_aligned_depth():
    jc = cameras()
    cam = jax.tree.map(lambda x: x[1], jc)
    n, c = np.array([0.1, 0.95, 0.2]), np.array([0.0, 0.5, 0.0])
    a = J.compute_plane_aligned_depth(n, c, cam, (30, 40))
    b = T.compute_plane_aligned_depth(n, c, camera_from(cam, device="cpu"), (30, 40))
    np.testing.assert_allclose(b.numpy(), a, atol=1e-5)
    b2 = T.compute_plane_aligned_depth(n, c + [0, 10, 0], camera_from(cam, device="cpu"),
                                       (30, 40))
    assert (b2 >= 0).all()


def test_refine_depths_with_planes():
    """Three views of a floor and a back wall: noisy depths, plane masks and
    the shared point cloud as the orchestrator builds them."""
    jc = cameras()
    tc = camera_from(jc, device="cpu")
    V, H, W = 3, 30, 40
    floor = J.compute_plane_aligned_depth
    depths, masks, normals, pts, ids = [], [], [], [np.zeros((1, 3), np.float32)], []
    rng = np.random.default_rng(8)
    next_id = 1
    for v in range(V):
        cam = jax.tree.map(lambda x, v=v: x[v], jc)
        d1 = floor([0.0, 1.0, 0.0], [0.0, 0.6, 0.0], cam, (H, W))
        d2 = floor([0.0, 0.0, 1.0], [0.0, 0.0, 1.2], cam, (H, W))
        d1 = np.where(d1 > 0, d1, np.inf)
        d2 = np.where(d2 > 0, d2, np.inf)
        d = np.minimum(d1, d2) * (1 + rng.normal(0, 0.003, (H, W)))
        m = np.where(d1 < d2, 1, 2).astype(np.int32)
        depths.append(d.astype(np.float32))
        masks.append(m)
        nrm = np.where((m == 1)[..., None], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0])
        normals.append((nrm + rng.normal(0, 0.05, nrm.shape)).astype(np.float32))
        p = np.asarray(cam.backproject(jnp.asarray(depths[-1]))).reshape(-1, 3)
        pts.append(p)
        ids.append(np.arange(next_id, next_id + H * W).reshape(H, W))
        next_id += H * W
    depths, normals, pts = np.stack(depths), np.stack(normals), np.concatenate(pts)
    gpts, gdict = J.merge_global_planes(ids, masks)
    jr, jpl = J.refine_depths_with_planes(jc, depths, masks, gdict, pts, gpts,
                                         rend_normals=normals)
    tr, tpl = T.refine_depths_with_planes(tc, torch.from_numpy(depths), masks, gdict,
                                          torch.from_numpy(pts), gpts,
                                          rend_normals=torch.from_numpy(normals))
    assert len(jpl) == len(tpl) == 6
    assert np.abs(jr - depths).max() > 1e-3
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-4)
    for a, b in zip(jpl, tpl):
        assert (a["id"], a["n_inliers"], a["n_points"]) == (b["id"], b["n_inliers"], b["n_points"])
        np.testing.assert_allclose(b["center"], a["center"], atol=1e-5)
