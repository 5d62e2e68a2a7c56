"""Parity of g4splat_torch's TSDF evaluation and the geometry it reads
(Camera.project, interpolate_cameras, rotmat_to_quat, bilinear_sample,
points_to_depth) with g4splat_tpu on the CPU.

Inputs are seeded numpy arrays fed to both packages. Tolerances: 1e-5 for
the geometry and for the fused tsdf, colours and weights (float32 taken in
another order; weights, sums of up to V·e^T softmax terms, 1e-5 relative);
apply_sdf_tolerance and dilate_depth_along_normals 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import camera_from
from g4splat_torch.core import cameras as tcam
from g4splat_torch.core import geometry as tgeo
from g4splat_torch.core import transforms as ttr
from g4splat_torch.ops import tsdf as ttsdf
from g4splat_tpu.core import cameras as jcam
from g4splat_tpu.core import geometry as jgeo
from g4splat_tpu.core import transforms as jtr
from g4splat_tpu.ops import tsdf as jtsdf

ATOL = 1e-5
W, H, V, N = 32, 24, 3, 4096


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, atol=ATOL, rtol=0.0):
    t = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), atol=atol, rtol=rtol)


def close_tsdf(t, j):
    """tsdf and colours within 1e-5; weights within 1e-5 relative."""
    close(t.tsdf, j.tsdf)
    close(t.colors, j.colors)
    close(t.weights, j.weights, rtol=ATOL)


def jax_cameras(w=W, h=H, n=V):
    cams = [jcam.lookat_camera([2.0 * np.sin(a), -0.3 + 0.2 * i, -2.0 * np.cos(a)],
                               [0.05 * i, 0.0, 0.1], [0, -1, 0], fx=28.0 + i, fy=27.0,
                               width=w, height=h, znear=0.05, zfar=50.0)
            for i, a in enumerate(np.linspace(-0.6, 0.6, n))]
    return jcam.stack_cameras(cams)


def smooth(rng, shape, scale):
    """A smooth random field: a coarse grid upsampled by repetition, blurred."""
    coarse = rng.randn(*((shape[0] // 4 + 1, shape[1] // 4 + 1) + shape[2:]))
    f = np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:shape[0], :shape[1]]
    return (scale * (f + np.roll(f, 1, 0) + np.roll(f, 1, 1)) / 3).astype(np.float32)


def tsdf_inputs(seed=0):
    rng = np.random.RandomState(seed)
    depths = np.stack([2.0 + smooth(rng, (H, W), 0.15) for _ in range(V)])
    depths[0, :3, :5] = 0.0                 # unobserved pixels
    images = rng.rand(V, H, W, 3).astype(np.float32)
    nrm = rng.randn(V, H, W, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ref = nrm + 0.8 * rng.randn(V, H, W, 3).astype(np.float32)
    ref /= np.linalg.norm(ref, axis=-1, keepdims=True)
    pts = rng.uniform(-0.6, 0.6, (N, 3)).astype(np.float32)
    pts[:64] *= 8.0                         # outside the frustum or behind
    return pts, images, depths, nrm, ref


OPTIONS = {
    "default": {},
    "nearest": dict(interpolation_mode="nearest"),
    "no_interpolation": dict(interpolate_depth=False),
    "depth_gradient_weighting": dict(weight_interpolation_by_depth_gradient=True,
                                     depth_gradient_threshold=0.05),
    "depth_gradient_filter": dict(filter_with_depth_gradient=True,
                                  depth_gradient_threshold_for_filtering=0.05),
    "unbiased": dict(unbias_depth_using_normals=True),
    "softmax": dict(weight_by_softmax=True, softmax_temperature=2.0),
    "normal_consistency_filter": dict(filter_with_normal_consistency=True,
                                      normal_consistency_threshold=0.5),
    "normal_consistency_weight": dict(weight_by_normal_consistency=True),
    "binary_opacity": dict(use_binary_opacity=True),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_integrate_views(option):
    pts, images, depths, nrm, ref = tsdf_inputs()
    kw = dict(trunc_margin=0.2, **OPTIONS[option])
    jc = jax_cameras()
    j = jtsdf.integrate_views(jnp.asarray(pts), jc, jnp.asarray(images), jnp.asarray(depths),
                              jtsdf.TSDFConfig(**kw), normals=jnp.asarray(nrm),
                              reference_normals=jnp.asarray(ref))
    t = ttsdf.integrate_views(torch.from_numpy(pts), camera_from(jc, device="cpu"),
                              torch.from_numpy(images), torch.from_numpy(depths),
                              ttsdf.TSDFConfig(**kw), normals=torch.from_numpy(nrm),
                              reference_normals=torch.from_numpy(ref))
    observed = np.asarray(j.weights) > 0
    assert 0.2 < observed.mean() < 0.99, observed.mean()
    close_tsdf(t, j)


def test_chunked_equals_unchunked():
    pts, images, depths, _, _ = tsdf_inputs(1)
    cams = camera_from(jax_cameras(), device="cpu")
    cfg = ttsdf.TSDFConfig(trunc_margin=0.2)
    args = (cams, torch.from_numpy(images), torch.from_numpy(depths), cfg)
    whole = ttsdf.integrate_views(torch.from_numpy(pts), *args)
    chunked = ttsdf.integrate_views_chunked(pts, *args, chunk=1000)
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)
    j = jtsdf.integrate_views_chunked(pts, jax_cameras(), jnp.asarray(images),
                                      jnp.asarray(depths), jtsdf.TSDFConfig(trunc_margin=0.2),
                                      chunk=1000)
    close_tsdf(chunked, j)
    empty = ttsdf.integrate_views_chunked(np.zeros((0, 3), np.float32), *args)
    assert [tuple(x.shape) for x in empty] == [(0,), (0, 3), (0,)]


def test_apply_sdf_tolerance():
    rng = np.random.RandomState(2)
    d = 1.0 + 2.0 * rng.rand(V, H, W).astype(np.float32)
    focals = np.array([20.0, 32.0, 50.0], np.float32)
    for max_tol in (0.01, 1e8):
        j = jax.vmap(lambda x, f: jtsdf.apply_sdf_tolerance(x, f, 1.5, max_tol))(
            jnp.asarray(d), jnp.asarray(focals))
        t = ttsdf.apply_sdf_tolerance(torch.from_numpy(d), torch.from_numpy(focals)[:, None, None],
                                      1.5, max_tol)
        close(t, j)


@pytest.mark.parametrize("seed", [0, 1])
def test_dilate_depth_along_normals(seed):
    rng = np.random.RandomState(seed)
    jc = jcam.lookat_camera([0.1, -0.2, -2.0], [0, 0, 0], [0, -1, 0], fx=30.0, fy=29.0,
                            width=W, height=H)
    depth = 2.0 + smooth(rng, (H, W), 0.2)
    depth[5:8, 4:9] = 0.0
    rgb = rng.rand(H, W, 3).astype(np.float32)
    jd, jr = jtsdf.dilate_depth_along_normals(jc, jnp.asarray(depth), jnp.asarray(rgb),
                                              dilation_px=1.5, max_dilation=0.05)
    td, tr = ttsdf.dilate_depth_along_normals(camera_from(jc, device="cpu"),
                                              torch.from_numpy(depth), torch.from_numpy(rgb),
                                              dilation_px=1.5, max_dilation=0.05)
    assert not np.array_equal(np.asarray(jd), depth)   # the dilation moved something
    close(td, jd)
    close(tr, jr)


class TestGeometry:
    def test_project(self):
        jc = jax_cameras()
        pts = np.random.RandomState(3).uniform(-1, 1, (500, 3)).astype(np.float32)
        for i in range(V):
            cj = jax.tree.map(lambda x, i=i: x[i], jc)
            xy_j, z_j = cj.project(jnp.asarray(pts))
            xy_t, z_t = camera_from(cj, device="cpu").project(torch.from_numpy(pts))
            close(xy_t, xy_j)
            close(z_t, z_j)
            close(tgeo.points_to_depth(camera_from(cj, device="cpu"), torch.from_numpy(pts)),
                  jgeo.points_to_depth(cj, jnp.asarray(pts)))

    @pytest.mark.parametrize("channels", [None, 3])
    def test_bilinear_sample(self, channels):
        rng = np.random.RandomState(4)
        img = rng.rand(*((H, W) if channels is None else (H, W, channels))).astype(np.float32)
        xy = np.concatenate([rng.uniform(-3, W + 3, (400, 1)), rng.uniform(-3, H + 3, (400, 1))],
                            1).astype(np.float32)
        xy[:4] = [[W - 1, H - 1], [W - 1.5, 0], [0, H - 1], [W - 2, H - 2]]
        close(tgeo.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy)),
              jgeo.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))

    def test_rotmat_to_quat(self):
        q = np.random.RandomState(5).randn(256, 4).astype(np.float32)
        q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
        R = np.asarray(jtr.quat_to_rotmat(jnp.asarray(q)))
        close(ttr.rotmat_to_quat(torch.from_numpy(R)), jtr.rotmat_to_quat(jnp.asarray(R)))

    @pytest.mark.parametrize("n_neighbors,per", [(2, 10), (1, 3)])
    def test_interpolate_cameras(self, n_neighbors, per):
        jc = jax_cameras(n=4)
        j = jcam.interpolate_cameras(jc, n_neighbors, per)
        t = tcam.interpolate_cameras(camera_from(jc, device="cpu"), n_neighbors, per)
        assert t.w2c.shape == (4 * n_neighbors * per, 4, 4)
        assert (t.width, t.height, t.znear, t.zfar) == (j.width, j.height, j.znear, j.zfar)
        for k in ("w2c", "fx", "fy", "cx", "cy"):
            close(getattr(t, k), getattr(j, k))
