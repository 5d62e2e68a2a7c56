"""Parity of g4splat_torch.core with g4splat_tpu.core on the CPU.

Inputs are made with numpy from a seed and fed to both packages; results must
agree to atol 1e-5 (float32 arithmetic taken in a different order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.core import cameras as tcam
from g4splat_torch.core import geometry as tgeo
from g4splat_torch.core import sh as tsh
from g4splat_torch.core import transforms as ttr
from g4splat_tpu.core import cameras as jcam
from g4splat_tpu.core import geometry as jgeo
from g4splat_tpu.core import sh as jsh
from g4splat_tpu.core import transforms as jtr

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=atol, rtol=0)


def rng_quats(seed, n):
    return np.random.RandomState(seed).randn(n, 4).astype(np.float32)


def rand_pose(seed):
    rng = np.random.RandomState(seed)
    R = np.asarray(jtr.quat_to_rotmat(jnp.asarray(rng.randn(4).astype(np.float32))))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = rng.uniform(-2, 2, 3)
    return w2c


def camera_pair(seed=0, w=40, h=30):
    rng = np.random.RandomState(seed + 100)
    args = (rand_pose(seed), *rng.uniform(30, 60, 2).astype(np.float32),
            *(rng.uniform(0.3, 0.7, 2) * [w, h]).astype(np.float32), w, h)
    return (tcam.make_camera(*args, znear=0.05, zfar=50.0, device="cpu"),
            jcam.make_camera(*args, znear=0.05, zfar=50.0))


class TestTransforms:
    def test_normalize(self):
        v = np.random.RandomState(0).randn(32, 3).astype(np.float32)
        v[0] = 0.0
        close(ttr.normalize(torch.from_numpy(v)), jtr.normalize(jnp.asarray(v)))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_quat_to_rotmat(self, seed):
        q = rng_quats(seed, 64)
        close(ttr.quat_to_rotmat(torch.from_numpy(q)), jtr.quat_to_rotmat(jnp.asarray(q)))



class TestSH:
    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_eval_sh_and_rgb(self, degree):
        rng = np.random.RandomState(degree)
        coeffs = rng.randn(50, 16, 3).astype(np.float32) * 0.5
        dirs = np.array(jtr.normalize(jnp.asarray(rng.randn(50, 3).astype(np.float32))))
        tc, td = torch.from_numpy(coeffs), torch.from_numpy(dirs)
        jc, jd = jnp.asarray(coeffs), jnp.asarray(dirs)
        close(tsh.eval_sh(degree, tc, td), jsh.eval_sh(degree, jc, jd))
        close(tsh.sh_to_rgb(degree, tc, td), jsh.sh_to_rgb(degree, jc, jd))

    def test_rgb_to_sh0(self):
        rgb = np.random.RandomState(9).rand(10, 3).astype(np.float32)
        close(tsh.rgb_to_sh0(torch.from_numpy(rgb)), jsh.rgb_to_sh0(jnp.asarray(rgb)))
        assert tsh.num_sh_coeffs(3) == jsh.num_sh_coeffs(3) == 16


class TestCameras:
    @pytest.mark.parametrize("attr", ["w2c", "c2w", "center", "projection",
                                      "full_proj", "ndc2pix", "world2pix"])
    def test_matrices(self, attr):
        tc, jc = camera_pair(1)
        close(getattr(tc, attr), getattr(jc, attr), atol=ATOL)

    def test_pixel_rays_backproject(self):
        tc, jc = camera_pair(2)
        to, td = tc.pixel_rays()
        jo, jd = jc.pixel_rays()
        close(to, jo)
        close(td, jd, atol=ATOL)
        depth = np.random.RandomState(3).uniform(1, 5, (30, 40)).astype(np.float32)
        pts_t = tc.backproject(torch.from_numpy(depth))
        pts_j = jc.backproject(jnp.asarray(depth))
        close(pts_t, pts_j, atol=ATOL)

    def test_lookat_camera(self):
        args = ([0.3, -0.2, -5.5], [0.1, 0.0, 0.2], [0, -1, 0])
        tc = tcam.lookat_camera(*args, fx=220.0, fy=210.0, width=64, height=48,
                                device="cpu")
        jc = jcam.lookat_camera(*args, fx=220.0, fy=210.0, width=64, height=48)
        for attr in ("w2c", "fx", "fy", "cx", "cy"):
            close(getattr(tc, attr), getattr(jc, attr))
        assert (tc.width, tc.height, tc.znear, tc.zfar) == (jc.width, jc.height,
                                                            jc.znear, jc.zfar)

    def test_stack_cameras(self):
        pairs = [camera_pair(s) for s in range(3)]
        tb = tcam.stack_cameras([p[0] for p in pairs])
        jb = jcam.stack_cameras([p[1] for p in pairs])
        assert tb.w2c.shape == (3, 4, 4)
        for attr in ("c2w", "center", "projection", "world2pix"):
            close(getattr(tb, attr), getattr(jb, attr), atol=ATOL)
        with pytest.raises(ValueError):
            tcam.stack_cameras([pairs[0][0], camera_pair(0, w=20)[0]])


class TestGeometry:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_depth_to_normal(self, seed):
        tc, jc = camera_pair(seed)
        rng = np.random.RandomState(seed + 7)
        yy, xx = np.mgrid[0:30, 0:40].astype(np.float32)
        depth = (3.0 + 0.02 * xx - 0.03 * yy + 0.05 * rng.rand(30, 40)).astype(np.float32)
        close(tgeo.depth_to_normal(tc, torch.from_numpy(depth)),
              jgeo.depth_to_normal(jc, jnp.asarray(depth)), atol=ATOL)
