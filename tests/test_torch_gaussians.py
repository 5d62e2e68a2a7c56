"""Parity of the port's GaussianScene, k-NN and PLY IO with g4splat_tpu on
the CPU. Scenes are built from numpy arrays made from a seed; PLY files must
cross between the packages in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import scene_from
from g4splat_torch.io import ply as tply
from g4splat_torch.models.gaussians import GaussianScene as TScene
from g4splat_torch.ops import knn as tknn
from g4splat_tpu.io import ply as jply
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.ops import knn as jknn

ATOL = 1e-5
FIELDS = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw",
          "alive", "mip_filter")


def close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def point_cloud(n, seed=0):
    rng = np.random.RandomState(seed)
    return dict(points=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                colors=rng.rand(n, 3).astype(np.float32),
                scales=np.exp(rng.uniform(-3, -2, n)).astype(np.float32),
                quats=rng.randn(n, 4).astype(np.float32))


def scene_pair(n=40, seed=0, capacity=None, mip=False, sh_degree=3):
    pc = point_cloud(n, seed)
    js = JScene.from_points(pc["points"], pc["colors"], capacity=capacity,
                            scales=pc["scales"], quats=pc["quats"], initial_opacity=0.6)
    rng = np.random.RandomState(seed + 1)
    cap = js.capacity
    js = js.replace(
        f_rest=jnp.asarray(rng.randn(cap, 15, 3).astype(np.float32) * 0.1),
        opacity_raw=jnp.asarray(rng.randn(cap, 1).astype(np.float32)),
        active_sh_degree=sh_degree)
    if mip:
        js = js.replace(mip_filter=jnp.asarray(rng.uniform(0.01, 0.05, (cap, 1))
                                               .astype(np.float32)),
                        use_mip_filter=True)
    return scene_from(js, device="cpu"), js


def assert_same_scene(ts, js, atol=ATOL):
    for k in FIELDS:
        close(getattr(ts, k), getattr(js, k), atol=atol)
    assert (ts.max_sh_degree, ts.active_sh_degree, ts.use_mip_filter) == (
        js.max_sh_degree, js.active_sh_degree, js.use_mip_filter)


class TestActivations:
    @pytest.mark.parametrize("mip", [False, True])
    def test_activations(self, mip):
        ts, js = scene_pair(capacity=48, mip=mip)
        for name in ("scaling", "opacity", "features"):
            close(getattr(ts, name)(), getattr(js, name)(), atol=1e-5, rtol=1e-5)
        assert int(ts.alive.sum()) == int(js.num_alive) == 40
        assert ts.capacity == js.capacity == 48

    def test_empty(self):
        assert_same_scene(TScene.empty(17, max_sh_degree=2, device="cpu"),
                          JScene.empty(17, max_sh_degree=2))


class TestFromPoints:
    @pytest.mark.parametrize("with_scales", [True, False])
    def test_from_points(self, with_scales):
        pc = point_cloud(300, seed=3)
        kw = dict(capacity=320, initial_opacity=0.3, quats=pc["quats"],
                  scales=pc["scales"] if with_scales else None)
        ts = TScene.from_points(pc["points"], pc["colors"], device="cpu", **kw)
        js = JScene.from_points(pc["points"], pc["colors"], **kw)
        assert_same_scene(ts, js, atol=1e-5)

    def test_from_points_defaults(self):
        pc = point_cloud(50, seed=4)
        assert_same_scene(TScene.from_points(pc["points"], device="cpu"),
                          JScene.from_points(pc["points"]))


class TestKNN:
    def test_exact(self):
        pts = point_cloud(700, seed=5)["points"]
        close(tknn.mean_knn_sq_dist_exact(torch.from_numpy(pts), block=256),
              jknn.mean_knn_sq_dist_exact(jnp.asarray(pts), block=256), atol=1e-6, rtol=1e-4)

    def test_morton_window(self):
        pts = point_cloud(5000, seed=6)["points"]
        close(tknn.mean_knn_sq_dist(torch.from_numpy(pts), window=32),
              jknn.mean_knn_sq_dist(jnp.asarray(pts), window=32), atol=1e-6, rtol=1e-4)


class TestPLY:
    @pytest.mark.parametrize("mip", [False, True])
    def test_jax_save_port_load(self, tmp_path, mip):
        ts, js = scene_pair(capacity=48, mip=mip)
        path = str(tmp_path / "point_cloud.ply")
        jply.save_gaussian_ply(path, js)
        loaded = tply.load_gaussian_ply(path, device="cpu")
        ref = jply.load_gaussian_ply(path)
        assert_same_scene(loaded, ref, atol=0.0)
        assert loaded.capacity == 40

    @pytest.mark.parametrize("mip", [False, True])
    def test_port_save_jax_load(self, tmp_path, mip):
        ts, js = scene_pair(capacity=48, mip=mip)
        tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
        tply.save_gaussian_ply(tpath, ts)
        jply.save_gaussian_ply(jpath, js)
        assert_same_scene(scene_from(jply.load_gaussian_ply(tpath), device="cpu"),
                          jply.load_gaussian_ply(jpath), atol=0.0)
        # Byte-compatible schema: identical but for the header comment line.
        (th, tbody), (jh, jbody) = ((tmp_path / f).read_bytes().split(b"end_header\n")
                                    for f in ("t.ply", "j.ply"))
        assert tbody == jbody
        strip = lambda h: [l for l in h.split(b"\n") if not l.startswith(b"comment")]
        assert strip(th) == strip(jh)

    def test_empty_scene_saves(self, tmp_path):
        ts = TScene.empty(8, device="cpu")
        tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
        tply.save_gaussian_ply(tpath, ts)
        jply.save_gaussian_ply(jpath, JScene.empty(8))
        assert tply.read_ply(tpath)["vertex"].shape == (0,)
        assert jply.read_ply(tpath)["vertex"].dtype == jply.read_ply(jpath)["vertex"].dtype
        assert tply.load_gaussian_ply(tpath, capacity=4, device="cpu").capacity == 4

    def test_point_cloud_reads_and_mesh_is_refused(self, tmp_path):
        rng = np.random.RandomState(0)
        pts, cols = rng.rand(6, 3).astype(np.float32), rng.rand(6, 3).astype(np.float32)
        jply.save_point_cloud_ply(str(tmp_path / "p.ply"), pts, colors=cols)
        got, ref = (mod.read_ply(str(tmp_path / "p.ply"))["vertex"] for mod in (tply, jply))
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
        jply.save_mesh_ply(str(tmp_path / "m.ply"), pts, np.array([[0, 1, 2]], np.int32))
        np.testing.assert_array_equal(tply.read_ply(str(tmp_path / "m.ply"))["face"],
                                      [[0, 1, 2]])
        # A face list of varying length (a triangle, then a quad) is refused.
        data = (tmp_path / "m.ply").read_bytes().replace(b"element face 1", b"element face 2")
        quad = np.zeros(1, np.dtype([("n", "u1"), ("v", "<i4", (4,))]))
        quad["n"], quad["v"] = 4, [0, 1, 2, 3]
        (tmp_path / "q.ply").write_bytes(data + quad.tobytes())
        with pytest.raises(ValueError, match="list properties"):
            tply.read_ply(str(tmp_path / "q.ply"))
