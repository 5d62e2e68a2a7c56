"""The port's COLMAP reader and writer against the JAX package's: the same
model written by both gives the same bytes (binary and text), each reads
the other's model, `rotmat2qvec` agrees, and `to_framework_cameras` gives
the JAX package's cameras (1e-6)."""

import os

import numpy as np
import pytest

from g4splat_torch.io import colmap as T
from g4splat_tpu.io import colmap as J

FILES = ("cameras.bin", "images.bin", "points3D.bin", "cameras.txt", "images.txt",
         "points3D.txt")


def make_model(mod, n_cams=2, n_imgs=3, n_pts=40, seed=0):
    rng = np.random.RandomState(seed)
    cams = {i + 1: mod.ColmapCamera(i + 1, ("PINHOLE", "SIMPLE_PINHOLE")[i % 2], 64 + i, 48,
                                    np.array([50.0 + i, 51.0, 31.5, 23.5][:4 - i % 2]))
            for i in range(n_cams)}
    images = {}
    for i in range(n_imgs):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        n2d = rng.randint(0, 5)
        images[i + 1] = mod.ColmapImage(i + 1, q * np.sign(q[0]), rng.randn(3), i % n_cams + 1,
                                        f"frame_{i:06d}.png", rng.rand(n2d, 2) * 64,
                                        rng.randint(-1, n_pts, n2d).astype(np.int64))
    pts = {}
    for i in range(n_pts):
        tl = rng.randint(1, 4)
        pts[i + 1] = mod.ColmapPoint3D(i + 1, rng.randn(3), rng.randint(0, 256, 3).astype(np.uint8),
                                       float(rng.rand()),
                                       rng.randint(1, n_imgs + 1, tl).astype(np.int32),
                                       rng.randint(0, 5, tl).astype(np.int32))
    return cams, images, pts


def same_model(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert list(ca) == list(cb) and list(ia) == list(ib) and list(pa) == list(pb)
    for k in ca:
        assert (ca[k].model, ca[k].width, ca[k].height) == (cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f), getattr(ib[k], f))
        assert (ia[k].name, ia[k].camera_id) == (ib[k].name, ib[k].camera_id)
    for k in pa:
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(pa[k], f), getattr(pb[k], f))
        assert pa[k].error == pb[k].error


def test_writers_give_the_same_bytes(tmp_path):
    T.write_model(*make_model(T), str(tmp_path / "t"))
    J.write_model(*make_model(J), str(tmp_path / "j"))
    for f in FILES:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("binary", [True, False])
def test_each_reads_the_others_model(tmp_path, binary):
    T.write_model(*make_model(T), str(tmp_path / "t"), binary=binary, text=not binary)
    J.write_model(*make_model(J), str(tmp_path / "j"), binary=binary, text=not binary)
    same_model(T.read_model(str(tmp_path / "j")), J.read_model(str(tmp_path / "j")))
    same_model(J.read_model(str(tmp_path / "t")), T.read_model(str(tmp_path / "t")))
    same_model(T.read_model(str(tmp_path / "t")), J.read_model(str(tmp_path / "j")))


def test_rotmat2qvec_and_cameras(tmp_path):
    from scipy.spatial.transform import Rotation

    for seed in range(5):
        R = Rotation.random(random_state=seed).as_matrix()
        np.testing.assert_array_equal(T.rotmat2qvec(R), J.rotmat2qvec(R))
    model = make_model(T)
    T.write_model(*model, str(tmp_path))
    jc, ji, _ = J.read_model(str(tmp_path))
    tc, ti, _ = T.read_model(str(tmp_path))
    jf = J.to_framework_cameras(jc, ji)
    tf = T.to_framework_cameras(tc, ti, device="cpu")
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (_, a), (_, b) in zip(jf, tf):
        for k in ("w2c", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)),
                                       atol=1e-6)
        assert (a.width, a.height) == (b.width, b.height)
