"""The port's tools and small helpers against the JAX package's, on the CPU.

- `utils.profiling`: `trace` writes a Chrome trace that names an `annotate`
  range and the profiled ops (the spans and counters themselves:
  tests/test_torch_tracing.py).
- `utils.config.save_run_config` writes the JAX package's `cfg_args.json`
  bytes for the same groups (a dataclass, a dict, a value JSON cannot hold),
  and `load_run_config` reads it back.
- `utils.viewer.ViewerServer` as tests/test_viewer.py holds the JAX one
  (/info, /render, mode=depth, 404) on an ephemeral port, its PNG equal to
  the 8-bit `render()` of the same look-at camera, mode=normal, and a failed
  render answering 500.
- The small helpers: `Camera.K`, `tanfov`, `fov`, `make_camera_from_fov`;
  `GaussianScene.rotation`, `normals`, `colors` (SH degrees 0-3) and the
  mip filter through `per_cam`; `depth_to_points`, `image_gradient`,
  `shift`, `normal_to_curvature` of `core.geometry`; `homogenize`,
  `project_points`, `quat_multiply`, `transform_points`, each against the
  JAX function on the same seeded inputs within 1e-6 (float32 rounding of
  the same arithmetic; exact where no arithmetic is done).
"""

import dataclasses
import glob
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import camera_from, scene_from
from g4splat_torch.core import cameras as TC
from g4splat_torch.core import geometry as TG
from g4splat_torch.core import transforms as TT
from g4splat_torch.io.images import read_png, to_uint8
from g4splat_torch.models.gaussians import GaussianScene, per_cam
from g4splat_torch.ops.rasterize import render
from g4splat_torch.utils import config as TU
from g4splat_torch.utils import profiling as TP
from g4splat_torch.utils.viewer import ViewerServer, query_camera
from g4splat_tpu.core import cameras as JC
from g4splat_tpu.core import geometry as JG
from g4splat_tpu.core import transforms as JT
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.utils import config as JU

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's fixtures and tests: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- profiling

def test_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with TP.trace(logdir) as prof:
        with TP.annotate("my_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "my_stage" in names and any("mm" in str(n) for n in names)


# ---------------------------------------------------------------- run config

@dataclasses.dataclass
class Group:
    a: int = 1
    b: float = 2.5
    c: tuple = (1, 2)
    d: str = "x"


def test_run_config_bytes_match_jax(tmp_path):
    groups = dict(model=Group(a=7), extra={"x": 1, "y": [1.5, None]}, where=tmp_path)
    TU.save_run_config(str(tmp_path / "port"), **groups)
    JU.save_run_config(str(tmp_path / "jax"), **groups)
    got = (tmp_path / "port" / "cfg_args.json").read_bytes()
    assert got == (tmp_path / "jax" / "cfg_args.json").read_bytes()
    back = TU.load_run_config(str(tmp_path / "port"))
    assert back == JU.load_run_config(str(tmp_path / "jax"))
    assert back["model"]["a"] == 7 and back["extra"]["x"] == 1
    assert back["where"] == str(tmp_path)


# -------------------------------------------------------------------- viewer

def viewer_scene():
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (100, 2)), np.zeros((100, 1))],
                         1).astype(np.float32)
    return GaussianScene.from_points(pts, rng.rand(100, 3).astype(np.float32),
                                     scales=np.full(100, 0.1, np.float32),
                                     initial_opacity=0.9, device="cpu")


@pytest.fixture(scope="module")
def server():
    scene = viewer_scene()
    s = ViewerServer(lambda: scene, port=0).start()
    yield s, scene
    s.stop()


def get(server, path):
    s, _ = server
    with urllib.request.urlopen(f"http://127.0.0.1:{s.port}{path}", timeout=60) as r:
        return r.status, r.read()


def test_viewer_info(server):
    status, body = get(server, "/info")
    info = json.loads(body)
    assert status == 200 and info == {"n_alive": 100, "capacity": 100, "sh_degree": 0}


def test_viewer_render_png_equals_render(server):
    q = "eye=0,0,-2.5&target=0,0,0&w=64&h=48&fov=60"
    status, data = get(server, f"/render?{q}")
    assert status == 200 and data[:8] == b"\x89PNG\r\n\x1a\n"
    got = decode(data)
    assert got.shape == (48, 64, 3) and got.max() > 10
    _, scene = server
    cam = query_camera({"eye": ["0,0,-2.5"], "target": ["0,0,0"], "w": ["64"], "h": ["48"],
                        "fov": ["60"]}, "cpu")
    with torch.no_grad():
        want = to_uint8(render(cam, scene, backend="cuda")["render"])
    np.testing.assert_array_equal(got, want)


def decode(data: bytes) -> np.ndarray:
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(data)
        f.flush()
        return read_png(f.name)


@pytest.mark.parametrize("mode", ["depth", "normal"])
def test_viewer_modes(server, mode):
    status, data = get(server, f"/render?eye=0,0,-2.5&target=0,0,0&w=32&h=32&mode={mode}")
    assert status == 200 and decode(data).shape == (32, 32, 3)


def test_viewer_404_and_500(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        get(server, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        get(server, "/render?eye=0,0&w=32&h=32")
    assert e.value.code == 500


# ------------------------------------------------------------- small helpers

def np_(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_cameras():
    return JC.stack_cameras([
        JC.lookat_camera([2.0 * np.sin(a), 0.3, -2.0 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                         fx=40.0 + 5 * i, fy=38.0 - i, width=48, height=36)
        for i, a in enumerate((-0.4, 0.1, 0.5))])


def test_camera_intrinsics_match_jax():
    jc = jax_cameras()
    tc = camera_from(jc, device="cpu")
    np.testing.assert_allclose(np_(tc.K), np.asarray(jc.K), **TOL)
    for a, b in zip(tc.tanfov, jc.tanfov):
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL)
    for a, b in zip(tc.fov, jc.fov):
        np.testing.assert_allclose(np_(a), np.asarray(b), **TOL)
    w2c = np.asarray(jc.w2c[1])
    t = TC.make_camera_from_fov(w2c, 1.1, 0.8, 48, 36, znear=0.05, device="cpu")
    j = JC.make_camera_from_fov(w2c, 1.1, 0.8, 48, 36, znear=0.05)
    for k in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(np_(getattr(t, k)), np.asarray(getattr(j, k)), err_msg=k)
    assert (t.width, t.height, t.znear, t.zfar) == (j.width, j.height, j.znear, j.zfar)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_scene_helpers_match_jax(degree):
    rng = np.random.RandomState(degree)
    n = 50
    js = JScene.from_points(rng.randn(n, 3).astype(np.float32),
                            rng.rand(n, 3).astype(np.float32), capacity=64,
                            scales=np.full(n, 0.05, np.float32),
                            quats=rng.randn(n, 4).astype(np.float32))
    js = js.replace(f_rest=jnp.asarray(0.1 * rng.randn(64, 15, 3).astype(np.float32)),
                    active_sh_degree=degree)
    ts = scene_from(js, device="cpu")
    np.testing.assert_allclose(np_(ts.rotation()), np.asarray(js.rotation()), **TOL)
    np.testing.assert_allclose(np_(ts.normals()), np.asarray(js.normals()), **TOL)
    centre = np.array([0.3, -1.0, -2.5], np.float32)
    np.testing.assert_allclose(np_(ts.colors(torch.from_numpy(centre))),
                               np.asarray(js.colors(jnp.asarray(centre))), **TOL)
    jc = jax_cameras()
    tm = ts.compute_mip_filter(camera_from(jc, device="cpu"))
    jm = js.compute_mip_filter(jc)
    np.testing.assert_allclose(np_(tm.mip_filter), np.asarray(jm.mip_filter), **TOL)
    d, v = per_cam(ts.xyz, camera_from(jc, device="cpu"))
    assert d.shape == v.shape == (3, 64) and bool(torch.isinf(d[~v]).all())


def test_geometry_helpers_match_jax():
    rng = np.random.RandomState(1)
    jc = jax.tree.map(lambda x: x[0], jax_cameras())
    tc = TC.camera_at(camera_from(jax_cameras(), device="cpu"), 0)
    depth = (2.0 + rng.rand(36, 48)).astype(np.float32)
    np.testing.assert_allclose(np_(TG.depth_to_points(tc, torch.from_numpy(depth))),
                               np.asarray(JG.depth_to_points(jc, jnp.asarray(depth))),
                               rtol=1e-6, atol=1e-5)
    for img in (rng.rand(36, 48).astype(np.float32), rng.rand(36, 48, 3).astype(np.float32)):
        np.testing.assert_allclose(np_(TG.image_gradient(torch.from_numpy(img))),
                                   np.asarray(JG.image_gradient(jnp.asarray(img))), **TOL)
    normal = rng.randn(36, 48, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    np.testing.assert_allclose(np_(TG.normal_to_curvature(torch.from_numpy(normal))),
                               np.asarray(JG.normal_to_curvature(jnp.asarray(normal))), **TOL)
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1), (2, -3)):
        np.testing.assert_array_equal(np_(TG.shift(torch.from_numpy(normal), dr, dc)),
                                      np.roll(normal, (dr, dc), axis=(0, 1)))


def test_transform_helpers_match_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(7, 4).astype(np.float32), rng.randn(7, 4).astype(np.float32)
    np.testing.assert_allclose(np_(TT.quat_multiply(torch.from_numpy(a), torch.from_numpy(b))),
                               np.asarray(JT.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
                               **TOL)
    p = rng.randn(5, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(np_(TT.homogenize(torch.from_numpy(p))),
                                  np.asarray(JT.homogenize(jnp.asarray(p))))
    m = rng.randn(4, 4).astype(np.float32)
    m[3] = [0.1, -0.2, 0.05, 3.0]
    for fn in ("transform_points", "project_points"):
        np.testing.assert_allclose(
            np_(getattr(TT, fn)(torch.from_numpy(m), torch.from_numpy(p))),
            np.asarray(getattr(JT, fn)(jnp.asarray(m), jnp.asarray(p))), rtol=1e-5, atol=1e-6,
            err_msg=fn)
