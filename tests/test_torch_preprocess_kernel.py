"""The preprocess Function of `g4splat_torch.ops.preprocess_cuda` on the CPU,
run on its plain closed forms (`apply_forms`), against the torch chain
`rasterize_common.preprocess` and its autograd; the dispatch in `render`;
and the counter reader `preprocess_kernel_pct.train`.

The kernels themselves (csrc/preprocess.cu) run only on a card:
tests/test_torch_kernels_gpu.py holds them against these plain forms.

Scenes (float64, so that the closed form's gradients are held to 1e-9 of
autograd's) cover SH degrees 0-3, with and without a centre offset and
override colours, dead slots (opacity 0), splats behind the near plane and
on the camera plane (a degenerate conic), a splat whose dual conic
degenerates in front of the camera, clamped SH colours, normals facing
either way, and the unused SH bands above the active degree.
"""

import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from g4splat_torch.core.cameras import lookat_camera
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops import preprocess_cuda as pc
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig, preprocess
from g4splat_torch.utils import profiling
from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
W, H = 96, 72
FIELDS = ("T", "center", "normal", "rgb", "radius", "depth", "valid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def camera64():
    """A float64 stand-in for a Camera (the fields preprocess reads): the
    float32 camera's pose with its rotation made orthonormal in float64, and
    its world2pix recomputed from that."""
    cam = lookat_camera([0.3, -0.4, -3.0], [0, 0, 0], [0, -1, 0], fx=80.0, fy=84.0,
                        width=W, height=H, device="cpu")
    w2c = cam.w2c.double()
    U, _, V = torch.linalg.svd(w2c[:3, :3])
    w2c[:3, :3] = U @ V
    M = cam.ndc2pix.double() @ cam.projection.double() @ w2c
    R, t = w2c[:3, :3], w2c[:3, 3]
    return types.SimpleNamespace(w2c=w2c, world2pix=M, center=-(R.T @ t), width=W, height=H,
                                 fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)


def make_scene(cam, seed, n=240):
    """Leaf tensors (float64) of a scene seen by `cam`, with the special slots
    of the module's docstring at the start."""
    rng = np.random.RandomState(seed)
    Rw = cam.w2c[:3, :3].numpy()
    tw = cam.w2c[:3, 3].numpy()
    to_world = lambda pv: (pv - tw) @ Rw         # view → world (R orthonormal)
    pv = np.stack([rng.uniform(-1.4, 1.4, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.5, 4.5, n)], 1)
    pv[0:4, 2] = [-1.0, 0.05, 0.19, 0.0]          # behind, and inside, the near plane
    xyz = to_world(pv)
    scales = np.exp(rng.uniform(-3.5, -1.5, (n, 2)))
    quats = rng.randn(n, 4)
    # Slot 3: on the camera plane with zero scale: Tw = 0, dist = 0.
    scales[3] = 0.0
    # Slot 4: in front, its u axis along the view ray and s_u = z / 3, so that
    # 9 Tw0² = Tw2² and the conic's dist cancels to rounding.
    z4 = 2.0
    xyz[4] = to_world(np.array([0.0, 0.0, z4]))
    axis_w = Rw.T @ np.array([0.0, 0.0, 1.0])     # view z in world
    perp = np.cross(axis_w, [1.0, 0.0, 0.0])
    perp /= np.linalg.norm(perp)
    Rm = np.stack([axis_w, perp, np.cross(axis_w, perp)], 1)
    quats[4] = rotmat_to_quat(Rm)
    scales[4] = [z4 / 3.0, 0.05]
    opacity = rng.uniform(0.05, 0.95, (n, 1))
    opacity[5:9] = 0.0                            # dead slots
    opacity[9] = 1.0 / 255.0 * 0.999             # just under the alpha cut
    f_dc = rng.randn(n, 1, 3) * 0.8
    f_dc[10:20] = -3.0                            # clamped colours
    f_rest = rng.randn(n, 15, 3) * 0.3
    t = lambda a: torch.tensor(a, dtype=torch.float64, requires_grad=True)
    return dict(xyz=t(xyz), scaling=t(scales), rotation_raw=t(quats),
                opacity=torch.tensor(opacity, dtype=torch.float64), f_dc=t(f_dc),
                f_rest=t(f_rest), colors=t(rng.uniform(-0.2, 1.2, (n, 3))),
                center_offset=t(np.zeros((n, 2))))


def rotmat_to_quat(Rm):
    w = math.sqrt(max(1.0 + Rm[0, 0] + Rm[1, 1] + Rm[2, 2], 1e-12)) / 2.0
    return np.array([w, (Rm[2, 1] - Rm[1, 2]) / (4 * w), (Rm[0, 2] - Rm[2, 0]) / (4 * w),
                     (Rm[1, 0] - Rm[0, 1]) / (4 * w)])


def chain(cam, s, degree, offset, override):
    return preprocess(cam, s["xyz"], s["scaling"], s["rotation_raw"], s["opacity"],
                      torch.cat([s["f_dc"], s["f_rest"]], 1), degree,
                      colors=s["colors"] if override else None,
                      center_offset=s["center_offset"] if offset else None)


def function(cam, s, degree, offset, override):
    return pc.apply_forms((pc.forward_plain, pc.backward_plain), cam, s["xyz"], s["scaling"], s["rotation_raw"], s["opacity"],
                          s["f_dc"], s["f_rest"], degree,
                          colors=s["colors"] if override else None,
                          center_offset=s["center_offset"] if offset else None)


# (degree, centre offset, override colours)
CASES = [(d, off, False) for d in range(4) for off in (False, True)] + [
    (3, True, True), (1, False, True)]


@pytest.mark.parametrize("degree,offset,override", CASES)
def test_plain_forward_matches_the_torch_chain(degree, offset, override):
    cam = camera64()
    s = make_scene(cam, seed=degree)
    if offset:
        s["center_offset"] = torch.tensor(np.random.RandomState(7).uniform(-2, 2, (240, 2)))
    ref = chain(cam, s, degree, offset, override)
    got = function(cam, s, degree, offset, override)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in ("valid", "radius"):
            assert torch.equal(a, b), k
        else:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.detach().abs().max()),
                                       msg=k)
    assert torch.equal(got.opacity, ref.opacity)
    v = ref.valid
    # The scenes hold each case the docstring names.
    assert not v[:5].any() and not v[5:10].any() and v.sum() > 150
    assert not bool(ref.radius[3] > 0)
    facing = (ref.normal * (cam.w2c[:3, :3] @ s["xyz"].detach().T
                            + cam.w2c[:3, 3:4]).T).sum(-1) <= 0
    assert facing.all()                           # the flip leaves every normal facing
    if not override:
        assert (ref.rgb[10:20] == 0).any()


def test_the_degenerate_conic_slot():
    """Slot 4 lies in front of the camera with its conic's dist within
    rounding of 0: culled by `ok` alone, in both."""
    cam = camera64()
    s = make_scene(cam, seed=0)
    T = chain(cam, s, 0, False, False).T.detach()
    Tw = T[4, 2]
    dist = 9.0 * (Tw[0] ** 2 + Tw[1] ** 2) - Tw[2] ** 2
    assert float(Tw[2]) > 0.2 and abs(float(dist)) <= 1e-12
    assert not bool(function(cam, s, 0, False, False).valid[4])


@pytest.mark.parametrize("degree,offset,override", CASES)
def test_plain_backward_matches_autograd(degree, offset, override):
    """Random cotangents of T, centre, rgb and normal through the Function
    (its plain backward) and through autograd of the torch chain: every
    input's gradient within 1e-9 of the largest of autograd's, and zero in
    the SH bands above the active degree."""
    cam = camera64()
    s = make_scene(cam, seed=10 + degree)
    rng = np.random.RandomState(20 + degree)
    n = s["xyz"].shape[0]
    cot = {k: torch.tensor(rng.randn(*shape)) for k, shape in
           (("T", (n, 3, 3)), ("center", (n, 2)), ("rgb", (n, 3)), ("normal", (n, 3)))}
    names = ["xyz", "scaling", "rotation_raw"] + (["colors"] if override else
                                                  ["f_dc", "f_rest"])
    names += ["center_offset"] if offset else []

    def grads(prep):
        loss = sum((getattr(prep, k) * c).sum() for k, c in cot.items())
        return torch.autograd.grad(loss, [s[k] for k in names])

    ref = grads(chain(cam, s, degree, offset, override))
    got = grads(function(cam, s, degree, offset, override))
    for k, a, b in zip(names, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        gap = float((a - b).abs().max())
        assert gap <= 1e-9 * float(b.abs().max()), (k, gap, float(b.abs().max()))
    if not override:
        g_rest = got[names.index("f_rest")]
        nb = (degree + 1) ** 2
        assert torch.count_nonzero(g_rest[:, nb - 1:]) == 0
        assert degree == 0 or float(g_rest[:, :nb - 1].abs().max()) > 0
    if offset:
        g_off = got[names.index("center_offset")]
        valid = chain(cam, s, degree, offset, override).valid
        assert torch.equal(g_off[~valid], torch.zeros_like(g_off[~valid]))
        assert torch.equal(g_off[valid], cot["center"][valid])


def test_the_function_refuses_a_camera_that_requires_grad():
    cam = camera64()
    s = make_scene(cam, seed=0)
    cam.w2c = cam.w2c.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="camera no gradient"):
        function(cam, s, 0, False, False)


def test_preprocess_splats_refuses_cpu_tensors():
    """The kernels' entry takes CUDA tensors alone: `render` sends CPU
    tensors to the torch chain."""
    cam = camera64()
    s = make_scene(cam, seed=0)
    with pytest.raises(ValueError, match="CUDA kernels"):
        pc.preprocess_splats(cam, s["xyz"], s["scaling"], s["rotation_raw"], s["opacity"],
                             s["f_dc"], s["f_rest"])


def tiny_scene():
    rng = np.random.RandomState(3)
    n = 40
    scene = GaussianScene.from_points(rng.uniform(-0.8, 0.8, (n, 3)), rng.rand(n, 3),
                                      scales=np.full(n, 0.1, np.float32),
                                      quats=rng.randn(n, 4), initial_opacity=0.7,
                                      capacity=n + 8, device="cpu")
    cam = lookat_camera([0.0, 0.3, -3.0], [0, 0, 0], [0, -1, 0], fx=40.0, fy=40.0, width=48,
                        height=36, device="cpu")
    return scene, cam


def test_render_on_cpu_tensors_takes_the_torch_chain(monkeypatch):
    """CPU tensors, and a camera that requires grad, run the torch chain: the
    counter of calls moves, the kernel's does not, no kernel launches, and a
    camera that requires grad gets its gradient."""
    from g4splat_torch.ops import rasterize

    scene, cam = tiny_scene()
    called = []
    monkeypatch.setattr(rasterize, "preprocess_splats",
                        lambda *a, **kw: called.append(1))
    launches = pc.PREPROCESS_FWD.launches, pc.PREPROCESS_BWD.launches
    profiling.reset_counters()
    with torch.profiler.profile():
        out = render(cam, scene, backend="cuda")
        cam_g = cam.replace(w2c=cam.w2c.clone().requires_grad_(True))
        out_g = render(cam_g, scene, backend="cuda")
    c = profiling.counters()
    assert c["render.preprocesses"] == 2 and "render.preprocesses_kernel" not in c
    assert not called
    assert (pc.PREPROCESS_FWD.launches, pc.PREPROCESS_BWD.launches) == launches
    assert torch.equal(out["render"], out_g["render"])
    out_g["render"].sum().backward()
    assert cam_g.w2c.grad is not None and bool(cam_g.w2c.grad.abs().sum() > 0)
    profiling.reset_counters()


def test_preprocess_kernel_pct_reads_the_counters():
    read = harness.metric_reader(ROOT, "preprocess_kernel_pct.train")
    profiling.reset_counters()
    trace = types.SimpleNamespace(annotations={}, host_annotations={}, kernels={}, spans={},
                                  counts={}, window_s=1.0, busy_s=0.5)
    assert read(trace) is None
    with torch.profiler.profile():
        profiling.count("render.preprocesses", 4)
    assert read(trace) is None              # no kernel counter: a tree without the kernels
    with torch.profiler.profile():
        profiling.count("render.preprocesses_kernel", 3)
    assert read(trace) == pytest.approx(75.0, rel=1e-12)
    profiling.reset_counters()
    assert read(trace) is None
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["preprocess_kernel_pct.train"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "%", "higher", "program_counter", "rasterizer ops", "train_steps_per_s", ["train_room"])


def test_the_kernels_are_built_with_the_others():
    from g4splat_torch.ops import cuda_build

    assert "preprocess" in cuda_build.SOURCES
    assert (cuda_build.CSRC / "preprocess.cu").exists()
    for k in (pc.PREPROCESS_FWD, pc.PREPROCESS_BWD):
        assert (ROOT / k.source).exists()
