"""The CUDA kernels against their plain PyTorch versions, and the cuda
backend's gradients against the tiled backend's, on the card.

Needs a CUDA card and nvcc; skips without them. On a machine with a card,
from the repository root (the suite's conftest imports JAX, which that
machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from g4splat_torch.core.cameras import lookat_camera
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops import rasterize_cuda, rasterize_cuda_bwd
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig, preprocess
from g4splat_torch.ops.rasterize_tiled import bin_splats

pytestmark = pytest.mark.gpu

# A float map's pixel agrees when |kernel - plain| <= 1e-3·max|plain map| (at
# least 1e-6: distortion is a difference of sums of size ~1, in which fp32
# rounding leaves up to ~4e-7 of noise). The card's fp32 arithmetic is taken in another order, with fused
# multiply-adds, so alpha >= 1/255 and the T > 0.5 / T < 1e-4 crossings can flip
# at isolated pixels: each map's disagreeing pixels, and n_contrib's, must stay
# under 1e-3 of the image.
MAP_TOL = 1e-3
ABS_FLOOR = 1e-6
FLIP_FRAC = 1e-3
# B2 against its plain version: ‖kernel − plain‖ / ‖plain‖ per gradient group
# (the JAX package's Pallas-vs-tiled gradient gate). Atomics add in another
# order on every run, and a contributor or median decision flipped by fused
# multiply-adds moves a whole entry's share.
GRAD_TOL = 2e-2
# The cuda backend's parameter gradients against the tiled backend's (autograd).
CHAIN_TOL = 1e-2
GROUPS = {"dT": slice(0, 9), "d_center": slice(9, 11), "d_opacity": slice(11, 12),
          "d_rgb": slice(12, 15), "d_normal": slice(15, 18)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def entry_table(cuda):
    rng = np.random.RandomState(1)
    n = 4000
    scene = GaussianScene.from_points(
        rng.uniform(-1.0, 1.0, (n, 3)), rng.rand(n, 3),
        scales=np.exp(rng.uniform(-3.5, -2.0, n)), quats=rng.randn(n, 4),
        initial_opacity=0.7, device=cuda)
    # Close by (depths 1.2-3.2), so the distortion map stands well above its
    # rounding; 120x88 leaves ragged edge tiles.
    cam = lookat_camera([0, 0, -2.2], [0, 0, 0], [0, -1, 0], fx=220.0, fy=220.0,
                        width=120, height=88, device=cuda)
    prep = preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw,
                      scene.opacity(), scene.features(), 0, config=RenderConfig())
    b = bin_splats(prep, cam.width, cam.height)
    return b, rasterize_cuda.pack_entries(prep, b.gauss_id), cam


@pytest.mark.parametrize("want_aux,want_dist", [(False, True), (True, False), (True, True)])
def test_kernel_matches_plain(entry_table, want_aux, want_dist):
    b, entries, cam = entry_table
    bg = torch.tensor([0.05, 0.1, 0.15], device=entries.device)
    args = (entries, b.tile_start, b.tile_count, bg, cam.width, cam.height)
    before = rasterize_cuda.RASTERIZE_FWD.launches
    got = rasterize_cuda.rasterize_entries(*args, want_aux=want_aux, want_dist=want_dist)
    assert rasterize_cuda.RASTERIZE_FWD.launches == before + 1
    ref = rasterize_cuda.rasterize_entries_plain(*args, want_aux=want_aux,
                                                 want_dist=want_dist)
    torch.cuda.synchronize()
    for k in ("color", "normal", "depth_acc", "alpha", "distortion", "final_T",
              "m1_tot", "m2_tot", "median_depth"):
        d = (got[k] - ref[k]).abs()
        d = d.amax(-1) if d.ndim == 3 else d
        tol = max(MAP_TOL * float(ref[k].abs().max()), ABS_FLOOR)
        assert float((d > tol).float().mean()) < FLIP_FRAC, (k, float(d.max()), tol)
    if want_aux and want_dist:     # the check can see a wrong distortion map
        assert float((ref["distortion"] > ABS_FLOOR).float().mean()) > 0.1
    assert float((got["n_contrib"] != ref["n_contrib"]).float().mean()) < FLIP_FRAC
    if not want_aux:
        assert not got["n_contrib"].any()
    if not (want_aux and want_dist):
        assert not got["distortion"].any() and not got["m1_tot"].any()


@pytest.mark.parametrize("want_dist", [False, True])
def test_backward_kernel_matches_plain(entry_table, want_dist):
    b, entries, cam = entry_table
    dev = entries.device
    W, H = cam.width, cam.height
    bg = torch.tensor([0.05, 0.1, 0.15], device=dev)
    maps = rasterize_cuda.rasterize_entries(entries, b.tile_start, b.tile_count, bg, W, H,
                                            want_aux=True, want_dist=want_dist)
    aux = torch.stack([maps["final_T"], maps["n_contrib"].float(), maps["m1_tot"],
                       maps["m2_tot"]], -1)
    cot = torch.from_numpy(np.random.RandomState(2).randn(H, W, 12).astype(np.float32))
    cot[..., 10:] = 0.0
    args = (entries, b.gauss_id, b.tile_start, b.tile_count, aux, cot.to(dev), bg, W, H,
            int(b.gauss_id.max()) + 1)
    before = rasterize_cuda_bwd.RASTERIZE_BWD.launches
    got = rasterize_cuda_bwd.rasterize_backward(*args, want_dist=want_dist)
    assert rasterize_cuda_bwd.RASTERIZE_BWD.launches == before + 1
    ref = rasterize_cuda_bwd.rasterize_backward_plain(*args, want_dist=want_dist)
    torch.cuda.synchronize()
    for name, sl in GROUPS.items():
        norm = float(ref[:, sl].norm())
        assert norm > 0, name
        assert float((got[:, sl] - ref[:, sl]).norm()) / norm <= GRAD_TOL, name


@pytest.mark.parametrize("dist", [False, True])
def test_cuda_backend_gradients_match_tiled(cuda, dist):
    rng = np.random.RandomState(4)
    n = 600
    scene = GaussianScene.from_points(
        rng.uniform(-1.0, 1.0, (n, 3)), rng.rand(n, 3),
        scales=np.exp(rng.uniform(-3.0, -1.8, n)), quats=rng.randn(n, 4),
        initial_opacity=0.6, device=cuda)
    scene = scene.replace(f_rest=0.05 * torch.randn(scene.f_rest.shape, device=cuda,
                                                   generator=torch.Generator(device=cuda).manual_seed(0)),
                          active_sh_degree=3)
    cam = lookat_camera([0, 0, -2.6], [0, 0, 0], [0, -1, 0], fx=80.0, fy=80.0,
                        width=72, height=56, device=cuda)
    cfg = RenderConfig(bg=(0.05, 0.1, 0.15), compute_distortion=dist, tile_k=4096)
    keys = ("render", "rend_alpha", "rend_normal", "rend_depth", "depth_median",
            "surf_normal") + (("rend_dist",) if dist else ())
    weights = {}
    grads = {}
    for backend in ("tiled", "cuda"):
        params = {k: getattr(scene, k).clone().requires_grad_(True)
                  for k in ("xyz", "scaling_raw", "rotation_raw", "opacity_raw", "f_dc",
                            "f_rest")}
        off = torch.zeros((n, 2), device=cuda, requires_grad=True)
        counts = (rasterize_cuda.RASTERIZE_FWD.launches,
                  rasterize_cuda_bwd.RASTERIZE_BWD.launches)
        out = render(cam, scene.replace(**params), cfg, center_offset=off, backend=backend)
        for k in keys:
            weights.setdefault(k, torch.randn(out[k].shape, device=cuda,
                                              generator=torch.Generator(device=cuda).manual_seed(1)))
        sum((out[k] * weights[k]).sum() for k in keys).backward()
        if backend == "cuda":
            assert (rasterize_cuda.RASTERIZE_FWD.launches,
                    rasterize_cuda_bwd.RASTERIZE_BWD.launches) == (counts[0] + 1,
                                                                   counts[1] + 1)
        grads[backend] = {**{k: p.grad for k, p in params.items()}, "center_offset": off.grad}
    for k, ref in grads["tiled"].items():
        assert float(ref.norm()) > 0, k
        assert float((grads["cuda"][k] - ref).norm() / ref.norm()) <= CHAIN_TOL, k


def test_kernel_rejects_mixed_devices(entry_table):
    b, entries, cam = entry_table
    with pytest.raises(ValueError, match="different devices"):
        rasterize_cuda.rasterize_entries(entries, b.tile_start, b.tile_count,
                                         torch.zeros(3), cam.width, cam.height)
