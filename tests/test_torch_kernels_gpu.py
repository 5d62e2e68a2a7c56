"""The CUDA kernels against their plain PyTorch versions (B1, B2, B3), and
the cuda backend's gradients against the tiled backend's, on the card.

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
from g4splat_torch.ops import attention_cuda, rasterize_cuda, rasterize_cuda_bwd
from g4splat_torch.ops.attention import chunked_attention, memory_efficient_attention
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
    return b, rasterize_cuda.splat_table(prep), cam


@pytest.mark.parametrize("want_aux,want_dist", [(False, True), (True, False), (True, True)])
def test_kernel_matches_plain(entry_table, want_aux, want_dist):
    b, table, cam = entry_table
    bg = torch.tensor([0.05, 0.1, 0.15], device=table.device)
    args = (table, b.gauss_id, b.tile_start, b.tile_count, bg, cam.width, cam.height)
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


@pytest.mark.parametrize("want_aux,want_dist", [(False, True), (True, False), (True, True)])
def test_kernel_reads_rows_through_gauss_id(entry_table, want_aux, want_dist):
    """B1 reading entry i as table row gauss_id[i] is bitwise equal to B1 on
    the rows gathered beforehand with identity ids: same rows, same
    arithmetic."""
    b, table, cam = entry_table
    bg = torch.tensor([0.05, 0.1, 0.15], device=table.device)
    rows = table[b.gauss_id.long()].contiguous()
    ids = torch.arange(rows.shape[0], dtype=torch.int32, device=table.device)
    geom = (b.tile_start, b.tile_count, bg, cam.width, cam.height)
    got = rasterize_cuda.rasterize_entries(table, b.gauss_id, *geom, want_aux=want_aux,
                                           want_dist=want_dist)
    ref = rasterize_cuda.rasterize_entries(rows, ids, *geom, want_aux=want_aux,
                                           want_dist=want_dist)
    torch.cuda.synchronize()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("want_dist", [False, True])
def test_backward_kernel_matches_plain(entry_table, want_dist):
    b, table, cam = entry_table
    dev = table.device
    W, H = cam.width, cam.height
    bg = torch.tensor([0.05, 0.1, 0.15], device=dev)
    maps = rasterize_cuda.rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count,
                                            bg, W, H, want_aux=True, want_dist=want_dist)
    aux = torch.stack([maps["final_T"], maps["n_contrib"].float(), maps["m1_tot"],
                       maps["m2_tot"]], -1)
    cot = torch.from_numpy(np.random.RandomState(2).randn(H, W, 12).astype(np.float32))
    cot[..., 10:] = 0.0
    args = (table, b.gauss_id, b.tile_start, b.tile_count, aux, cot.to(dev), bg, W, H)
    before = rasterize_cuda_bwd.RASTERIZE_BWD.launches
    got = rasterize_cuda_bwd.rasterize_backward(*args, want_dist=want_dist)
    assert rasterize_cuda_bwd.RASTERIZE_BWD.launches == before + 1
    ref = rasterize_cuda_bwd.rasterize_backward_plain(*args, want_dist=want_dist)
    torch.cuda.synchronize()
    for name, sl in GROUPS.items():
        norm = float(ref[:, sl].norm())
        assert norm > 0, name
        assert float((got[:, sl] - ref[:, sl]).norm()) / norm <= GRAD_TOL, name


@pytest.fixture(scope="module")
def deep_table(cuda):
    """A deep-overlap scene (tiles of several hundred entries, ragged edge
    tiles) with B1's saved aux and seeded cotangents: B2's inputs."""
    rng = np.random.RandomState(3)
    n = 6000
    scene = GaussianScene.from_points(
        rng.uniform(-0.35, 0.35, (n, 3)), rng.rand(n, 3),
        scales=np.exp(rng.uniform(-3.5, -2.0, n)), quats=rng.randn(n, 4),
        initial_opacity=0.7, device=cuda)
    cam = lookat_camera([0, 0, -5.5], [0, 0, 0], [0, -1, 0], fx=220.0, fy=220.0,
                        width=104, height=88, device=cuda)
    prep = preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw,
                      scene.opacity(), scene.features(), 0, config=RenderConfig())
    b = bin_splats(prep, cam.width, cam.height)
    table = rasterize_cuda.splat_table(prep)
    bg = torch.tensor([0.05, 0.1, 0.15], device=cuda)
    out = {}
    for want_dist in (False, True):
        maps = rasterize_cuda.rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count,
                                                bg, cam.width, cam.height, want_aux=True,
                                                want_dist=want_dist)
        aux = torch.stack([maps["final_T"], maps["n_contrib"].float(), maps["m1_tot"],
                           maps["m2_tot"]], -1)
        cot = torch.from_numpy(np.random.RandomState(4).randn(cam.height, cam.width, 12)
                               .astype(np.float32)).to(cuda)
        cot[..., 10:] = 0.0
        out[want_dist] = (table, b.gauss_id, b.tile_start, b.tile_count, aux, cot, bg,
                          cam.width, cam.height)
    return out


@pytest.mark.parametrize("want_dist", [False, True])
def test_backward_deep_scene_matches_plain(deep_table, want_dist):
    """B2 on a deep scene, whose tiles walk several hundred entries in
    batches of 32 on a persistent grid with more tiles than blocks, reading
    each entry's row from the splat table through gauss_id."""
    args = deep_table[want_dist]
    walk = rasterize_cuda_bwd.tile_walks(args[4], args[3], args[7], args[8])
    assert int(walk.max()) > 256
    got = rasterize_cuda_bwd.rasterize_backward(*args, want_dist=want_dist)
    ref = rasterize_cuda_bwd.rasterize_backward_plain(*args, want_dist=want_dist)
    torch.cuda.synchronize()
    for name, sl in GROUPS.items():
        norm = float(ref[:, sl].norm())
        assert norm > 0, name
        assert float((got[:, sl] - ref[:, sl]).norm()) / norm <= GRAD_TOL, name


@pytest.mark.parametrize("want_dist", [False, True])
def test_backward_worklist_matches_plain(deep_table, want_dist):
    """B2's work list against its plain version: the tile walks equal, and
    the tiles taken in the plain order's buckets (the order within a bucket
    varies with the atomics)."""
    args = deep_table[want_dist]
    n_tiles = args[3].numel()
    grad = torch.zeros((args[0].shape[0], rasterize_cuda_bwd.GRAD_F), device=args[0].device)
    work = rasterize_cuda_bwd.worklist(
        rasterize_cuda_bwd.launch_backward(args, grad, want_dist=want_dist), n_tiles)
    walk = rasterize_cuda_bwd.tile_walks(args[4], args[3], args[7], args[8])
    ref = rasterize_cuda_bwd.tile_order_plain(walk)
    assert torch.equal(work["walk"].long(), walk)
    assert torch.equal(torch.sort(work["order"])[0], torch.sort(ref)[0])
    bucket = rasterize_cuda_bwd.walk_buckets(walk)
    assert torch.equal(bucket[work["order"].long()], bucket[ref.long()])


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
    b, table, cam = entry_table
    with pytest.raises(ValueError, match="different devices"):
        rasterize_cuda.rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count,
                                         torch.zeros(3), cam.width, cam.height)
    with pytest.raises(ValueError, match="gauss_id"):
        rasterize_cuda.rasterize_entries(table, b.gauss_id.cpu(), b.tile_start, b.tile_count,
                                         torch.zeros(3, device=table.device), cam.width,
                                         cam.height)


# B3 against chunked_attention: max|kernel - plain| <= 1e-4 * max|plain| (fp32
# sums in another order, exp2 in place of exp, 3xTF32 products).
B3_TOL = 1e-4
# ±30-scaled logits (scores of size ~3000, where one score's fp32 rounding
# moves near-tied softmax weights) are graded against a float64 reference,
# with the fp32 plain version's own distance from it as the yardstick:
# max|kernel - ref64| <= max(B3_TOL * max|ref64|, B3_TOL64 * max|plain - ref64|).
# There the fp32 plain version itself lies ~3e-4 * max from float64, so any
# other order of summation can move it by more than 1e-4 * max: against the
# plain version the gate would measure summation order, not accuracy. They
# are held at D <= 64: at D = 128 two plain fp32 versions, dense and chunked,
# already differ by more than 1e-4 (chip_smoke.py phase 10 prints both).
B3_TOL64 = 1.5


def attention64(q, k, v):
    """softmax(QKᵀ/√D)V in float64, (B, N, H, D): the accuracy reference."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) / q.shape[-1] ** 0.5
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.double())


# (B, N, M, H, logit scale, D). N = 4100 is no multiple of a query tile.
CASES = [(2, n, m, 3, 1.0, d) for n, m in ((50, 33), (1000, 257), (64, 77))
         for d in (16, 32, 64, 128)]
CASES += [(18, 4100, 77, 5, 1.0, 64), (2, 4096, 4096, 5, 1.0, 64)]
CASES += [(2, 130, 130, 3, 30.0, d) for d in (16, 32, 64)]


@pytest.mark.parametrize("B,N,M,H,scale,D", CASES)
def test_attention_kernel_matches_plain(cuda, B, N, M, H, scale, D):
    gen = torch.Generator(device=cuda).manual_seed(N + M + D)
    q = scale * torch.randn((B, N, H, D), device=cuda, generator=gen)
    k = scale * torch.randn((B, M, H, D), device=cuda, generator=gen)
    v = torch.randn((B, M, H, D), device=cuda, generator=gen)
    before = attention_cuda.ATTENTION_FWD.launches
    got = attention_cuda.attention_fwd(q, k, v)
    assert attention_cuda.ATTENTION_FWD.launches == before + 1
    ref = chunked_attention(q, k, v, q_chunk=128, kv_chunk=96)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if scale == 1.0:
        assert float((got - ref).abs().max()) <= B3_TOL * float(ref.abs().max())
    else:
        r64 = attention64(q, k, v)
        tol = max(B3_TOL * float(r64.abs().max()), B3_TOL64 * float((ref - r64).abs().max()))
        assert float((got - r64).abs().max()) <= tol


def test_attention_kernel_reads_strided_views(cuda):
    """q, k, v sliced out of one fused (B, N, 3, H, D) projection, as a qkv
    Linear reshaped gives them: the kernel reads them through their strides."""
    qkv = torch.randn((2, 300, 3, 4, 64), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(3))
    q, k, v = qkv.unbind(2)
    got = attention_cuda.attention_fwd(q, k, v)
    ref = chunked_attention(q, k, v)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= B3_TOL * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float64])
def test_attention_kernel_refuses_non_f32(cuda, dtype):
    q = torch.zeros((1, 8, 2, 16), device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="float32"):
        attention_cuda.attention_fwd(q, q, q)


def test_attention_kernel_refuses_bad_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        attention_cuda.attention_fwd(q, q, q)


def test_attention_kernel_rejects_mixed_devices(cuda):
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        attention_cuda.attention_fwd(q, torch.zeros((1, 8, 2, 16)), q)


def test_memory_efficient_attention_goes_through_b3(cuda):
    """Small and large problems alike: on the card every call is B3."""
    for n in (16, 5000):
        q = torch.randn((1, n, 2, 32), device=cuda)
        before = attention_cuda.ATTENTION_FWD.launches
        out = memory_efficient_attention(q, q, q)
        assert attention_cuda.ATTENTION_FWD.launches == before + 1
        assert out.shape == q.shape


def test_see3d_stage_runs_b3_on_the_card_and_refuses_host_priors(cuda):
    """run_see3d_inpaint defaults to the card: priors there run every UNet
    attention through B3 (2 launches per transformer block and UNet call);
    card inputs with priors left on the CPU are refused, not moved."""
    from g4splat_torch.pipeline.orchestrator import Priors
    from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint
    from g4splat_torch.priors import see3d, vae

    def priors(device):
        torch.manual_seed(0)
        with torch.device(device):
            unet = see3d.MultiViewUNet(see3d.TINY_UNET).eval()
            ae = vae.AutoencoderKL(base_ch=16, ch_mult=(1, 2)).eval()
        return Priors(see3d=see3d.See3DPipeline(unet, see3d.DDIMConfig(num_steps=2)), vae=ae)

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32)).to(cuda)
    warps = [torch.from_numpy(rng.rand(16, 16, 3).astype(np.float32)).to(cuda)
             for _ in range(2)]
    masks = [(w[..., 0] > 0.3).float() for w in warps]
    with pytest.raises(ValueError, match="priors.vae lies on"):
        run_see3d_inpaint(priors("cpu"), images, 2, warps, masks, 1, mvd_resolution=None)
    p = priors(cuda)
    before = attention_cuda.ATTENTION_FWD.launches
    outs, _ = run_see3d_inpaint(p, images, 2, warps, masks, 1, mvd_resolution=None)
    calls = len(p.see3d.sampler.timesteps)
    assert (attention_cuda.ATTENTION_FWD.launches - before
            == 2 * see3d.TINY_UNET.n_transformer_blocks() * calls)
    assert all(o.device.type == "cuda" and bool(torch.isfinite(o).all()) for o in outs)


def sphere_on(device, n=600, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return GaussianScene.from_points((0.5 * d).astype(np.float32), rng.rand(n, 3),
                                     scales=np.full(n, 0.08, np.float32),
                                     quats=rng.randn(n, 4), initial_opacity=0.95, device=device)


def ring_on(device, k=4, w=64, h=48):
    from g4splat_torch.core.cameras import stack_cameras

    return stack_cameras([lookat_camera([2.5 * np.cos(a), 0.2, 2.5 * np.sin(a)], [0, 0, 0],
                                        [0, -1, 0], fx=60.0, fy=60.0, width=w, height=h,
                                        device=device)
                          for a in np.arange(k) * 2 * np.pi / k])


def maps_agree(got, ref):
    """Each map's pixels within MAP_TOL·max|ref| (ABS_FLOOR), all but FLIP_FRAC."""
    for g, r in zip(got, ref):
        d = (g - r).abs()
        d = d.amax(-1) if d.ndim == 4 else d
        tol = max(MAP_TOL * float(r.abs().max()), ABS_FLOOR)
        assert float((d > tol).float().mean()) < FLIP_FRAC


def test_render_all_views_cuda_matches_tiled(cuda):
    """The mesh path's renders: one B1 launch per view, maps as the tiled
    backend's; and the TSDF from either set of maps agrees."""
    from g4splat_torch.ops.tsdf import TSDFConfig, integrate_views_chunked
    from g4splat_torch.pipeline.mesh_extraction import render_all_views

    scene, cams = sphere_on(cuda), ring_on(cuda)
    before = rasterize_cuda.RASTERIZE_FWD.launches
    got = render_all_views(scene, cams, 1.0, backend="cuda")
    assert rasterize_cuda.RASTERIZE_FWD.launches == before + 4
    ref = render_all_views(scene, cams, 1.0, backend="tiled")
    maps_agree(got, ref)
    pts, _ = scene.tetra_points(flatness=1e-3)
    cfg = TSDFConfig(trunc_margin=0.02)
    a = integrate_views_chunked(pts, cams, got.rgbs, got.depths, cfg, chunk=1000).tsdf
    b = integrate_views_chunked(pts, cams, ref.rgbs, ref.depths, cfg, chunk=1000).tsdf
    assert float(((a - b).abs() > 1e-3).float().mean()) < FLIP_FRAC


def test_tsdf_on_the_card_matches_cpu(cuda):
    from g4splat_torch.ops.tsdf import TSDFConfig, integrate_views

    rng = np.random.RandomState(1)
    cams = ring_on(cuda, k=3, w=32, h=24)
    depths = torch.from_numpy(2.0 + 0.1 * rng.rand(3, 24, 32).astype(np.float32))
    images = torch.from_numpy(rng.rand(3, 24, 32, 3).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-0.6, 0.6, (4096, 3)).astype(np.float32))
    for kw in ({}, dict(use_binary_opacity=True), dict(weight_by_softmax=True)):
        cfg = TSDFConfig(trunc_margin=0.2, **kw)
        card = integrate_views(pts.to(cuda), cams, images.to(cuda), depths.to(cuda), cfg)
        host = integrate_views(pts, cams.to("cpu"), images, depths, cfg)
        assert card.tsdf.device.type == "cuda"
        for x, y in zip(card, host):
            torch.testing.assert_close(x.cpu(), y, atol=1e-5, rtol=1e-5)


def test_mesh_extraction_runs_b1_on_the_card(cuda):
    from g4splat_torch.pipeline.mesh_extraction import (
        MeshExtractionConfig,
        extract_mesh_adaptive_tsdf,
    )

    scene, cams = sphere_on(cuda), ring_on(cuda)
    cfg = MeshExtractionConfig(downsample_ratio=0.5, n_binary_steps=4, point_chunk=16384,
                               use_interpolated_views=True, interp_neighbors=1,
                               interp_per_neighbor=2)
    before = rasterize_cuda.RASTERIZE_FWD.launches
    mesh = extract_mesh_adaptive_tsdf(scene, cams, cfg)
    assert rasterize_cuda.RASTERIZE_FWD.launches == before + 2 * (4 + 4 * 2)
    assert len(mesh.faces) > 100 and np.isfinite(mesh.vertices).all()
    assert (mesh.vertex_colors >= 0).all() and (mesh.vertex_colors <= 1).all()
