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


# ------------------------------------------------------------------ binning

# (splats, seed, cube half-width, camera z, width, height): chip_smoke's
# phase-3 check scenes (spread, deep overlap, the spread scene from close by,
# whose large splats run past a 16-tile cap) and a frame whose sides are no
# multiple of 16.
BIN_SCENES = {
    "spread": (8000, 1, 2.0, -5.5, 256, 192),
    "deep-overlap": (8000, 3, 0.35, -5.5, 256, 192),
    "near": (8000, 1, 2.0, -2.6, 256, 192),
    "ragged": (8000, 1, 2.0, -3.0, 250, 190),
}


def bin_prep(scene, w, h, eye, target=(0, 0, 0), fx=220.0):
    cam = lookat_camera(list(eye), list(target), [0, -1, 0], fx=fx, fy=fx, width=w, height=h,
                        device=scene.xyz.device)
    return preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw, scene.opacity(),
                      scene.features(), 0, config=RenderConfig())


def binning_equal(prep, w, h, **kw):
    """The kernel chain against the plain binning on the same card tensors:
    every field that is read, bit for bit. Returns the kernel's binning."""
    from g4splat_torch.ops.rasterize_tiled import BINNING, bin_splats_plain

    before = BINNING.launches
    got = bin_splats(prep, w, h, **kw)
    assert BINNING.launches == before + 1
    ref = bin_splats_plain(prep, w, h, **kw)
    torch.cuda.synchronize()
    for k in ("gauss_id", "tile_id", "tile_start", "tile_count", "n_dropped"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), k
    assert int(got.n_overflow) == 0
    return got, ref


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("cap", [16, 256])
@pytest.mark.parametrize("name", list(BIN_SCENES))
def test_binning_kernel_matches_plain(cuda, name, cap, prune):
    n, seed, spread, z, w, h = BIN_SCENES[name]
    rng = np.random.RandomState(seed)
    scene = GaussianScene.from_points(
        rng.uniform(-spread, spread, (n, 3)), rng.rand(n, 3),
        scales=np.exp(rng.uniform(-3.5, -2.0, n)), quats=rng.randn(n, 4),
        initial_opacity=0.7, capacity=n + 1024, device=cuda)      # dead slots at the end
    got, _ = binning_equal(bin_prep(scene, w, h, (0, 0, z)), w, h, max_tiles_per_splat=cap,
                           ellipse_prune=prune)
    assert got.gauss_id.numel() > 0 and int(got.tile_count.sum()) == got.gauss_id.numel()
    if name == "near" and cap == 16:
        assert int(got.n_dropped) > 0


@pytest.mark.parametrize("prune", [True, False])
def test_binning_kernel_matches_plain_at_the_training_shape(cuda, prune):
    """chip_smoke's training scene: 1.2M live splats of the room shell in 2.4M
    slots, at 512x384 from its first training camera."""
    import chip_smoke

    xyz, cols, scales, quats = chip_smoke.scene_arrays(1_200_000, 11)
    scene = GaussianScene.from_points(xyz, cols, scales=scales, quats=quats,
                                      capacity=2_400_000, initial_opacity=0.5, device=cuda)
    prep = bin_prep(scene, 512, 384, (0, -0.8, -6.5), fx=400.0)
    assert int(prep.valid.sum()) > 500_000
    got, ref = binning_equal(prep, 512, 384, ellipse_prune=prune)
    assert got.gauss_id.numel() > 1_000_000


def test_binning_kernel_with_zero_entries(cuda):
    """A frame that sees no splat (all behind the camera) and a scene of dead
    slots: empty entry lists, every tile empty."""
    rng = np.random.RandomState(2)
    scene = GaussianScene.from_points(rng.uniform(-1, 1, (500, 3)), rng.rand(500, 3),
                                      initial_opacity=0.7, device=cuda)
    for prep in (bin_prep(scene, 100, 70, (0, 0, 5.5), target=(0, 0, 10)),
                 bin_prep(GaussianScene.empty(64, device=cuda), 100, 70, (0, 0, -5.5))):
        got, _ = binning_equal(prep, 100, 70)
        assert got.gauss_id.numel() == 0 and not got.tile_count.any()
        assert not got.tile_start.any()


# --------------------------------------------------------------- preprocess

# The preprocess kernels (csrc/preprocess.cu) against their plain forms and
# the torch chain. Forward, against the plain form on the same card tensors:
# every field but the colour bit for bit (the geometry rounds as the plain
# form, op for op), the SH colour within PRE_TOL · max|plain rgb| at every
# slot (it is summed with fused multiply-adds). Against the torch chain
# (rasterize_common.preprocess), which rounds in another order (einsum,
# reductions, rsqrt): the same tolerance at all but PRE_FLIP of the slots.
# There the extent's half_sq = c² − f·Tu·Tu leaves ~25 px² out of two terms
# as large as the pixel coordinate squared (~1e5 px²), so the chain's other
# rounding moves an extent by up to ~1e-3 px and its ceil (radius, valid)
# flips at up to ~1e-3 of the slots; a normal flips where p_view lies within
# rounding of its plane, and a near-degenerate conic amplifies the rounding
# of its centre by |Tw2² / dist|.
PRE_TOL = 1e-5
PRE_FLIP = 1e-3
# Backward, per gradient group, ||kernel - ref|| / ||ref||. Against the plain
# form: T and the conic are recomputed bit for bit, the rest contracts into
# fused multiply-adds and associates otherwise, a few ulp of the group:
# PRE_GRAD_TOL. Against autograd of the torch chain, which rounds T, the conic
# and the centre otherwise: train_room's own gradient limit, PRE_CHAIN_TOL.
# The centre offset's gradient is the centre's cotangent where valid: equal.
PRE_GRAD_TOL = 1e-5
PRE_CHAIN_TOL = 1e-3
PRE_FIELDS = ("T", "center", "normal", "rgb", "radius", "depth", "valid")


def pre_scene(cuda, name):
    """(scene, camera, sh degree) of a preprocess check scene."""
    import chip_smoke

    if name == "training":
        xyz, cols, scales, quats = chip_smoke.scene_arrays(1_200_000, 11)
        scene = GaussianScene.from_points(xyz, cols, scales=scales, quats=quats,
                                          capacity=2_400_000, initial_opacity=0.5,
                                          device=cuda)
        cam = lookat_camera([0, -0.8, -6.5], [0, 0, 0], [0, -1, 0], fx=400.0, fy=400.0,
                            width=512, height=384, device=cuda)
        degree = 3
    else:
        n, seed, spread, z, w, h = BIN_SCENES[name]
        rng = np.random.RandomState(seed)
        scene = GaussianScene.from_points(
            rng.uniform(-spread, spread, (n, 3)), rng.rand(n, 3),
            scales=np.exp(rng.uniform(-3.5, -2.0, n)), quats=rng.randn(n, 4),
            initial_opacity=0.7, capacity=n + 1024, device=cuda)      # dead slots
        cam = lookat_camera([0, 0, z], [0, 0, 0], [0, -1, 0], fx=220.0, fy=220.0, width=w,
                            height=h, device=cuda)
        degree = {"spread": 0, "deep-overlap": 1, "near": 2, "ragged": 3}[name]
    gen = torch.Generator(device=cuda).manual_seed(5)
    f_dc = scene.f_dc + 0.8 * torch.randn(scene.f_dc.shape, generator=gen, device=cuda)
    f_rest = 0.2 * torch.randn(scene.f_rest.shape, generator=gen, device=cuda)
    return scene.replace(f_dc=f_dc, f_rest=f_rest, active_sh_degree=degree), cam, degree


def pre_args(scene, cam, degree, offset, override):
    P, dev = scene.capacity, scene.device
    gen = torch.Generator(device=dev).manual_seed(6)
    off = 0.7 * torch.randn((P, 2), generator=gen, device=dev) if offset else None
    col = torch.rand((P, 3), generator=gen, device=dev) if override else None
    args = (scene.xyz, scene.scaling(), scene.rotation_raw, scene.f_dc, scene.f_rest, col, off,
            scene.opacity().reshape(-1), cam.w2c, cam.world2pix)
    return args, (degree, 1.0, cam.width, cam.height)


def fields_agree(got, ref, flip):
    """Each field's share of slots off by more than PRE_TOL · max|ref| (any
    difference for radius and valid), which must stay at or under `flip`."""
    shares = {}
    for k, a, b in zip(PRE_FIELDS, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in ("radius", "valid"):
            off = a != b
        else:
            off = (a - b).abs() > PRE_TOL * float(b.abs().max())
            off = off.reshape(off.shape[0], -1).any(1)
        shares[k] = float(off.float().mean())
        assert shares[k] <= flip, (k, shares[k], int(off.sum()))
    return shares


PRE_CASES = [("spread", False, False), ("deep-overlap", True, False), ("near", True, True),
             ("ragged", False, True), ("training", True, False)]


@pytest.mark.parametrize("name,offset,override", PRE_CASES)
def test_preprocess_kernel_matches_plain_and_chain(cuda, name, offset, override):
    from g4splat_torch.ops import preprocess_cuda as pc

    scene, cam, degree = pre_scene(cuda, name)
    args, geom = pre_args(scene, cam, degree, offset, override)
    before = pc.PREPROCESS_FWD.launches
    got = pc.forward_cuda(*args, *geom)
    assert pc.PREPROCESS_FWD.launches == before + 1
    plain = pc.forward_plain(*args, *geom)
    torch.cuda.synchronize()
    gaps = fields_agree(got, plain, 0.0)
    same = {k: bool(torch.equal(a, b)) for k, a, b in zip(PRE_FIELDS, got, plain)}
    print(f"\n  {name}: kernel vs plain, shares of slots off {gaps}; bit-identical {same}")
    assert all(v for k, v in same.items() if k != "rgb"), same
    x, s, q, dc, rest, col, off, opa, w2c, M = args
    ch = preprocess(cam, x, s, q, opa[:, None], torch.cat([dc, rest], 1), degree, colors=col,
                    center_offset=off)
    chain = tuple(getattr(ch, k) for k in PRE_FIELDS)
    print(f"  {name}: kernel vs chain {fields_agree(got, chain, PRE_FLIP)}")
    assert int(got[-1].sum()) > 0.3 * int(scene.num_alive)


def group_gaps(got, ref):
    """||got - ref|| / ||ref|| per group given; a group that is zero in ref
    (f_rest at degree 0) reads max|got|, so it has to be zero too."""
    names = ("xyz", "scaling", "rotation_raw", "f_dc", "f_rest", "colors", "center_offset")
    return {k: float((a - b).norm()) / float(b.norm()) if float(b.norm()) > 0
            else float(a.abs().max()) for k, a, b in zip(names, got, ref) if b is not None}


@pytest.mark.parametrize("name,offset,override", PRE_CASES)
def test_preprocess_backward_kernel_matches_plain_and_autograd(cuda, name, offset, override):
    """Seeded cotangents, handed over as B2 hands them (column slices of one
    (P, 18) table), through the kernel, the plain form and autograd of the
    torch chain."""
    from g4splat_torch.ops import preprocess_cuda as pc

    scene, cam, degree = pre_scene(cuda, name)
    args, geom = pre_args(scene, cam, degree, offset, override)
    P = scene.capacity
    valid = pc.forward_plain(*args, *geom)[-1]
    table = torch.randn((P, 18), generator=torch.Generator(device=cuda).manual_seed(7),
                        device=cuda)
    cots = (table[:, 0:9].reshape(P, 3, 3), table[:, 9:11], table[:, 12:15], table[:, 15:18])
    x, s, q, dc, rest, col, off, opa, w2c, M = args
    bargs = (x, s, q, dc, rest, col, w2c, M, valid) + cots + (offset, degree, 1.0)
    before = pc.PREPROCESS_BWD.launches
    got = pc.backward_cuda(*bargs)
    assert pc.PREPROCESS_BWD.launches == before + 1
    plain = pc.backward_plain(*bargs)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert (a is None) == (b is None)
    gaps = group_gaps(got, plain)
    print(f"\n  {name}: kernel vs plain {gaps}")
    assert all(v <= PRE_GRAD_TOL for v in gaps.values()), gaps
    if offset:
        assert torch.equal(got[-1], plain[-1])
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in (x, s, q, dc, rest, col, off)]
    ch = preprocess(cam, *leaves[:3], opa[:, None], torch.cat(leaves[3:5], 1), degree,
                    colors=leaves[5], center_offset=leaves[6])
    loss = sum((o * c).sum() for o, c in zip((ch.T, ch.center, ch.rgb, ch.normal), cots))
    want = [i for i, t in enumerate(got) if t is not None]
    auto = torch.autograd.grad(loss, [leaves[i] for i in want])
    ref = [None] * 7
    for i, g in zip(want, auto):
        ref[i] = g
    gaps = group_gaps(got, ref)
    print(f"  {name}: kernel vs autograd of the chain {gaps}")
    assert all(v <= PRE_CHAIN_TOL for v in gaps.values()), gaps


def test_render_on_the_card_runs_the_preprocess_kernels(cuda):
    """render() on CUDA tensors runs both kernels once per call and step;
    a camera that requires grad takes the torch chain and gets its gradient."""
    from g4splat_torch.core.cameras import camera_at
    from g4splat_torch.ops import preprocess_cuda as pc

    scene, cam = sphere_on(cuda), camera_at(ring_on(cuda), 0)
    params = {k: getattr(scene, k).clone().requires_grad_(True) for k in ("xyz", "f_dc")}
    counts = pc.PREPROCESS_FWD.launches, pc.PREPROCESS_BWD.launches
    render(cam, scene.replace(**params), backend="cuda")["render"].sum().backward()
    assert (pc.PREPROCESS_FWD.launches, pc.PREPROCESS_BWD.launches) == (counts[0] + 1,
                                                                      counts[1] + 1)
    cam_g = cam.replace(w2c=cam.w2c.clone().requires_grad_(True))
    render(cam_g, scene, backend="cuda")["render"].sum().backward()
    assert (pc.PREPROCESS_FWD.launches, pc.PREPROCESS_BWD.launches) == (counts[0] + 1,
                                                                      counts[1] + 1)
    assert float(cam_g.w2c.grad.abs().sum()) > 0


def test_training_step_before_and_after_the_preprocess_kernels(cuda, monkeypatch):
    """train_room's problem and check (perfbench's train_2dgs driver: three
    steps from iteration 2397, the loss, the first gradient's and the
    change's norms per leaf) with the torch chain forced (a camera taken as
    requiring grad) and with the kernels: within train_room's own limits."""
    import json
    from pathlib import Path

    from g4splat_torch.ops import preprocess_cuda as pc
    from g4splat_torch.ops import rasterize
    from perfbench.drivers.train_2dgs import TrainCell, compare

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "perfbench/configs/room_2dgs.json").read_text())
    traffic = json.loads((root / "perfbench/workloads/train_window.json").read_text())
    got = {}
    for path in ("chain", "kernel"):
        with monkeypatch.context() as m:
            if path == "chain":
                m.setattr(rasterize, "camera_requires_grad", lambda cam: True)
            before = pc.PREPROCESS_FWD.launches, pc.PREPROCESS_BWD.launches
            cell = TrainCell(config, traffic, 2147483901, cuda)
            ran = (pc.PREPROCESS_FWD.launches - before[0], pc.PREPROCESS_BWD.launches - before[1])
        got[path] = cell.got
        steps = traffic["check_steps"] + 1
        if path == "chain":
            assert ran == (0, 0)
        else:
            assert ran[0] >= steps and ran[1] >= steps, ran
        del cell
        torch.cuda.empty_cache()
    checks = compare(got["kernel"], got["chain"])
    print("\n  kernel vs chain, train_room's check: " + str(checks))
    for name, v in checks:
        assert v <= traffic["limits"][name], (name, v)
