"""Parity of the port's multi-device layer (`g4splat_torch.parallel`, the
priors' mesh batches, See3D's sharded denoise and the orchestrator's
fan-out) on the CPU.

Against the JAX package (same numpy inputs): `compose_slabs`,
`outputs_from_slab_maps`, the partitions and the MV-UNet's sharded joint
attention (the JAX `BasicTransformerBlock3D`'s `axis_name` branch under a
2-device `shard_map`, TINY_UNET's weights carried across by the JAX
package's converter and `convert.flax_state_dict`), within 1e-5 of
max|JAX|.

Against the port's own single-device paths, which the other files hold to
the JAX package: every mesh path on meshes of 2-8 entries of "cpu" (a
virtual mesh, as the JAX tests use virtual CPU devices). Renders go through
the `cuda` backend, whose wrappers run B1's plain version on CPU tensors:
view fan-out bit-equal to per-view render(); tile strips within B1's map
gate (1e-3·max|full frame|, under 1e-3 of pixels off; the cropped camera
rounds pixel centres differently); depth slabs within 1e-5·max on every
map but the median, on the pixels where the single render did not stop
early at T < 1e-4 (ROADMAP C26), the median's disagreeing share bounded.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import g4splat_torch.pipeline.orchestrator as TO
import g4splat_tpu.priors.see3d as JS
from g4splat_torch.convert import flax_state_dict, scene_from
from g4splat_torch.core.cameras import camera_at, lookat_camera, stack_cameras
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig
from g4splat_torch.parallel import gaussian_shard as G
from g4splat_torch.parallel import mesh as M
from g4splat_torch.priors import see3d as TS
from g4splat_tpu.core.cameras import lookat_camera as jlookat
from g4splat_tpu.core.cameras import stack_cameras as jstack
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.parallel import gaussian_shard as JG
from g4splat_tpu.parallel.mesh import make_mesh as jmake_mesh

W_, H_ = 64, 48
MAP_TOL, FLIP_FRAC = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_data, n_model=1):
    return M.make_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def scene_points(n, seed):
    rng = np.random.RandomState(seed)
    return dict(points=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                colors=rng.rand(n, 3).astype(np.float32),
                scales=np.exp(rng.uniform(-3.4, -2.4, n)).astype(np.float32),
                quats=rng.randn(n, 4).astype(np.float32), initial_opacity=0.75)


def orbit(a, W=W_, H=H_):
    return [2.8 * np.sin(a), 0.2, -2.8 * np.cos(a)], dict(fx=60.0, fy=60.0, width=W, height=H)


@pytest.fixture(scope="module")
def scene():
    return GaussianScene.from_points(**scene_points(900, 7), device="cpu")


@pytest.fixture(scope="module")
def cams():
    return stack_cameras([lookat_camera(e, [0, 0, 0], [0, -1, 0], device="cpu", **kw)
                          for e, kw in map(orbit, np.linspace(0, 1.4, 8))])


# ------------------------------------------------------- against the JAX package
def slab_maps(seed, n=4, H=12, W=10):
    """Random (n, H, W, 13) slab maps: T crossing 0.5 in slabs d > 0 at some
    pixels, and a block of pixels that no slab reaches."""
    rng = np.random.RandomState(seed)
    maps = rng.uniform(0.0, 1.0, (n, H, W, 13)).astype(np.float32)
    T = rng.uniform(0.35, 1.0, (n, H, W)).astype(np.float32)
    T[0, :4] = rng.uniform(0.85, 1.0, (4, W))     # crossings pushed into slabs d > 0
    maps[..., 10] = T
    maps[..., 7] = 1.0 - T
    maps[:, -3:, -3:, :] = 0.0                     # no contributor
    maps[:, -3:, -3:, 10] = 1.0
    maps[..., 8] *= 1e-2
    return maps


@pytest.mark.parametrize("seed", [0, 1])
def test_compose_slabs_matches_jax(seed):
    maps = slab_maps(seed)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ref = jax.jit(JG.compose_slabs)(jnp.asarray(maps), jnp.asarray(bg))
    got = G.compose_slabs(torch.from_numpy(maps), torch.from_numpy(bg))
    T_d = maps[..., 10]
    P_d = np.concatenate([np.ones_like(T_d[:1]), np.cumprod(T_d, 0)[:-1]])
    cross = (P_d > 0.5) & (np.cumprod(T_d, 0) <= 0.5)
    assert cross[1:].any() and not (maps[..., 7] > 0).any(0).all()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert rel_err(got[k].numpy(), ref[k]) <= 1e-5, k


def test_outputs_from_slab_maps_matches_jax():
    maps = slab_maps(2, H=16, W=20)
    maps[..., 9] += 2.0                           # medians at a plausible depth
    eye, kw = orbit(0.3, W=20, H=16)
    kw = dict(kw, fx=14.0, fy=14.0)
    ref = jax.jit(JG.outputs_from_slab_maps, static_argnums=2)(
        jlookat(eye, [0, 0, 0], [0, -1, 0], **kw), jnp.asarray(maps), 0.5)
    got = G.outputs_from_slab_maps(lookat_camera(eye, [0, 0, 0], [0, -1, 0], device="cpu",
                                                 **kw), torch.from_numpy(maps), 0.5)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert rel_err(got[k].numpy(), ref[k]) <= 1e-5, k


def test_partitions_match_jax():
    """Same splats per slab (in the same order) and the same per-view depth
    orders, dead slots last; 3 slabs of ⌈alive/3⌉ rounded up to 8."""
    kw = scene_points(200, 3)
    alive = np.random.RandomState(4).rand(256) > 0.2
    js = JScene.from_points(**kw, capacity=256)
    js = js.replace(alive=jnp.asarray(alive) & js.alive)
    ts = scene_from(js, device="cpu")
    views = [orbit(a) for a in (0.0, 0.9, 2.0)]
    jc = jstack([jlookat(e, [0, 0, 0], [0, -1, 0], **k) for e, k in views])
    tc = stack_cameras([lookat_camera(e, [0, 0, 0], [0, -1, 0], device="cpu", **k)
                        for e, k in views])
    jsl = JG.partition_by_view_depth(js, jax.tree.map(lambda x: x[1], jc), 3)
    tsl = G.partition_by_view_depth(ts, camera_at(tc, 1), 3)
    n_alive = int(np.asarray(js.alive).sum())
    cap = (-(-n_alive // 3) + 7) // 8 * 8
    assert [s.capacity for s in tsl] == [s.capacity for s in jsl] == [cap] * 3
    for a, b in zip(tsl, jsl):
        for k in G.SCENE_ROWS:
            np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(b, k)), k)
    np.testing.assert_array_equal(G.view_depth_permutations(ts, tc).numpy(),
                                  np.asarray(JG.view_depth_permutations(js, jc)))


@pytest.fixture(scope="module")
def tiny_unet():
    """TINY_UNET on seeded weights (the zero-init layers perturbed) in both
    packages: the port's state dict through the JAX package's converter,
    and back through `convert.flax_state_dict` (no flax init to compile)."""
    torch.manual_seed(0)
    seeded = TS.MultiViewUNet(TS.TINY_UNET)
    sd = {k: (v + 0.01 if v.ndim >= 2 else v).numpy() for k, v in seeded.state_dict().items()}
    params = JS.convert_torch_see3d(sd, JS.TINY_UNET)
    port = TS.MultiViewUNet(TS.TINY_UNET)
    port.load_state_dict(flax_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return JS.MultiViewUNet(JS.TINY_UNET), params, port.eval()


def test_sharded_block_matches_jax(tiny_unet):
    """BasicTransformerBlock3D's sharded branch: 2F = 6 cond + uncond frames
    over 2 entries, each entry's `Shard` in the port against the JAX block's
    axis_name branch under a 2-device shard_map (each entry's 3 frames
    attend to their branch's 3·l keys), and against the port's unsharded
    block."""
    _, params, port = tiny_unet
    blk = port.input_blocks[1][1].transformer_blocks[0]
    jblk = JS.BasicTransformerBlock3D(blk.attn1.heads, blk.attn1.dim_head)
    jparams = {"params": params["params"]["input_blocks_1_1"]["transformer_blocks_0"]}
    F, c = 3, blk.attn1.heads * blk.attn1.dim_head
    rng = np.random.RandomState(5)
    x = rng.randn(2 * F, 16, c).astype(np.float32)
    ctx = rng.randn(2 * F, 4, 16).astype(np.float32)
    go = jax.jit(jax.shard_map(
        lambda p, a, b: jblk.apply(p, a, b, F, axis_name="data"),
        mesh=jmake_mesh(n_data=2, devices=jax.devices()[:2]),
        in_specs=(P(), P("data"), P("data")), out_specs=P("data"), check_vma=False))
    ref = np.asarray(go(jparams, x, ctx))
    xt, ct = torch.from_numpy(x), torch.from_numpy(ctx)

    def entry(shard):
        part = slice(shard.index * F, (shard.index + 1) * F)
        return blk(xt[part], ct[part], F, shard=shard)

    with torch.no_grad():
        got = torch.cat(M.run_spmd(["cpu", "cpu"], entry)).numpy()
        whole = blk(xt, ct, F).numpy()
    assert rel_err(got, ref) <= 1e-5
    assert rel_err(got, whole) <= 1e-5


# ---------------------------------------------------- the mesh and its threads
def test_make_mesh_and_batches():
    mesh = M.make_mesh(2, 2, devices=["cpu"] * 5)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.distinct == [torch.device("cpu")]
    assert M.available_devices(torch.device("cpu")) == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="no such CUDA device"):
        M.make_mesh(2, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="devices"):
        M.make_mesh(3, 2, devices=["cpu"] * 4)
    x = torch.arange(12.0).reshape(6, 2)
    parts = M.shard_batch(cpu_mesh(3), {"x": x, "s": torch.tensor(1.0)})
    assert [p["x"].tolist() for p in parts] == [x[0:2].tolist(), x[2:4].tolist(),
                                                x[4:6].tolist()]
    with pytest.raises(ValueError, match="divide"):
        M.shard_batch(cpu_mesh(4), x)
    padded, pad = M.pad_to_multiple(x[:5], 4)
    assert pad == 3 and torch.equal(padded[5:], x[4:5].expand(3, 2))
    out = M.map_over_data(cpu_mesh(4), lambda dev, a: (a * 2, {"s": a.sum(1)}), x[:5],
                          per_device=1)
    assert torch.equal(out[0], x[:5] * 2) and torch.equal(out[1]["s"], x[:5].sum(1))


def test_threads_on_distinct_devices():
    """"cpu" and "cpu:0" count as two devices: fan_out runs each in its own
    thread under the caller's grad mode, run_spmd's gather meets in entry
    order, and a failing entry's exception reaches the caller while the
    others leave the barrier."""
    seen, both = [], threading.Barrier(2, timeout=60)

    def fn(i):
        if i < 2:
            both.wait()                   # returns only if both devices run at once
        seen.append((i, torch.is_grad_enabled()))
        return i * 10

    with torch.no_grad():
        assert M.fan_out(["cpu", "cpu:0", "cpu"], fn) == [0, 10, 20]
    assert sorted(seen) == [(0, False), (1, False), (2, False)]
    got = M.run_spmd(["cpu"] * 3, lambda s: s.all_gather(torch.full((2,), float(s.index))))
    assert all(torch.equal(g, torch.tensor([0.0, 0, 1, 1, 2, 2])) for g in got)

    def failing(s):
        s.all_gather(torch.zeros(1))
        if s.index == 1:
            raise KeyError("entry 1")
        return s.all_gather(torch.zeros(1))

    with pytest.raises(KeyError, match="entry 1"):
        M.run_spmd(["cpu"] * 3, failing, timeout=60)


# ---------------------------------------------- against the port's single device
@pytest.fixture(scope="module")
def view_refs(scene, cams):
    cfg = RenderConfig(depth_ratio=0.0, compute_distortion=False)
    with torch.no_grad():
        return [render(camera_at(cams, i), scene, config=cfg, backend="cuda")
                for i in range(8)]


@pytest.mark.parametrize("n", [4, 8])
def test_view_parallel_render_matches_per_view(scene, cams, view_refs, n):
    keys = ("render", "rend_alpha", "rend_normal", "surf_depth")
    with torch.no_grad():
        out = M.view_parallel_render(cpu_mesh(n), scene, cams, backend="cuda", keys=keys)
    for k in keys:
        assert out[k].shape == (8,) + view_refs[0][k].shape
        for i in range(8):
            assert torch.equal(out[k][i], view_refs[i][k]), (k, i)
    with pytest.raises(ValueError, match="divide"):
        M.view_parallel_render(cpu_mesh(n), scene, stack_cameras(
            [camera_at(cams, i) for i in range(n - 1)]), backend="cuda")


def map_gate(got, ref, what):
    scale = max(float(ref.abs().max()) * MAP_TOL, 1e-6)
    bad = (got - ref).abs().reshape(ref.shape[0], ref.shape[1], -1).amax(-1) > scale
    assert float(bad.float().mean()) < FLIP_FRAC, (what, float(bad.float().mean()))


@pytest.mark.parametrize("n", [4, 8])
def test_tile_parallel_render_matches_full_frame(scene, cams, n):
    """H = 88 over n entries: 6 tile rows, strips of 2 or 1 rows, padded
    strips at the bottom; seam-crossing splats; surf_normal recomputed from
    the assembled depth; the distortion map through the aux path."""
    eye, kw = orbit(0.5, H=88)
    cam = lookat_camera(eye, [0, 0, 0], [0, -1, 0], device="cpu", **kw)
    keys = ("render", "rend_alpha", "surf_depth", "surf_normal", "surf_normal_cam",
            "rend_dist")
    with torch.no_grad():
        out = M.tile_parallel_render(cpu_mesh(n), scene, cam, backend="cuda", keys=keys)
        ref = render(cam, scene, backend="cuda")
    assert list(out) == list(keys)
    for k in keys:
        assert out[k].shape == ref[k].shape, k
        map_gate(out[k], ref[k], k)
    assert float(ref["rend_dist"].abs().max()) > 0


def test_render_gaussian_sharded_matches_render(scene, cams):
    """4 depth slabs: every map but the median within 1e-5·max where the
    single render composited every splat (final_T ≥ 1e-2: no early stop at
    T < 1e-4, C26); the median differs only where T crosses 0.5 inside a
    slab d > 0 (the crossing slab resolves it against its local T)."""
    cam = camera_at(cams, 3)
    bg = torch.tensor([0.2, 0.1, 0.3])
    slabs = G.partition_by_view_depth(scene, cam, 4)
    with torch.no_grad():
        out = G.render_gaussian_sharded(cpu_mesh(1, 4), slabs, cam, backend="cuda", bg=bg)
        ref = render(cam, scene, config=RenderConfig(bg=tuple(bg.tolist())), backend="cuda")
    full = ref["final_T"] >= 1e-2
    assert float(full.float().mean()) > 0.9
    # The distortion composes from expanded moment products that cancel at
    # the scale of the second moment, so it is held at that scale.
    keys = ("render", "rend_alpha", "rend_normal", "rend_depth", "rend_dist", "final_T")
    scale = {k: float(ref[k].abs().max()) for k in keys}
    scale["rend_dist"] = float(ref["dist_m2"].abs().max())
    for k in keys:
        err = (out[k] - ref[k]).abs().reshape(H_, W_, -1).amax(-1)[full]
        assert float(err.max()) <= 1e-5 * scale[k], k
    with torch.no_grad():
        maps, _ = G.render_slabs(cpu_mesh(1, 4), lambda d: slabs[d], cam,
                                 RenderConfig(bg=(0.0, 0.0, 0.0)), "cuda")
    T_d = maps[..., 10]
    P_d = torch.cat([torch.ones_like(T_d[:1]), torch.cumprod(T_d, 0)[:-1]])
    deep = ((P_d > 0.5) & (torch.cumprod(T_d, 0) <= 0.5))[1:].any(0)
    off = (out["depth_median"] - ref["depth_median"]).abs() > 1e-4
    assert bool(off.any()) and not bool((off & ~deep).any())
    assert float(off.float().mean()) <= float(deep.float().mean())
    with pytest.raises(ValueError, match="model axis"):
        G.render_gaussian_sharded(cpu_mesh(1, 2), slabs, cam, backend="cuda")


@pytest.mark.parametrize("n", [2, 3])
def test_see3d_pipeline_on_mesh(tiny_unet, n, monkeypatch):
    """The denoise split over n entries (2F = 6 frames) against the unsharded
    pipeline, same explicit noise; a mesh that does not divide 2F runs the
    call unsharded."""
    _, _, port = tiny_unet
    rng = np.random.RandomState(11)
    lat = torch.from_numpy(rng.randn(3, 4, 8, 8).astype(np.float32))
    masks = torch.zeros(3, 1, 8, 8)
    masks[..., :4] = 1.0
    ctx = torch.from_numpy(rng.randn(3, 4, 16).astype(np.float32))
    one = TS.See3DPipeline(port, TS.DDIMConfig(num_steps=2))
    noise = one.draw_noise(lat.shape, "cpu", torch.Generator().manual_seed(1))
    ref = one.inpaint_latents(lat, masks, ctx, gt_num=1, noise=noise)
    calls = []
    sharded = TS.See3DPipeline(port, TS.DDIMConfig(num_steps=2), mesh=cpu_mesh(n))
    monkeypatch.setattr(TS, "run_spmd",
                        lambda devs, fn: calls.append(len(devs)) or M.run_spmd(devs, fn))
    got = sharded.inpaint_latents(lat, masks, ctx, gt_num=1, noise=noise)
    TS.See3DPipeline(port, TS.DDIMConfig(num_steps=2), mesh=cpu_mesh(4)).inpaint_latents(
        lat, masks, ctx, gt_num=1, noise=noise)
    # One sharded UNet call per DDIM timestep; the 4-entry mesh makes none.
    assert calls == [n] * len(sharded.sampler.timesteps)
    assert rel_err(got.numpy(), ref.numpy()) <= 1e-4


def test_prior_batches_on_mesh():
    """DA2's infer_images, SAM's encode_images and generator batch, MASt3R's
    symmetric_inference_batch: with a mesh (3 entries, so the last slab is
    padded) against without one."""
    from g4splat_torch.priors.depth_anything import DepthAnything
    from g4splat_torch.priors.mast3r import TINY_CONFIG, MASt3RModel
    from g4splat_torch.priors.sam import TINY_SAM, SAMPredictor, sam_mask_generator

    rng = np.random.RandomState(0)
    mesh = cpu_mesh(3)
    da2 = DepthAnything("vits", seed=0, input_size=56, device="cpu")
    imgs = torch.from_numpy(rng.rand(5, 40, 52, 3).astype(np.float32))
    a, b = da2.infer_images(imgs, max_batch=4), da2.infer_images(imgs, mesh=mesh, max_batch=4)
    assert a.shape == b.shape == (5, 40, 52) and rel_err(b.numpy(), a.numpy()) <= 1e-5

    sam = SAMPredictor(TINY_SAM, seed=0, device="cpu")
    a, b = sam.encode_images(imgs), sam.encode_images(imgs, mesh=mesh, max_batch=1)
    assert a.shape == b.shape and rel_err(b.numpy(), a.numpy()) <= 1e-5
    gen = sam_mask_generator(sam, num_prompts=8, stability_thresh=0.0)
    assert all(len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y))
               for x, y in zip(gen.batch(imgs[:2]), gen.batch(imgs[:2], mesh=cpu_mesh(2))))

    m3 = MASt3RModel(TINY_CONFIG, seed=0, device="cpu")
    i1 = torch.from_numpy(rng.rand(2, 32, 48, 3).astype(np.float32))
    i2 = torch.from_numpy(rng.rand(2, 32, 48, 3).astype(np.float32))
    a = m3.symmetric_inference_batch(i1, i2)
    b = m3.symmetric_inference_batch(i1, i2, mesh=mesh, max_batch=1)
    assert len(a) == len(b) == 2
    for pa, pb in zip(a, b):
        for da, db in zip(pa, pb):
            assert sorted(da) == sorted(db)
            for k in da:
                assert rel_err(db[k].numpy(), da[k].numpy()) <= 1e-5, k


def test_orchestrator_fans_out(scene, cams, view_refs, tmp_path, monkeypatch):
    """With available_devices patched to 4 entries of "cpu": the view sweeps
    fan out (5 views: padded to 8 and cropped) and equal per-view render();
    the prior mesh has min(4, views) entries, none on one device."""
    cfg = TO.PipelineConfig(output_path=str(tmp_path), render_backend="cuda")
    pipe = TO.G4SplatPipeline(cfg, TO.Priors(), device="cpu")
    pipe.state.scene = scene
    assert pipe._prior_mesh(5) is None
    monkeypatch.setattr(M, "available_devices", lambda dev: [torch.device("cpu")] * 4)
    launched = []
    orig = M.view_parallel_render
    monkeypatch.setattr(M, "view_parallel_render",
                        lambda mesh, *a, **kw: launched.append(mesh.shape) or orig(mesh, *a,
                                                                                    **kw))
    five = stack_cameras([camera_at(cams, i) for i in range(5)])
    keys = ("render", "rend_alpha", "surf_depth")
    maps = pipe._render_maps_batch(five, 5, keys=keys, depth_ratio=0.0)
    imgs = pipe._render_camera_batch(five, 5, str(tmp_path / "renders"))
    assert launched == [{"data": 4, "model": 1}] * 2
    assert pipe._prior_mesh(3).shape["data"] == 3 and pipe._prior_mesh(1) is None
    for k in keys:
        assert maps[k].shape[0] == 5 and all(torch.equal(maps[k][i], view_refs[i][k])
                                             for i in range(5)), k
    assert imgs.shape == (5, H_, W_, 3)
    assert all(torch.equal(imgs[i], view_refs[i]["render"]) for i in range(5))
    assert sorted(p.name for p in (tmp_path / "renders").iterdir()) == [
        f"{v:05d}.png" for v in range(5)]
