"""The port's mesh training modes on the CPU, against its single-device step
(which tests/test_torch_train.py holds to the JAX package): meshes of 2 and
4 entries of "cpu", the `cuda` backend (B1's and B2's plain versions on CPU
tensors), a 64×48 scene rendered by the port.

- Slab mode (`parallel.gaussian_shard.make_slab_sharded_train_step`, 4
  slabs) against `train_step`, same view, shifts and iteration, held to the
  JAX package's contract: at least 98 % of the parameter values after the
  step bit-equal or within 1e-6 relative, the densify statistics equal.
  Without the median in the loss (depth_ratio 0) every value is; with it,
  the rest is the median, which a slab resolves against its local T
  (ROADMAP C26 for the distortion's cross-slab terms).
- Data-parallel mode (`train.trainer.make_dp_train_step`, 2 entries)
  against the mean of the two single-view gradients, the statistics summed.
- `Trainer(mesh=…)` in both modes for 6 steps with densify and capacity
  growth inside, an exact-resume checkpoint in the middle (C24), the slab
  capacity padded to the model axis; C1 and C2 are not reproduced.
- `G4SplatPipeline.train_gaussians` trains data-parallel over the patched
  `available_devices` only when `data_parallel_training` asks for it.
"""

import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.orchestrator as TO
from g4splat_torch.core.cameras import camera_at, lookat_camera, stack_cameras
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.parallel import gaussian_shard as G
from g4splat_torch.parallel import mesh as M
from g4splat_torch.train import losses as L
from g4splat_torch.train import trainer as ttr
from g4splat_torch.train.checkpoint import load_trainer_state, read_meta, save_trainer_state
from g4splat_torch.train.densify import DensifyState

W_, H_ = 64, 48
VIEW_FIELDS = ("image", "prior_depth", "prior_normal", "prior_curv", "confidence",
               "color_weight")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (module scope: it also holds for the fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n_data, n_model=1):
    return M.make_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


def make_problem(n=300, capacity=512, n_views=4, seed=0):
    """Ground-truth splats on a thin slab rendered to the views by the port,
    and a jittered grey init."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                          rng.uniform(-0.15, 0.15, (n, 1))], 1).astype(np.float32)
    gt = GaussianScene.from_points(pts, rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
                                   scales=np.full(n, 0.07, np.float32), initial_opacity=0.85,
                                   device="cpu")
    cams = stack_cameras([
        lookat_camera([3.0 * np.sin(a), 0.2, -3.0 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                      fx=60.0, fy=60.0, width=W_, height=H_, device="cpu")
        for a in (np.arange(n_views) - 1) * 0.35])
    with torch.no_grad():
        outs = [render(camera_at(cams, i), gt, backend="cuda") for i in range(n_views)]
    views = ttr.ViewData(
        image=torch.stack([o["render"] for o in outs]),
        prior_depth=torch.stack([o["surf_depth"] for o in outs]),
        prior_normal=torch.stack([o["rend_normal"] for o in outs]),
        prior_curv=torch.from_numpy(rng.rand(n_views, H_, W_).astype(np.float32) * 0.1),
        confidence=torch.ones(n_views, H_, W_), color_weight=torch.ones(n_views),
        scale_factor=torch.tensor(10.0))
    init = GaussianScene.from_points(
        pts + 0.03 * rng.randn(*pts.shape).astype(np.float32), np.full((n, 3), 0.5, np.float32),
        capacity=capacity, scales=(0.07 * np.exp(rng.uniform(-0.3, 0.3, n))).astype(np.float32),
        quats=rng.randn(n, 4).astype(np.float32), initial_opacity=0.5, device="cpu")
    return init, cams, views


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def view_at(views, v):
    d = {k: getattr(views, k)[v] for k in VIEW_FIELDS}
    d["scale_factor"] = views.scale_factor
    return d


def leaves(scene, cfg):
    params = {k: getattr(scene, k).clone().requires_grad_(True) for k in ttr.PARAM_FIELDS}
    return scene.replace(**params), ttr.make_optimizer(cfg, params), params


def tight_share(a, b):
    d = (a - b).abs()
    return (d == 0) | (d <= 1e-6 * b.abs())


@pytest.mark.parametrize("lambda_dist,depth_ratio", [(0.0, 0.0), (10.0, 0.0), (10.0, 0.5)])
def test_slab_step_matches_train_step(problem, lambda_dist, depth_ratio):
    init, cams, views = problem
    cfg = ttr.TrainConfig(use_mip_filter=False, normal_consistency_from=0,
                          lambda_dist=lambda_dist, distortion_from=0, depth_ratio=depth_ratio)
    it, v = 600, 1
    shifts = L.draw_depth_order_shifts((H_, W_), torch.Generator().manual_seed(3))
    s1, o1, p1 = leaves(init, cfg)
    d1, m1 = ttr.train_step(s1, o1, DensifyState.zero(init.capacity), camera_at(cams, v),
                            view_at(views, v), it, cfg, shifts=shifts)
    s2, o2, p2 = leaves(init, cfg)
    perms = G.view_depth_permutations(s2, cams)
    step = G.make_slab_sharded_train_step(cpu_mesh(1, 4))
    d2, m2 = step(s2, o2, DensifyState.zero(init.capacity), camera_at(cams, v),
                  view_at(views, v), it, cfg, perms[v], torch.argsort(perms[v]), shifts=shifts)
    assert set(m2) == set(m1) and int(m2["n_overflow"]) == 0          # C1 not copied
    ok = torch.cat([tight_share(p2[k].detach(), p1[k].detach()).reshape(-1)
                    for k in ttr.PARAM_FIELDS])
    assert torch.equal(d2.denom, d1.denom) and torch.equal(d2.max_radii2d, d1.max_radii2d)
    if depth_ratio == 0.0:
        assert bool(ok.all())
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
        # Without the distortion every gradient is the single step's to float
        # rounding; with it, less the cross-slab pairs' term (C26).
        tol = 1e-5 if lambda_dist == 0.0 else 1e-3
        for k in ("xyz", "opacity_raw", "scaling_raw", "rotation_raw", "f_dc"):
            g1, g2 = p1[k].grad, p2[k].grad
            assert float((g2 - g1).norm() / g1.norm()) <= tol, k
        np.testing.assert_allclose(d2.grad_accum.numpy(), d1.grad_accum.numpy(),
                                   rtol=0, atol=tol * float(d1.grad_accum.max()))
    else:
        assert float(ok.float().mean()) >= 0.98, float(ok.float().mean())
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-2)


def test_dp_step_matches_single_views(problem):
    """Two entries, views 0 and 2: the gradients are the mean of the two
    single-view gradients (each view's shifts drawn in view order from one
    generator), the screen-gradient statistic and denom their sums, the
    radii their max; the mesh module's step takes the same loss."""
    init, cams, views = problem
    cfg = ttr.TrainConfig(use_mip_filter=False, normal_consistency_from=0)
    it = 600
    gen = torch.Generator().manual_seed(5)
    shifts = [L.draw_depth_order_shifts((H_, W_), gen) for _ in range(2)]
    grads, stats, losses = [], [], []
    for v, sh in zip((0, 2), shifts):
        s, o, p = leaves(init, cfg)
        d, m = ttr.train_step(s, o, DensifyState.zero(init.capacity), camera_at(cams, v),
                              view_at(views, v), it, cfg, shifts=sh)
        grads.append({k: p[k].grad for k in ttr.PARAM_FIELDS})
        stats.append(d)
        losses.append(float(m["loss"]))
    s, o, p = leaves(init, cfg)
    d, m = ttr.make_dp_train_step(cpu_mesh(2))(
        s, o, DensifyState.zero(init.capacity), cams, views, [0, 2], it, cfg,
        generator=torch.Generator().manual_seed(5))
    for k in ttr.PARAM_FIELDS:
        ref = (grads[0][k] + grads[1][k]) / 2
        assert float((p[k].grad - ref).abs().max()) <= 1e-6 * float(ref.abs().max()) + 1e-12, k
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-6)
    np.testing.assert_allclose(d.grad_accum.numpy(),
                               (stats[0].grad_accum + stats[1].grad_accum).numpy(),
                               rtol=1e-5, atol=1e-12)
    assert torch.equal(d.denom, stats[0].denom + stats[1].denom)
    assert torch.equal(d.max_radii2d, torch.maximum(stats[0].max_radii2d,
                                                    stats[1].max_radii2d))
    s, o, _ = leaves(init, cfg)
    loss = M.data_parallel_train_step(cpu_mesh(2), cfg)(
        s, o, cams, views, [0, 2], it, generator=torch.Generator().manual_seed(5))
    assert float(loss) == float(m["loss"])
    with pytest.raises(ValueError, match="divide"):
        ttr.make_dp_train_step(cpu_mesh(2))(s, o, None, cams, views, [0, 1, 2], it, cfg)


@pytest.mark.parametrize("mode", ["slab", "dp"])
def test_trainer_modes(problem, mode, tmp_path):
    """6 steps with densify at 3 and 6 and a capacity growth at 3: finite
    metrics with n_overflow in slab mode too (C1), the slab orders refreshed
    to the grown capacity (C2), the capacity padded to the model axis, views
    drawn views_per_step at a time; a checkpoint after step 4 restored into
    a fresh trainer gives the same last two steps bit for bit (C24)."""
    init, cams, views = problem
    init = init.replace(**{k: getattr(init, k)[:510] for k in G.SCENE_ROWS})
    cfg = ttr.TrainConfig(densify_from_iter=1, densification_interval=3,
                          densify_until_iter=7, densify_grad_threshold=1e-6,
                          normal_consistency_from=0, max_capacity=4000)
    mesh = cpu_mesh(1, 4) if mode == "slab" else cpu_mesh(2)
    tr = ttr.Trainer(init, cams, views, cfg, mesh=mesh)
    assert tr.slab_mode == (mode == "slab")
    assert tr.views_per_step == (1 if mode == "slab" else 2)
    if mode == "slab":
        assert tr.scene.capacity == 512 and not bool(tr.scene.alive[510:].any())
    hist = []
    for i in range(6):
        hist.append(tr.step())
        if i == 3:
            save_trainer_state(str(tmp_path / "ckpt.npz"), tr)
    assert all(np.isfinite(m["loss"]) and m["n_overflow"] == 0 for m in hist)
    assert tr.scene.capacity > 512 and hist[-1]["n_alive"] > hist[0]["n_alive"]
    if mode == "slab":
        assert tr.scene.capacity % 4 == 0
        assert tr._perms.shape == (4, tr.scene.capacity)
        np.testing.assert_array_equal(tr._perms.numpy(),
                                      G.view_depth_permutations(tr.scene, cams).numpy())
    again = ttr.Trainer(init, cams, views, cfg, mesh=mesh)
    with np.load(tmp_path / "ckpt.npz") as data:
        again._grow_capacity(read_meta(data)["capacity"])
    load_trainer_state(str(tmp_path / "ckpt.npz"), again)
    tail = [again.step() for _ in range(2)]
    assert tail == hist[4:]
    for k in ttr.PARAM_FIELDS:
        assert torch.equal(again.params[k], tr.params[k]), k


def test_pipeline_trains_data_parallel_on_request(problem, tmp_path, monkeypatch):
    """train_gaussians over 4 patched devices: a 4-entry data mesh with
    data_parallel_training, none without it."""
    _, cams, views = problem
    meshes = []

    class Spy(ttr.Trainer):
        def __init__(self, *a, mesh=None, **kw):
            meshes.append(mesh)
            super().__init__(*a, mesh=mesh, **kw)

    monkeypatch.setattr(TO, "Trainer", Spy)
    monkeypatch.setattr(M, "available_devices", lambda dev: [torch.device("cpu")] * 4)
    for dp in (True, False):
        cfg = TO.PipelineConfig(output_path=str(tmp_path / str(dp)), gaussian_capacity=1000,
                                data_parallel_training=dp, render_backend="cuda")
        pipe = TO.G4SplatPipeline(cfg, TO.Priors(), device="cpu")
        st = pipe.state
        st.cameras, st.images = cams, views.image
        st.depths, st.normals = views.prior_depth, views.prior_normal
        st.curvs, st.confidences = views.prior_curv, views.confidence
        st.color_weights, st.input_view_num = views.color_weight, 4
        pipe.train_gaussians(iterations=1)
        assert bool(torch.isfinite(st.scene.xyz).all())
    assert meshes[0].shape == {"data": 4, "model": 1} and meshes[1] is None
