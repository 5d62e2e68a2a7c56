"""Parity of the port's training path with g4splat_tpu on the CPU: every loss
(value and gradient), densify slot for slot, Adam against optax, one
train_step (loss and every gradient) against JAX's, a 5-step Trainer run,
and short training runs on the port alone.

Inputs are made with numpy from a seed; random draws (depth-order shifts,
split noise) are made once and handed to both packages. The port trains
through its `cuda` backend, which on CPU tensors runs the B1/B2 plain
versions inside the same autograd Function; JAX trains through `tiled`, in
depth-rank binning so that both sort entries on exact depth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from g4splat_torch.convert import camera_from, scene_from, train_config_from, views_from
from g4splat_torch.train import densify as tdens
from g4splat_torch.train import losses as tL
from g4splat_torch.train import trainer as ttr
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.ops.rasterize import render as jrender
from g4splat_tpu.train import densify as jdens
from g4splat_tpu.train import losses as jL
from g4splat_tpu.train import trainer as jtr

H, W = 24, 20


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(a, b):
    a, b = np_(a), np_(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def unit(rng, *shape):
    n = rng.randn(*shape, 3)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def rand(rng, *shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def weighted(fn, seed):
    """A map-valued function folded to a scalar with fixed random weights."""
    def f(m, *a):
        out = fn(m, *a)
        w = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
        return (out * (torch.from_numpy(w) if m is tL else jnp.asarray(w))).sum()
    return f


# name: (function of (module, *inputs), inputs from a RandomState)
LOSSES = {
    "l1": (lambda m, a, b: m.l1_loss(a, b), lambda r: (rand(r, H, W, 3), rand(r, H, W, 3))),
    "ssim": (lambda m, a, b: m.ssim(a, b), lambda r: (rand(r, H, W, 3), rand(r, H, W, 3))),
    "ssim_gray": (lambda m, a, b: m.ssim(a, b), lambda r: (rand(r, H, W), rand(r, H, W))),
    "dssim_color": (lambda m, a, b: m.dssim_color_loss(a, b, 0.2),
                    lambda r: (rand(r, H, W, 3), rand(r, H, W, 3))),
    "normal_consistency": (lambda m, a, b: m.normal_consistency_loss(a, b),
                           lambda r: (unit(r, H, W), unit(r, H, W))),
    "distortion": (lambda m, a: m.distortion_loss(a), lambda r: (rand(r, H, W),)),
    "normal_to_curvature": (weighted(lambda m, n: m.normal_to_curvature(n), 1),
                            lambda r: (unit(r, H, W),)),
    "normal_to_curvature_mask": (
        weighted(lambda m, n, k: m.normal_to_curvature(n, k), 2),
        lambda r: (unit(r, H, W), (r.rand(H, W) > 0.3).astype(np.float32))),
    "depth_prior": (lambda m, a, b: m.depth_prior_loss(a, b, 10.0, 0.5),
                    lambda r: (rand(r, H, W, lo=1, hi=3), rand(r, H, W, lo=1, hi=3))),
    "depth_derivative_prior": (lambda m, a, b: m.depth_derivative_prior_loss(a, b),
                               lambda r: (unit(r, H, W), unit(r, H, W))),
    "normal_prior": (lambda m, a, b: m.normal_prior_loss(a, b),
                     lambda r: (unit(r, H, W), unit(r, H, W))),
    "curvature_prior": (lambda m, a, b: m.curvature_prior_loss(a, b),
                        lambda r: (unit(r, H, W), rand(r, H, W))),
    "anisotropy": (lambda m, s, a: m.anisotropy_loss(s, a, 5.0),
                   lambda r: (np.exp(r.uniform(-4, 0, (50, 2))).astype(np.float32),
                              (r.rand(50) > 0.2).astype(np.float32))),
    "psnr": (lambda m, a, b: m.psnr(a, b), lambda r: (rand(r, H, W, 3), rand(r, H, W, 3))),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_gradients(name):
    fn, make = LOSSES[name]
    inputs = make(np.random.RandomState(sorted(LOSSES).index(name)))
    targs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    tval = fn(tL, *targs)
    tval.backward()
    jval, jgrads = jax.value_and_grad(lambda *a: fn(jL, *a), argnums=tuple(
        range(len(inputs))))(*map(jnp.asarray, inputs))
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5, atol=1e-6)
    for t, g in zip(targs, jgrads):
        assert rel(t.grad, g) <= 1e-4, rel(t.grad, g)


@pytest.mark.parametrize("sample", ["per_pixel", "global"])
@pytest.mark.parametrize("inverted", [False, True])
def test_depth_order_loss_same_shifts(sample, inverted):
    rng = np.random.RandomState(3)
    d = rand(rng, H, W, lo=1, hi=2)
    prior = -d + 0.3 * rand(rng, H, W) if inverted else d * 2.0
    key = jax.random.PRNGKey(4)
    s = tL.depth_order_max_shift((H, W))
    if sample == "per_pixel":      # the draw inside jL.depth_order_loss
        shifts = jax.random.randint(key, (H, W, 2), -s, s + 1)
    else:
        shifts = jnp.stack([jax.random.randint(k, (2,), -s, s + 1)
                            for k in jax.random.split(key, 4)])
    jval, jg = jax.value_and_grad(
        lambda x: jL.depth_order_loss(key, x, jnp.asarray(prior), sample=sample))(
        jnp.asarray(d))
    td = torch.from_numpy(d).requires_grad_(True)
    tval = tL.depth_order_loss(td, torch.from_numpy(prior),
                               shifts=torch.from_numpy(np.array(shifts)), sample=sample)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5, atol=1e-7)
    assert (float(tval) > 0.01) == inverted      # consistent order: zero loss
    np.testing.assert_allclose(np_(td.grad), np.asarray(jg), rtol=1e-4, atol=1e-7)


def test_depth_order_generator_draws():
    g = torch.Generator().manual_seed(0)
    a = tL.draw_depth_order_shifts((H, W), g)
    b = tL.draw_depth_order_shifts((H, W), torch.Generator().manual_seed(0))
    s = tL.depth_order_max_shift((H, W))
    assert a.shape == (H, W, 2) and torch.equal(a, b)
    assert int(a.min()) >= -s and int(a.max()) <= s and int(a.max()) == s
    d = torch.rand(H, W)
    v = tL.depth_order_loss(d, -d, generator=torch.Generator().manual_seed(1),
                            sample="global")
    assert float(v) > 0.0


def test_schedules():
    for it in (0, 999, 1000, 1500, 1501, 3001, 4501, 6001, 100000):
        assert tL.schedule_regularization_factor(it) == pytest.approx(
            float(jL.schedule_regularization_factor(it)), rel=1e-6)
        assert tL.schedule_depth_order_lambda(it) == pytest.approx(
            float(jL.schedule_depth_order_lambda(it)), rel=1e-6)
    for cfg in (dict(), dict(position_lr_delay_steps=100), dict(position_lr_max_steps=7)):
        ts, js = ttr.xyz_lr_schedule(ttr.TrainConfig(**cfg)), jtr.xyz_lr_schedule(
            jtr.TrainConfig(**cfg))
        for step in (0, 1, 5, 50, 200, 40_000):
            assert ts(step) == pytest.approx(float(js(step)), rel=1e-5)


# ---------------------------------------------------------------- densify

def densify_scene(n=20, capacity=64):
    """TestDensify's scene (tests/test_train.py), in both packages."""
    pts = np.random.RandomState(0).randn(n, 3).astype(np.float32)
    cols = np.random.RandomState(1).rand(n, 3).astype(np.float32)
    rot = np.random.RandomState(2).randn(n, 4).astype(np.float32)
    js = JScene.from_points(pts, cols, capacity=capacity, quats=rot,
                            scales=np.full(n, 0.05, np.float32))
    return js


DENSIFY_CASES = {
    # name: (scene edit, grads on slots, radii, kwargs)
    "clone": (None, slice(0, 20), 5.0, dict(scene_extent=100.0)),
    "split": (None, slice(0, 20), 5.0, dict(scene_extent=0.001)),
    "mixed": ("mixed", slice(0, 14), 5.0, dict(scene_extent=5.0)),
    "prune_low_opacity": ("low_opacity", None, 0.0, dict(scene_extent=1.0)),
    "prune_nonfinite": ("nonfinite", None, 0.0, dict(scene_extent=1.0)),
    "prune_screen_size": (None, slice(0, 5), 30.0,
                          dict(scene_extent=1.0, max_screen_size=20.0)),
    "capacity_overflow": ("small", slice(0, 20), 1.0, dict(scene_extent=100.0)),
}


def edit_scene(js, how):
    if how == "mixed":        # some large splats, some faint ones
        s = js.scaling_raw.at[:7].add(3.0)
        return js.replace(scaling_raw=s, opacity_raw=js.opacity_raw.at[15:18].set(-8.0))
    if how == "low_opacity":
        return js.replace(opacity_raw=js.opacity_raw.at[:10].set(-10.0))
    if how == "nonfinite":
        return js.replace(xyz=js.xyz.at[:4].set(jnp.nan),
                          scaling_raw=js.scaling_raw.at[4:7].set(jnp.nan),
                          opacity_raw=js.opacity_raw.at[7:10, 0].set(jnp.nan))
    return js


@pytest.mark.parametrize("case", list(DENSIFY_CASES))
def test_densify_slot_for_slot(case):
    how, hot, radius, kw = DENSIFY_CASES[case]
    js = edit_scene(densify_scene(capacity=24 if how == "small" else 64), how)
    cap = js.capacity
    grad = np.zeros((cap, 2), np.float32)
    if hot is not None:
        grad[hot] = 1e-3
    radii = np.full(cap, radius, np.float32)
    jst = jdens.accumulate_stats(jdens.DensifyState.zero(cap), jnp.asarray(grad),
                                 jnp.asarray(radii), js.alive)
    ts = scene_from(js, device="cpu")
    tst = tdens.accumulate_stats(tdens.DensifyState.zero(cap), torch.from_numpy(grad),
                                 torch.from_numpy(radii), ts.alive)
    for f in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(np_(getattr(tst, f)), np.asarray(getattr(jst, f)))
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (cap, 2, 2)))   # the draw inside densify
    js2, jst2, jchanged, jrep = jdens.densify_and_prune(key, js, jst, **kw)
    ts2, tst2, tchanged, trep = tdens.densify_and_prune(ts, tst, noise=torch.from_numpy(noise),
                                                        **kw)
    for f in ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw",
              "mip_filter", "alive"):
        np.testing.assert_allclose(np_(getattr(ts2, f)), np.asarray(getattr(js2, f)),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(np_(tchanged), np.asarray(jchanged))
    assert tuple(int(x) for x in trep) == tuple(int(x) for x in jrep)
    assert not any(np_(getattr(tst2, f)).any() for f in ("grad_accum", "denom"))
    if case == "prune_nonfinite":
        assert int(trep.n_pruned) == 10
        assert np.isfinite(np_(ts2.xyz)[np_(ts2.alive)]).all()
    if case == "capacity_overflow":
        assert int(trep.n_dropped) == 16 and int(ts2.num_alive) == 24


def test_compact_and_grow():
    js = densify_scene(n=20, capacity=24)
    js = js.replace(alive=js.alive.at[::2].set(False))
    big = tdens.compact_and_grow(scene_from(js, device="cpu"), 64)
    ref = jdens.compact_and_grow(js, 64)
    for f in ("xyz", "f_dc", "opacity_raw", "scaling_raw", "rotation_raw", "alive"):
        np.testing.assert_array_equal(np_(getattr(big, f)), np.asarray(getattr(ref, f)))
    assert big.capacity == 64 and int(big.num_alive) == int(ref.num_alive)


# ------------------------------------------------------- scene maintenance

def test_scene_maintenance_ops():
    js = densify_scene(n=20, capacity=24)
    cams = [lookat_camera([2.5 * np.sin(a), 0.3, -2.5 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                          fx=30.0 + 5 * i, fy=30.0, width=40, height=32)
            for i, a in enumerate((-0.4, 0.0, 0.5))]
    jcams = stack_cameras(cams)
    ts = scene_from(js, device="cpu")
    tcams = camera_from(jcams, device="cpu")
    mt, mj = ts.compute_mip_filter(tcams), js.compute_mip_filter(jcams)
    np.testing.assert_allclose(np_(mt.mip_filter), np.asarray(mj.mip_filter), rtol=1e-5)
    assert mt.use_mip_filter and mj.use_mip_filter
    np.testing.assert_allclose(np_(ts.reset_opacity().opacity_raw),
                               np.asarray(js.reset_opacity().opacity_raw), atol=1e-5)
    assert ts.one_up_sh_degree().active_sh_degree == js.one_up_sh_degree().active_sh_degree
    full = ts.replace(active_sh_degree=3)
    assert full.one_up_sh_degree().active_sh_degree == 3
    assert int(ts.num_alive) == int(js.num_alive) == 20


# --------------------------------------------------------------- optimizer

def random_params(rng, n):
    shapes = {"xyz": (n, 3), "f_dc": (n, 1, 3), "f_rest": (n, 15, 3),
              "opacity_raw": (n, 1), "scaling_raw": (n, 2), "rotation_raw": (n, 4)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def test_adam_matches_optax():
    """Three steps of every group (the xyz lr follows the schedule's count),
    moments zeroed on some slots before the third, as densify does."""
    cfg = dict(position_lr_max_steps=5, position_lr_delay_steps=3)
    rng = np.random.RandomState(0)
    p0 = random_params(rng, 12)
    grads = [random_params(rng, 12) for _ in range(3)]
    for g in grads:
        g["opacity_raw"][:3] = 0.0          # dead slots: exactly zero gradient
    changed = np.zeros(12, bool)
    changed[[2, 5, 7]] = True

    jcfg = jtr.TrainConfig(**cfg)
    opt = jtr.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tcfg = ttr.TrainConfig(**cfg)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    topt = ttr.make_optimizer(tcfg, tp)
    for i, g in enumerate(grads):
        if i == 2:
            state = jtr.zero_moments_at(state, jnp.asarray(changed))
            ttr.zero_moments_at(topt, torch.from_numpy(changed))
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        ttr.adam_step(topt, tcfg)
    for k in p0:
        # Both take m̂/(√v̂ + eps) in fp32, rounded in another order: within
        # 1e-5 of the update (lr ≤ 0.05 per step).
        np.testing.assert_allclose(np_(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=2e-6,
                                   err_msg=k)
        assert not np.allclose(np_(tp[k]), p0[k])


# ------------------------------------------------------------ train step

def synthetic_problem(n_views=3, res=32, n_gauss=40, capacity=64, seed=0):
    """tests/test_train.py's synthetic problem, drawn with numpy: ground-truth
    splats rendered to images by the JAX package, and a perturbed init
    (jittered points, grey colours) in both packages."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n_gauss, 2)),
                          rng.uniform(-0.15, 0.15, (n_gauss, 1))], 1).astype(np.float32)
    gt = JScene.from_points(pts, rng.uniform(0.2, 1.0, (n_gauss, 3)).astype(np.float32),
                            scales=np.full(n_gauss, 0.15, np.float32), initial_opacity=0.85)
    cams = stack_cameras([
        lookat_camera([3.0 * np.sin(a), 0.2, -3.0 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                      fx=1.0 * res, fy=1.0 * res, width=res, height=res)
        for a in (np.arange(n_views) - 1) * 0.35])
    outs = [jrender(jax.tree.map(lambda x: x[i], cams), gt, backend="tiled")
            for i in range(n_views)]
    views = jtr.ViewData(
        image=jnp.stack([o["render"] for o in outs]),
        prior_depth=jnp.stack([o["surf_depth"] for o in outs]),
        prior_normal=jnp.stack([o["rend_normal"] for o in outs]),
        prior_curv=jnp.asarray(rng.rand(n_views, res, res).astype(np.float32) * 0.1),
        confidence=jnp.ones((n_views, res, res)),
        color_weight=jnp.ones(n_views),
        scale_factor=jnp.asarray(10.0))
    init = JScene.from_points(pts + 0.03 * rng.randn(*pts.shape).astype(np.float32),
                              np.full((n_gauss, 3), 0.5, np.float32), capacity=capacity,
                              scales=(0.15 * np.exp(rng.uniform(-0.3, 0.3, n_gauss)))
                              .astype(np.float32),
                              quats=rng.randn(n_gauss, 4).astype(np.float32),
                              initial_opacity=0.5)
    init = init.replace(f_rest=jnp.asarray(0.02 * rng.randn(capacity, 15, 3)
                                           .astype(np.float32)), active_sh_degree=1)
    return init, cams, views


def jax_config(capacity, **kw):
    """JAX `tiled` in depth-rank binning with an entry buffer that drops
    nothing: exact depth order, as the port bins."""
    return jtr.TrainConfig(backend="tiled", depth_rank_binning=True,
                           raster_compact_width=0, raster_buf_size=capacity * 16,
                           raster_buf_auto=False, **kw)


@pytest.fixture(scope="module")
def problem():
    return synthetic_problem()


@pytest.mark.parametrize("lambda_dist", [0.0, 0.1])
def test_train_step_matches_jax(problem, lambda_dist):
    """One train_step at iteration 1600 (every loss term on: depth order,
    normal consistency, distortion when λ_dist > 0): the loss, every
    parameter's gradient, the densify statistic, and the Adam update."""
    init, cams, views = problem
    it = 1600
    jcfg = jax_config(init.capacity, lambda_dist=lambda_dist, normal_consistency_from=0,
                      distortion_from=0, use_mip_filter=False)
    tcfg = train_config_from(jcfg).replace(backend="cuda")
    cam = jax.tree.map(lambda x: x[1], cams)
    view = {k: getattr(views, k)[1] for k in jtr.ViewData._fields if k != "scale_factor"}
    view["scale_factor"] = views.scale_factor
    key = jax.random.PRNGKey(3)
    s = tL.depth_order_max_shift(view["image"].shape[:2])
    shifts = jax.random.randint(key, view["image"].shape[:2] + (2,), -s, s + 1)

    def loss_fn(params, offset):
        return jtr.compute_losses(init.replace(**params), cam, view, jcfg, jnp.asarray(it),
                                  key, offset)

    (jloss, _), (jgp, jgo) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        jtr.scene_params(init), jnp.zeros((init.capacity, 2)))
    optimizer = jtr.make_optimizer(jcfg)
    donated = jax.tree.map(jnp.copy, init)       # train_step donates its scene
    jscene, _, jdstate, jm = jtr.train_step(
        donated, optimizer.init(jtr.scene_params(donated)),
        jdens.DensifyState.zero(init.capacity), cam, view, jnp.asarray(it), key, jcfg,
        optimizer)

    ts = scene_from(init, device="cpu")
    params = {k: getattr(ts, k).clone().requires_grad_(True) for k in ttr.PARAM_FIELDS}
    topt = ttr.make_optimizer(tcfg, params)
    tview = {k: torch.from_numpy(np.array(v)) for k, v in view.items()}
    dstate, tm = ttr.train_step(ts.replace(**params), topt,
                                tdens.DensifyState.zero(init.capacity),
                                camera_from(cam, device="cpu"), tview, it, tcfg,
                                shifts=torch.from_numpy(np.array(shifts)))
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]), rtol=1e-5)
    tol = 1e-2 if lambda_dist else 5e-3
    for k in ttr.PARAM_FIELDS:
        assert np.abs(np.asarray(jgp[k])).max() > 0, k
        assert rel(params[k].grad, jgp[k]) <= tol, (k, rel(params[k].grad, jgp[k]))
    assert rel(dstate.grad_accum, jdstate.grad_accum) <= tol
    np.testing.assert_array_equal(np_(dstate.denom), np.asarray(jdstate.denom))
    # Adam's first step moves each value by ≈ lr·sign(g): equal wherever the
    # gradient is clearly nonzero, and never more than 2·lr apart.
    lrs = {g["name"]: g["lr"] for g in topt.param_groups}
    for k in ttr.PARAM_FIELDS:
        g = np.abs(np.asarray(jgp[k]))
        d = np.abs(np_(params[k]) - np.asarray(getattr(jscene, k)))
        assert d.max() <= 2 * lrs[k] + 1e-6, k
        big = g > 1e-2 * g.max()
        assert d[big].max() <= 1e-3 * lrs[k] + 1e-6, k


@pytest.mark.parametrize("use_mip_filter", [False, True])
def test_trainer_five_steps_match_jax(problem, use_mip_filter):
    """Five Trainer steps, densify off, same view order (numpy permutation):
    the losses agree to 1e-4 relative (Adam's early steps move each value by
    ≈ lr·sign(g), so gradients that differ in sign where they are tiny leave
    differences of that order)."""
    init, cams, views = problem
    jcfg = jax_config(init.capacity, densify_from_iter=10_000, normal_consistency_from=0,
                      use_mip_filter=use_mip_filter, sh_increase_interval=3)
    jt = jtr.Trainer(jax.tree.map(jnp.copy, init), cams, views, jcfg, seed=0)
    tt = ttr.Trainer(scene_from(init, device="cpu"), camera_from(cams, device="cpu"),
                     views_from(views, device="cpu"),
                     train_config_from(jcfg).replace(backend="cuda"), seed=0)
    if use_mip_filter:
        np.testing.assert_allclose(np_(tt.scene.mip_filter),
                                   np.asarray(jt.scene.mip_filter), rtol=1e-5)
    for _ in range(5):
        mj, mt = jt.step(), tt.step()
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-4)
        np.testing.assert_allclose(mt["psnr"], mj["psnr"], rtol=1e-4)
        assert mt["n_alive"] == mj["n_alive"] and mt["n_overflow"] == 0
    assert tt.scene.active_sh_degree == jt.scene.active_sh_degree == 2


def test_config_and_views_carry_across(problem):
    _, _, views = problem
    jcfg = jtr.TrainConfig(lambda_dist=0.3, densify_from_iter=7, backend="tiled")
    tcfg = train_config_from(jcfg)
    for f in dataclasses.fields(ttr.TrainConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert ttr.TrainConfig().backend == "cuda"
    tv = views_from(views, device="cpu")
    for k in jtr.ViewData._fields:
        np.testing.assert_array_equal(np_(getattr(tv, k)), np.asarray(getattr(views, k)))


def port_problem(**kw):
    init, cams, views = synthetic_problem(**kw)
    return (scene_from(init, device="cpu"), camera_from(cams, device="cpu"),
            views_from(views, device="cpu"))


def test_short_training_improves_psnr():
    """Counterpart of test_short_training_improves_psnr (tests/test_train.py)
    on the port's cuda backend (its plain versions on CPU tensors)."""
    scene, cams, views = port_problem(res=32, n_gauss=40, capacity=96)
    cfg = ttr.TrainConfig(densify_from_iter=10, densify_until_iter=30,
                          densification_interval=10, opacity_reset_interval=10_000,
                          use_depth_order=False, sh_increase_interval=10_000)
    trainer = ttr.Trainer(scene, cams, views, cfg)
    hist = [trainer.step() for _ in range(30)]
    assert all(np.isfinite(m["loss"]) for m in hist)
    first = np.mean([m["psnr"] for m in hist[:3]])
    last = np.mean([m["psnr"] for m in hist[-3:]])
    assert last > first + 1.0, (first, last)
    assert np.mean([m["loss"] for m in hist[-3:]]) < np.mean([m["loss"] for m in hist[:3]])


def test_trainer_densify_and_grow_capacity():
    """Densify on the port's Trainer adds splats, and an overflowing buffer
    grows, carrying Adam moments slot for slot (tests/test_train.py's
    densify and capacity-growth runs)."""
    scene, cams, views = port_problem(n_views=2, res=24, n_gauss=30, capacity=34)
    scene = scene.replace(scaling_raw=torch.full_like(scene.scaling_raw, float(np.log(0.008))))
    cfg = ttr.TrainConfig(densify_from_iter=0, densify_until_iter=100,
                          densification_interval=2, opacity_reset_interval=10_000,
                          densify_grad_threshold=1e-9, use_mip_filter=True,
                          use_depth_order=False, sh_increase_interval=10_000,
                          max_capacity=1000)
    trainer = ttr.Trainer(scene, cams, views, cfg)
    trainer.step()
    moments = {g["name"]: trainer.optimizer.state[g["params"][0]]["exp_avg"].clone()
               for g in trainer.optimizer.param_groups}
    alive = np_(trainer.scene.alive).copy()
    m = trainer.step()                       # densify at 2: overflows 34
    assert trainer.scene.capacity == 1000      # min(max_capacity, 34 + 4096)
    assert int(trainer.scene.num_alive) > 30
    assert np.isfinite(m["loss"])
    for g in trainer.optimizer.param_groups:
        st = trainer.optimizer.state[g["params"][0]]
        assert int(st["step"]) == 2 and g["updates"] == 2
        assert st["exp_avg"].shape[0] == trainer.scene.capacity
    # Slots that survived the densify keep their moments, packed to the front.
    assert bool(trainer.optimizer.state[trainer.params["xyz"]]["exp_avg"].abs().sum() > 0)
    for _ in range(2):
        m = trainer.step()
    assert np.isfinite(m["loss"]) and m["n_alive"] > 30
    assert not np.allclose(alive, 0) and set(moments) == set(ttr.PARAM_FIELDS)


def test_train_step_runs_without_tf32(monkeypatch):
    """train_step's losses (the SSIM convolutions) run with TF32 off whatever
    the caller set, and the caller's flags come back after the step."""
    scene, cams, views = port_problem(n_views=1, res=16, n_gauss=10, capacity=16)
    trainer = ttr.Trainer(scene, cams, views, ttr.TrainConfig(use_depth_order=False))
    seen = []
    ssim = ttr.L.ssim

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return ssim(*a, **kw)

    monkeypatch.setattr(ttr.L, "ssim", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert np.isfinite(trainer.step()["loss"])
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
