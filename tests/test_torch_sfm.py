"""The port's MASt3R-SfM against the JAX package's, on numpy inputs.

Primitives (focal estimate, Umeyama, the spanning and kinematic trees,
canonical depths in both modes, depth cleaning, the pair pose, posed-mode
rectification, the calibrated alignment) agree within 1e-5 or exactly.
`sparse_global_alignment` runs test_sfm.py's synthetic problem (its
correspondences with 0.3 px of noise, its smoothly warped depths) at
niter1 = niter2 = 30 in both packages:
- posed (GT poses, `fix_poses`, intrinsics frozen, shared): w2c within 1e-5,
  focals equal, depths within DEPTH_TOL of max|depth|, loss samples within
  LOSS_TOL;
- unposed (the tree's Umeyama init): the poses relative to view 0 within
  1e-4, focals within 1e-4 relative, depths within DEPTH_TOL. The absolute
  poses are compared up to that gauge: a global rigid motion leaves the
  loss unchanged, its gradient is rounding noise, and Adam (which divides a
  gradient by its own size) turns the noise into steps of the learning rate
  in either direction.
The exactly consistent problem (no noise) is not used: at its optimum every
gradient is rounding noise, and JAX's `jnp.linalg.norm` has a NaN gradient
at a zero residual (ROADMAP C15).
The Adam update and its schedules are held against optax's at the
boundaries and the last step, and the retrieval scene graph against the JAX
package's (above and below its exhaustive threshold).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import g4splat_torch.pipeline.sfm as TS
import g4splat_tpu.pipeline.sfm as JS
from g4splat_torch.convert import camera_from
from g4splat_tpu.core.cameras import make_camera, stack_cameras
from test_sfm import make_sfm_problem

DEPTH_TOL = 2e-4
LOSS_TOL = 1e-4

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and small tensor ops on eight contended threads each run slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def rng_outputs(V, H=16, W=24, seed=0):
    """Random MASt3R-like outputs for every pair of V views."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, j in JS.build_pairs_exhaustive(V):
        four = []
        for _ in range(4):
            pts = np.concatenate([rng.normal(size=(1, H, W, 2)),
                                  rng.uniform(1, 3, (1, H, W, 1))], -1).astype(np.float32)
            four.append({"pts3d": pts, "conf": rng.uniform(1, 5, (1, H, W)).astype(np.float32)})
        out[(i, j)] = tuple(four)
    return out


def torch_outputs(out):
    return {k: tuple({n: torch.from_numpy(a) for n, a in d.items()} for d in v)
            for k, v in out.items()}


def test_focal_umeyama_trees():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(16, 24, 2)), rng.uniform(1, 3, (16, 24, 1))], -1)
    assert TS.estimate_focal_from_pointmap(pts) == JS.estimate_focal_from_pointmap(pts)
    src = rng.normal(size=(40, 3))
    dst = 1.3 * src @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.2
    for a, b in zip(TS.umeyama(src, dst), JS.umeyama(src, dst)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for n, seed in ((5, 1), (9, 2), (16, 3)):
        w = np.random.default_rng(seed).uniform(0.1, 1, (n, n))
        edges = {(i, j): float(w[i, j]) for i in range(n) for j in range(i + 1, n)}
        assert TS.build_kinematic_tree(n, edges) == JS.build_kinematic_tree(n, edges)
        assert TS.maximum_spanning_tree(n, edges) == JS.maximum_spanning_tree(n, edges)
    assert TS.build_pairs_exhaustive(5) == JS.build_pairs_exhaustive(5)


@pytest.mark.parametrize("mode", ["avg-z", "avg-angle"])
def test_canonical_views(mode):
    out = rng_outputs(4)
    j = JS.canonical_views_from_pairs(4, out, mode=mode, return_confs=True)
    t = TS.canonical_views_from_pairs(4, torch_outputs(out), mode=mode, return_confs=True)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_clean_depth_pair_pose_and_alignment():
    cams, w2c, depths, focals, pairs, _ = make_sfm_problem()
    rng = np.random.default_rng(1)
    d = depths * rng.uniform(0.9, 1.1, depths.shape).astype(np.float32)
    confs = rng.uniform(1, 3, depths.shape).astype(np.float32)
    np.testing.assert_array_equal(TS.clean_depth_confidences(w2c, focals, d, confs),
                                  JS.clean_depth_confidences(w2c, focals, d, confs))
    o = rng_outputs(2, seed=2)[(0, 1)]
    to = torch_outputs({(0, 1): o})[(0, 1)]
    np.testing.assert_allclose(TS.relative_pose_from_pair(to[0], to[2], to[3]),
                               JS.relative_pose_from_pair(o[0], o[2], o[3]), atol=1e-9)
    res = JS.SfMResult(w2c, focals, depths, [1.0])
    target = np.stack([np.linalg.inv(m)[:3, 3] for m in w2c]) * 1.5 + 0.3
    for a, b in zip(TS.align_to_calibrated_locations(TS.SfMResult(*res), target),
                    JS.align_to_calibrated_locations(res, target)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("centered", [True, False])
def test_rectify_to_center_pp(centered):
    rng = np.random.default_rng(5)
    V, H, W = 2, 24, 32
    imgs = rng.uniform(size=(V, H, W, 3)).astype(np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    cx, cy, fy = ((W - 1) / 2, (H - 1) / 2, 30.0) if centered else (17.0, 10.5, 31.0)
    jc = stack_cameras([make_camera(w2c[v], 30.0, fy, cx, cy, W, H) for v in range(V)])
    ji, jc2 = JS.rectify_to_center_pp(imgs, jc)
    ti, tc2 = TS.rectify_to_center_pp(torch.from_numpy(imgs), camera_from(jc, device="cpu"))
    np.testing.assert_allclose(ti.numpy(), ji, atol=1e-6)
    for k in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(tc2, k).numpy(), np.asarray(getattr(jc2, k)),
                                   rtol=1e-6)
    if centered:
        np.testing.assert_array_equal(ti.numpy(), imgs)


@pytest.fixture(scope="module")
def problem():
    cams, w2c, depths, focals, pairs, _ = make_sfm_problem(noise=0.3)
    V, H, W = depths.shape
    ys, xs = np.mgrid[:H, :W]
    warp = 1.0 + 0.15 * np.sin(xs / W * 4.0)[None] * np.cos(ys / H * 3.0)[None]
    return w2c, (depths * warp).astype(np.float32), focals, pairs


def run_both(problem, posed):
    w2c, depths, focals, pairs = problem
    kw = (dict(fix_poses=True, optimize_intrinsics=False, shared_intrinsics=True) if posed
          else {})
    jcfg = JS.SfMConfig(niter1=30, niter2=30, **kw)
    init = w2c if posed else None
    j = JS.sparse_global_alignment(depths, focals, pairs, jcfg, init_w2c=init)
    stats = {}
    t = TS.sparse_global_alignment(depths, focals, [TS.PairData(*p) for p in pairs],
                                   TS.SfMConfig(**dataclasses.asdict(jcfg)), init_w2c=init,
                                   device="cpu", stats=stats)
    assert stats["phase1_iters"] == stats["phase2_iters"] == 30
    assert stats["phase1_s_per_iter"] > 0 and stats["phase2_s_per_iter"] > 0
    assert len(t.losses) == len(j.losses) == 20
    np.testing.assert_allclose(t.losses, j.losses, rtol=LOSS_TOL, atol=LOSS_TOL * max(j.losses))
    assert np.abs(t.depthmaps - j.depthmaps).max() <= DEPTH_TOL * np.abs(j.depthmaps).max()
    return j, t


def test_sparse_global_alignment_posed(problem):
    j, t = run_both(problem, posed=True)
    np.testing.assert_allclose(t.w2c, j.w2c, atol=1e-5)
    np.testing.assert_allclose(t.w2c, problem[0], atol=1e-5)        # the poses stay
    np.testing.assert_array_equal(t.focals, j.focals)


def test_sparse_global_alignment_unposed(problem):
    j, t = run_both(problem, posed=False)

    def relative(w):
        return np.stack([m @ np.linalg.inv(w[0]) for m in w])

    np.testing.assert_allclose(relative(t.w2c), relative(j.w2c), atol=1e-4)
    np.testing.assert_allclose(t.focals, j.focals, rtol=1e-4)


def test_schedules_against_optax():
    for lr, n in ((0.07, 30), (0.01, 1000)):
        t, j = TS.cosine_decay(lr, n), optax.cosine_decay_schedule(lr, n)
        for c in (0, 1, n // 2, n - 1, n, n + 5):
            assert t(c) == pytest.approx(float(j(c)), rel=1e-6, abs=1e-9), (lr, n, c)
    for bounds in ((10,), (1000,), (5, 12)):
        t = TS.piecewise_constant(1e-3, bounds, 0.1)
        j = optax.piecewise_constant_schedule(1e-3, {b: 0.1 for b in bounds})
        for c in sorted({0, *(b + d for b in bounds for d in (-1, 0, 1)), 999, 1000}):
            if c >= 0:
                assert t(c) == pytest.approx(float(j(c)), rel=1e-6), (bounds, c)


@pytest.mark.parametrize("b2", [0.9, 0.999])
def test_adam_against_optax(b2):
    rng = np.random.default_rng(7)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(
        np.float32)}
    sched = optax.piecewise_constant_schedule(0.05, {3: 0.1})
    opt = optax.adam(sched, b1=0.9, b2=b2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = TS.Adam(tp, {k: TS.piecewise_constant(0.05, (3,), 0.1) for k in tp}, b1=0.9, b2=b2)
    for step in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** (step - 3)
             for k, v in p0.items()}
        if step == 2:
            g["b"][:] = 0.0                 # a zeroed group (frozen parameters)
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("V", [6, 25])
def test_retrieval_pairs(V):
    import g4splat_torch.pipeline.retrieval as TR
    import g4splat_tpu.pipeline.retrieval as JR

    rng = np.random.default_rng(V)
    base = rng.normal(size=(4, 16))
    feats = [np.abs(base[v % 4] + 0.3 * rng.normal(size=(30, 16))) for v in range(V)]
    got = TR.retrieval_pairs(feats, k=3, na=2, exhaustive_threshold=20)
    assert got == JR.retrieval_pairs(feats, k=3, na=2, exhaustive_threshold=20)
    assert (got == TS.build_pairs_exhaustive(V)) == (V <= 20)
