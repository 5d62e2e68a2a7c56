"""`g4splat_torch.train.checkpoint` and `convert.trainer_state_from_jax`
against `g4splat_tpu.train.checkpoint` on the CPU.

- Exact resume (ROADMAP C24): a port Trainer takes 5 steps, saves, and a
  fresh one loads the file and takes 3; every parameter, Adam moment and
  step, the update counts, the densify statistics and the views drawn equal
  8 uninterrupted steps bit for bit. The window holds a densify (at 6, after
  the save), an opacity reset (at 7), an SH increase (at 4 and 8) and the
  depth-order loss, whose shifts come from the torch generator.
- A capacity mismatch is refused (ValueError), as the JAX loader refuses it.
- A file that the JAX package's `save_trainer_state` wrote loads into the
  port's trainer with every parameter, moment, count, statistic and the
  iteration exact. The fast case fills the JAX trainer's state with seeded
  values (no JAX step is compiled); the `slow` case takes 2 JAX training
  steps at 24 px first (about 25 s of JAX compiling on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import train_config_from, trainer_state_from_jax
from g4splat_torch.core.cameras import camera_at, lookat_camera, stack_cameras
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.train.checkpoint import load_trainer_state, save_trainer_state
from g4splat_torch.train.trainer import PARAM_FIELDS, TrainConfig, Trainer, ViewData
from g4splat_tpu.core.cameras import make_camera as jmake
from g4splat_tpu.core.cameras import stack_cameras as jstack
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.train import checkpoint as jck
from g4splat_tpu.train import trainer as jtr

RES, N, CAP = 24, 20, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's fixtures and tests: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def problem(seed=0, n_views=3):
    """A seeded splat layer seen by 3 cameras: the targets rendered by the
    port's tiled backend, and a jittered grey init (numpy arrays)."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (N, 2)),
                          rng.uniform(-0.15, 0.15, (N, 1))], 1).astype(np.float32)
    gt = GaussianScene.from_points(pts, rng.uniform(0.2, 1.0, (N, 3)).astype(np.float32),
                                   scales=np.full(N, 0.15, np.float32), initial_opacity=0.85,
                                   device="cpu")
    cams = stack_cameras([
        lookat_camera([3.0 * np.sin(a), 0.2, -3.0 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                      fx=1.0 * RES, fy=1.0 * RES, width=RES, height=RES, device="cpu")
        for a in (np.arange(n_views) - 1) * 0.35])
    with torch.no_grad():
        outs = [render(camera_at(cams, v), gt, backend="tiled") for v in range(n_views)]
    views = ViewData(image=torch.stack([o["render"] for o in outs]),
                     prior_depth=torch.stack([o["surf_depth"] for o in outs]),
                     prior_normal=torch.stack([o["rend_normal"] for o in outs]),
                     prior_curv=torch.from_numpy(rng.rand(n_views, RES, RES).astype(np.float32)),
                     confidence=torch.ones(n_views, RES, RES),
                     color_weight=torch.ones(n_views), scale_factor=torch.tensor(10.0))
    init = dict(xyz=pts + 0.03 * rng.randn(N, 3).astype(np.float32),
                rgb=np.full((N, 3), 0.5, np.float32),
                scales=(0.15 * np.exp(rng.uniform(-0.3, 0.3, N))).astype(np.float32))
    return init, cams, views


CFG = TrainConfig(densify_from_iter=2, densify_until_iter=8, densification_interval=6,
                  opacity_reset_interval=7, sh_increase_interval=4, normal_consistency_from=0,
                  densify_grad_threshold=1e-6, use_mip_filter=True)


def port_trainer(prob, cfg=CFG, capacity=CAP):
    init, cams, views = prob
    scene = GaussianScene.from_points(init["xyz"], init["rgb"], capacity=capacity,
                                      scales=init["scales"], initial_opacity=0.5, device="cpu")
    return Trainer(scene, cams, views, cfg, seed=3)


def trainer_state(t):
    """Every tensor of the state, by name, and the bookkeeping."""
    out = {f"scene.{k}": getattr(t.scene, k).detach().clone()
           for k in (*PARAM_FIELDS, "alive", "mip_filter")}
    for g in t.optimizer.param_groups:
        st = t.optimizer.state.get(g["params"][0], {})
        out.update({f"adam.{g['name']}.{k}": v.clone() for k, v in st.items()})
    out.update({f"dstate.{k}": getattr(t.dstate, k).clone()
                for k in ("grad_accum", "denom", "max_radii2d")})
    meta = dict(iteration=t.iteration, sh=t.scene.active_sh_degree,
                mip=t.scene.use_mip_filter,
                updates=[g["updates"] for g in t.optimizer.param_groups])
    return out, meta


def assert_same(a, b):
    (ta, ma), (tb, mb) = a, b
    assert ma == mb
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def record_views(t):
    seen = []
    pick = t._next_view

    def spy():
        seen.append(pick())
        return seen[-1]
    t._next_view = spy
    return seen


def test_exact_resume_bitwise(tmp_path):
    """5 steps, save, load into a fresh trainer, 3 steps == 8 steps."""
    prob = problem()
    ref = port_trainer(prob)
    ref_views = record_views(ref)
    for _ in range(8):
        ref.step()
    assert ref.scene.active_sh_degree == 2 and ref.iteration == 8

    a = port_trainer(prob)
    a_views = record_views(a)
    for _ in range(5):
        a.step()
    path = str(tmp_path / "ckpt.npz")
    save_trainer_state(path, a)
    with np.load(path, allow_pickle=False) as data:
        assert "stack" in data.files and "generator" in data.files
    b = port_trainer(prob)
    load_trainer_state(path, b)
    assert_same(trainer_state(b), trainer_state(a))
    assert b._stack == a._stack
    assert b.rng.bit_generator.state == a.rng.bit_generator.state
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    b_views = record_views(b)
    for _ in range(3):
        b.step()
    assert a_views + b_views == ref_views
    assert_same(trainer_state(b), trainer_state(ref))


def test_capacity_mismatch_refused(tmp_path):
    prob = problem()
    a = port_trainer(prob)
    a.step()
    path = str(tmp_path / "ckpt.npz")
    save_trainer_state(path, a)
    with pytest.raises(ValueError, match="capacity"):
        load_trainer_state(path, port_trainer(prob, capacity=2 * CAP))


def jax_trainer(prob, cfg):
    init, cams, views = prob
    jinit = JScene.from_points(init["xyz"], init["rgb"], capacity=CAP, scales=init["scales"])
    jcams = jstack([jmake(*(getattr(cams, k)[v].numpy() for k in ("w2c", "fx", "fy", "cx", "cy")),
                          cams.width, cams.height) for v in range(cams.w2c.shape[0])])
    jviews = jtr.ViewData(*(jnp.asarray(v.numpy()) for v in views))
    return jtr.Trainer(jinit, jcams, jviews, cfg)


def check_loaded(t, jt):
    for k in (*PARAM_FIELDS, "alive", "mip_filter"):
        np.testing.assert_array_equal(getattr(t.scene, k).detach().numpy(),
                                      np.asarray(getattr(jt.scene, k)), err_msg=k)
    inner = jt.opt_state.inner_states
    for g in t.optimizer.param_groups:
        name = g["name"]
        adam = inner[name].inner_state[0]
        st = t.optimizer.state[g["params"][0]]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(adam.mu[name]))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(adam.nu[name]))
        assert float(st["step"]) == int(adam.count)
        want = int(inner[name].inner_state[1].count) if name == "xyz" else int(adam.count)
        assert g["updates"] == want, name
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(t.dstate, k).numpy(),
                                      np.asarray(getattr(jt.dstate, k)))
    assert t.iteration == jt.iteration
    assert t.scene.active_sh_degree == jt.scene.active_sh_degree
    assert t.scene.use_mip_filter == jt.scene.use_mip_filter
    # No view order in the JAX file (C24): the port restarts from its seed.
    assert t._stack == [] and t.rng.bit_generator.state == np.random.default_rng(
        t.seed).bit_generator.state


JAX_CFG = jtr.TrainConfig(iterations=20, densify_from_iter=10_000, opacity_reset_interval=10_000,
                          use_mip_filter=False, use_depth_order=False, backend="tiled",
                          sh_increase_interval=10_000)


def test_jax_checkpoint_seeded_state_loads_exactly(tmp_path):
    """The JAX trainer's state filled with seeded values, written by the JAX
    package's save_trainer_state, read by trainer_state_from_jax."""
    prob = problem()
    jt = jax_trainer(prob, JAX_CFG)
    rng = np.random.RandomState(5)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return jnp.asarray(rng.randint(1, 50), jnp.int32)
        return jnp.asarray(rng.randn(*x.shape).astype(x.dtype))

    jt.scene = jt.scene.replace(**{k: fill(getattr(jt.scene, k)) for k in PARAM_FIELDS},
                                mip_filter=fill(jt.scene.mip_filter), active_sh_degree=2)
    jt.opt_state = jax.tree.map(fill, jt.opt_state)
    jt.dstate = jax.tree.map(fill, jt.dstate)
    jt.iteration = 7
    path = str(tmp_path / "jax.npz")
    jck.save_trainer_state(path, jt)
    t = port_trainer(prob, train_config_from(JAX_CFG).replace(backend="cuda"))
    t.step()
    trainer_state_from_jax(path, t)
    check_loaded(t, jt)
    assert np.isfinite(t.step()["loss"]) and t.iteration == 8
    with pytest.raises(ValueError, match="capacity"):
        trainer_state_from_jax(path, port_trainer(prob, capacity=2 * CAP))


@pytest.mark.slow
def test_jax_checkpoint_after_two_steps_loads_exactly(tmp_path):
    """2 JAX training steps at 24 px, then the JAX writer and the port's reader."""
    prob = problem()
    jt = jax_trainer(prob, JAX_CFG)
    jt.step()
    jt.step()
    path = str(tmp_path / "jax.npz")
    jck.save_trainer_state(path, jt)
    t = port_trainer(prob, train_config_from(JAX_CFG).replace(backend="cuda"))
    trainer_state_from_jax(path, t)
    check_loaded(t, jt)
    assert np.isfinite(t.step()["loss"])
