"""The port's chart alignment against the JAX package's, on
test_chart_alignment.py's problem (3 cameras on a tilted plane, init depths
with a smooth bump), with one param tree of the JAX `init_params`
structure in both packages (`convert.chart_params_from`; each package
draws its own init from its own generator, so the test draws the tree
with numpy and hands it to both).

The pieces agree to float rounding: the uv grid sampler, the code planes'
upsampling, the state, `forward_deformation` (also with the confidence
weighting), `view_depths`, `sample_depth_at_points` and `build_matches`.
`align_charts` runs 20 iterations with a learning-rate boundary at 10 in
both packages, from the same params. Each package's change from the shared
init (its depths, points and confidences less those of 0 iterations) agrees
with the other's within DELTA_TOL of max|JAX change|, and the loss samples
within LOSS_RTOL. One step's gradients agree to ~3e-5, but Adam divides
each gradient by its own running size, so a parameter whose gradient is
rounding noise (a confidence logit where c·|Δ| − 0.2·log c is flat) steps
by the learning rate either way: the changes agree to 2.0e-2 (depths),
1.8e-2 (points) and 9.7e-3 (confidences), the losses to 1.1e-3. A port
that drops the boundary is off by 0.53 / 0.47 / 0.88 (losses 0.14), one
that freezes the confidence group by 1.0 in the confidences, one that
freezes the MLP by 0.59 / 0.53 / 1.5, and one whose boundary comes a step
late (at 11) by 0.060 / 0.057 / 0.085 (losses 2.0e-2).
charts_data.npz crosses between the packages both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.chart_alignment as TC
import g4splat_tpu.pipeline.chart_alignment as JC
from g4splat_torch.convert import camera_from, chart_params_from
from g4splat_torch.core.cameras import camera_at
from test_chart_alignment import make_problem

TOL = 1e-5
DELTA_TOL = 4e-2
LOSS_RTOL = 5e-3

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and small tensor ops on eight contended threads each run slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def draw_params(shapes, rng, code_range):
    """A param tree of `init_params`' structure, drawn as it draws (codes
    uniform in ±code_range, per-chart MLP uniform in ±1/sqrt(fan in),
    confidence logits 0) from a numpy generator: jax.random's eager draws
    compile for ~10 s on the CPU."""
    def u(shape, b):
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {"enc": [u(g.shape, code_range) for g in shapes["enc"]],
            "denc": u(shapes["denc"].shape, code_range),
            "mlp": [{"w": u(l["w"].shape, 1 / np.sqrt(l["w"].shape[1])),
                     "b": u(l["b"].shape, 1 / np.sqrt(l["w"].shape[1]))} for l in shapes["mlp"]],
            "conf_raw": np.zeros(shapes["conf_raw"].shape, np.float32)}


@pytest.fixture(scope="module")
def prob():
    cams, dinit, dgt = make_problem(V=3)
    V, H, W = dinit.shape
    cfg = JC.ChartAlignConfig()
    shapes = jax.eval_shape(lambda: JC.init_params(jax.random.PRNGKey(0), V, H, W, cfg))
    rng = np.random.default_rng(0)
    # The init's ranges, and codes 1000 times wider (the forward tests: the
    # codes then move the deformation).
    jp, wide = draw_params(shapes, rng, cfg.init_range), draw_params(shapes, rng, 0.1)
    return dict(jc=cams, tc=camera_from(cams, device="cpu"), dinit=np.array(dinit),
                dgt=np.array(dgt), jp=jp, wide=wide)


def close(a, b, tol=TOL):
    a, b = np.asarray(a), b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b)
        return
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max())


def changes_agree(j, t, init, what):
    """Each package's change from the shared init, the port's within
    DELTA_TOL of max|JAX change|."""
    init = init.numpy()
    dj, dt = np.asarray(j) - init, np.asarray(t) - init
    assert np.abs(dj).max() > 0, what
    assert np.abs(dt - dj).max() <= DELTA_TOL * np.abs(dj).max(), what


def test_sampler_and_init_shapes(prob):
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(5, 7, 3)).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (40, 2)).astype(np.float32)
    close(JC.grid_sample_bilinear(jnp.asarray(grid), jnp.asarray(uv)),
          TC.grid_sample_bilinear(torch.from_numpy(grid), torch.from_numpy(uv)))
    ti = TC.init_params(3, 24, 32, TC.ChartAlignConfig(), torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(np.shape, prob["jp"])
    tshapes = jax.tree.map(lambda t: tuple(t.shape), ti)
    assert tshapes == jshapes
    assert float(ti["enc"][0].abs().max()) <= 1e-4 and not ti["conf_raw"].any()
    bound = 1 / np.sqrt(ti["mlp"][0]["w"].shape[1])
    assert float(ti["mlp"][0]["w"].abs().max()) <= bound


@pytest.mark.parametrize("weighted", [False, True])
def test_state_and_forward_deformation(prob, weighted):
    jcfg = JC.ChartAlignConfig(weight_encodings_with_confidence=weighted)
    tcfg = TC.ChartAlignConfig(weight_encodings_with_confidence=weighted)
    # The JAX side under jit: one compile in place of its eager ops' many.
    js = jax.jit(JC.build_state, static_argnums=(2, 3))(prob["jc"], jnp.asarray(prob["dinit"]),
                                                        1.5, jcfg)
    ts = TC.build_state(prob["tc"], torch.from_numpy(prob["dinit"]), 1.5, tcfg)
    for a, b in zip(js[:4], ts[:4]):
        close(a, b)
    assert float(js.deformation_radius) == ts.deformation_radius
    wide = dict(prob["wide"], conf_raw=np.full_like(prob["wide"]["conf_raw"], 0.3))
    jp = jax.tree.map(jnp.asarray, wide)
    tp = chart_params_from(wide, device="cpu")
    close(jax.jit(JC.sample_encodings, static_argnums=(1, 2))(jp["enc"], 24, 32),
          TC.sample_encodings(tp["enc"], 24, 32))
    jv = jax.jit(JC.forward_deformation, static_argnums=2)(jp, js, jcfg)
    tv = TC.forward_deformation(tp, ts, tcfg)
    close(jv, tv)
    close(JC.view_depths(prob["jc"], jv), TC.view_depths(prob["tc"], tv))


def test_depth_sampling_and_matches(prob):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(200, 3)).astype(np.float32) * 0.8
    jcam = jax.tree.map(lambda x: x[1], prob["jc"])
    for a, b in zip(jax.jit(JC.sample_depth_at_points)(jcam, jnp.asarray(prob["dgt"][1]),
                                                      jnp.asarray(pts)),
                    TC.sample_depth_at_points(camera_at(prob["tc"], 1),
                                              torch.from_numpy(prob["dgt"][1]),
                                              torch.from_numpy(pts))):
        close(a, b)
    jm = jax.jit(JC.build_matches, static_argnums=2)(prob["jc"], jnp.asarray(prob["dgt"]), 0.075)
    tm = TC.build_matches(prob["tc"], torch.from_numpy(prob["dgt"]), 0.075)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm[0]))
    assert 0 < int(tm[0].sum()) < tm[0].numel()
    close(jm[1], tm[1])
    close(jm[2], tm[2])


def test_align_charts_20_iterations_with_a_boundary(prob, monkeypatch, tmp_path):
    jcfg = JC.ChartAlignConfig(n_iterations=20, lr_update_iters=(10,))
    tcfg = TC.ChartAlignConfig(n_iterations=20, lr_update_iters=(10,))
    monkeypatch.setattr(JC, "init_params", lambda *a, **k: jax.tree.map(jnp.asarray,
                                                                          prob["jp"]))
    monkeypatch.setattr(TC, "init_params", lambda *a, **k: chart_params_from(prob["jp"],
                                                                              device="cpu"))
    j = JC.align_charts(prob["jc"], jnp.asarray(prob["dinit"]), jnp.asarray(prob["dgt"]),
                        extent=1.5, cfg=jcfg)
    stats = {}
    t = TC.align_charts(prob["tc"], torch.from_numpy(prob["dinit"]),
                        torch.from_numpy(prob["dgt"]), extent=1.5, cfg=tcfg, stats=stats)
    assert stats["iters"] == 20 and stats["s_per_iter"] > 0
    assert len(t.losses) == len(j.losses) == 20 and t.losses[-1] < t.losses[0]
    np.testing.assert_allclose(t.losses, j.losses, rtol=LOSS_RTOL)
    t0 = TC.align_charts(prob["tc"], torch.from_numpy(prob["dinit"]),
                         torch.from_numpy(prob["dgt"]), extent=1.5,
                         cfg=TC.ChartAlignConfig(n_iterations=0))
    for k in ("depths", "pts", "confs"):
        changes_agree(getattr(j, k), getattr(t, k), getattr(t0, k), k)
    np.testing.assert_array_equal(t.prior_depths.numpy(), prob["dinit"])
    # charts_data.npz both ways.
    TC.save_charts_data(str(tmp_path / "t.npz"), t, 2.0)
    JC.save_charts_data(str(tmp_path / "j.npz"), j, 2.0)
    a, b = JC.load_charts_data(str(tmp_path / "t.npz")), TC.load_charts_data(str(tmp_path /
                                                                                  "j.npz"))
    assert sorted(a) == sorted(b) == ["confs", "depths", "prior_depths", "pts", "scale_factor"]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    np.testing.assert_array_equal(a["depths"], t.depths.numpy())
    assert float(a["scale_factor"]) == float(b["scale_factor"]) == 2.0


def test_strong_regularisers_run(prob):
    cfg = TC.ChartAlignConfig(n_iterations=3, regularize_chart_encodings_norms=True,
                              use_total_variation_on_depth_encodings=True,
                              weight_encodings_with_confidence=True)
    t = TC.align_charts(prob["tc"], torch.from_numpy(prob["dinit"]),
                        torch.from_numpy(prob["dgt"]), extent=1.5, cfg=cfg)
    assert np.isfinite(t.losses).all() and bool(torch.isfinite(t.depths).all())
