"""`G4SplatPipeline.align_charts` on the CPU, the port's against the JAX
package's, from one SfM state: test_torch_pipeline_run.py's scene, source
tree, MASt3R params and YAML overlays (20 chart iterations with a
learning-rate boundary at 10); the port's `run_sfm` gives the cameras and
SfM depths, which both pipelines then hold (that file holds `run_sfm`
against the JAX package's). Both packages start from one param tree
(test_torch_chart_alignment.py's numpy draw in `init_params`' structure).
Each package's change from that init (the depths, points and confidences
of 0 iterations on the same arguments) agrees with the other's within
DELTA_TOL of max|JAX change|, in the state and in charts_data.npz; the
prior depths and scale factor are the same. The changes agree to 8.7e-3
(depths), 7.5e-3 (points) and 3.8e-4 (confidences); a port that freezes
the confidence group is off by 1.0. Adam turns rounding noise in
near-zero gradients into steps of the learning rate
(test_torch_chart_alignment.py, which also shows planted schedule faults
fail its bound).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.chart_alignment as TC
import g4splat_torch.pipeline.orchestrator as TO
import g4splat_tpu.pipeline.chart_alignment as JC
import g4splat_tpu.pipeline.orchestrator as JO
from g4splat_torch.convert import chart_params_from
from g4splat_tpu.core import cameras as jcam
from test_torch_chart_alignment import draw_params
from test_torch_pipeline_run import (CONFIG, RES, mast3r_pair, scene_and_cameras, source_tree,
                                     written)
from test_torch_pipeline_run import patched  # noqa: F401  (the YAML overlays, a fixture)

DELTA_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and small tensor ops on eight contended threads each run slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_align_charts_matches_jax(patched, tmp_path, monkeypatch):
    images, jc, tc = scene_and_cameras()
    src = source_tree(str(tmp_path / "in"), jc)
    tm, _ = mast3r_pair()
    tp = TO.G4SplatPipeline(TO.PipelineConfig(source_path=src, output_path=str(tmp_path / "t"),
                                              **CONFIG), TO.Priors(mast3r=tm), device="cpu")
    tp.load_inputs(images, tc)
    tp.run_sfm()
    cams = tp.state.cameras
    jp = JO.G4SplatPipeline(JO.PipelineConfig(output_path=str(tmp_path / "j"), **CONFIG),
                            JO.Priors())
    jp.load_inputs(tp.state.images.numpy(), jcam.stack_cameras([
        jcam.make_camera(*(getattr(cams, k)[v].numpy() for k in ("w2c", "fx", "fy", "cx", "cy")),
                         RES, RES) for v in range(len(images))]))
    jp.state.prior_depths = tp.state.prior_depths.numpy().copy()
    jp.state.depths = tp.state.depths.numpy().copy()
    V = len(images)
    shapes = jax.eval_shape(lambda: JC.init_params(jax.random.PRNGKey(0), V, RES, RES,
                                                   JC.ChartAlignConfig()))
    params = draw_params(shapes, np.random.default_rng(0), JC.ChartAlignConfig().init_range)
    monkeypatch.setattr(JC, "init_params", lambda *a, **k: jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr(TC, "init_params", lambda *a, **k: chart_params_from(params,
                                                                             device="cpu"))
    calls, align = [], TO.align_charts

    def spy(*a, **kw):
        calls.append((a, kw))
        return align(*a, **kw)

    monkeypatch.setattr(TO, "align_charts", spy)
    jp.align_charts()
    tp.align_charts()
    a0, kw0 = calls[0]
    assert kw0["cfg"].n_iterations == 20 and kw0["cfg"].lr_update_iters == [10]
    init = align(*a0, **dict(kw0, cfg=dataclasses.replace(kw0["cfg"], n_iterations=0)))
    js, ts = jp.state, tp.state

    def changes_agree(j, t, i, what):
        dj, dt = np.asarray(j) - i.numpy(), np.asarray(t) - i.numpy()
        assert dj.shape == dt.shape and np.abs(dj).max() > 0, what
        assert np.abs(dt - dj).max() <= DELTA_TOL * np.abs(dj).max(), what

    changes_agree(js.depths, ts.depths, init.depths, "depths")
    changes_agree(js.confidences, ts.confidences, init.confs, "confidences")
    np.testing.assert_array_equal(ts.prior_depths.numpy(), np.asarray(js.prior_depths))
    assert bool(torch.isfinite(ts.depths).all()) and bool((ts.depths > 0).all())
    a, b = (np.load(os.path.join(str(tmp_path / r), "sfm", "charts_data.npz")) for r in "jt")
    assert sorted(a.files) == sorted(b.files) == ["confs", "depths", "prior_depths", "pts",
                                                  "scale_factor"]
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    for k in ("depths", "pts", "confs"):
        changes_agree(a[k], b[k], getattr(init, k), k)
    np.testing.assert_array_equal(a["prior_depths"], b["prior_depths"])
    assert float(a["scale_factor"]) == float(b["scale_factor"])
    assert "sfm/charts_data.npz" in written(str(tmp_path / "t"))
