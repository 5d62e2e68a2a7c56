"""`g4splat_torch.eval.synthetic.quality_run` against the JAX package's
quality gate, on the CPU.

- A tiny port `quality_run` (box_room(300), 4 views at 32×24, view 1 held
  out, 3 training steps, a 16³ multires TSDF, chart alignment cut to 20
  steps): the results carry the JAX package's keys, finite, the stages'
  timings, and the run's files. (The box room's inputs against the JAX
  package's renders: tests/test_torch_quality_inputs.py.)
- `slow`: the JAX gate's configuration (res 128, 8 views, split (2, 5), 400
  iterations, the `tiled` backend, TSDF 96³, 1200 points per m²) held to
  tests/test_quality.py's thresholds (PSNR > 12, SSIM > 0.45, Chamfer-L1 <
  12 cm). It takes over an hour on the CPU; chip_smoke phase 19 runs it on
  the card's `cuda` backend.
"""

import json
import os

import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.orchestrator as TO
from g4splat_torch.eval import synthetic as TS

# evaluate() on a held-out split with a GT mesh (the JAX package's order).
RESULT_KEYS = ["LPIPS-uncalibrated", "test_views_num", "Average-PSNR", "Average-SSIM",
               "Average-LPIPS", "Acc", "Comp", "Chamfer-L1", "Prec", "Recal", "F-score",
               "Normal-Acc", "Normal-Comp", "Normal-Consistency"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's fixtures and tests: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_quality_run(tmp_path, monkeypatch):
    load = TO.load_config

    def short_charts(group, name="default"):
        cfg = load(group, name)
        return dict(cfg, n_iterations=20) if group == "charts_alignment" else cfg

    monkeypatch.setattr(TO, "load_config", short_charts)
    out = str(tmp_path / "q")
    res = TS.quality_run(out, res=32, n_views=4, eval_split=(1,), train_iters=3,
                         tsdf_resolution=16, points_per_m2=300,
                         extra_cfg={"gaussian_capacity": 8000}, device="cpu")
    assert [k for k in res if k != "timings"] == RESULT_KEYS
    assert res["test_views_num"] == 1
    assert all(np.isfinite(v) for k, v in res.items() if k not in ("timings",
                                                                   "LPIPS-uncalibrated"))
    assert set(res["timings"]) >= {"align_charts", "render_chart_views", "excavate_planes",
                                   "refine_plane_depths", "train_gaussians", "evaluate"}
    with open(os.path.join(out, "result_iter_3.json")) as f:
        assert list(json.load(f)) == RESULT_KEYS
    assert os.path.exists(os.path.join(out, "free_gaussians", "point_cloud", "iteration_3",
                                       "point_cloud.ply"))


@pytest.mark.slow
def test_quality_gate_thresholds(tmp_path):
    res = TS.quality_run(str(tmp_path), res=128, n_views=8, eval_split=(2, 5),
                         train_iters=400, backend="tiled", tsdf_resolution=96,
                         points_per_m2=1200, device="cpu")
    assert res["Average-PSNR"] > 12.0, res
    assert res["Average-SSIM"] > 0.45, res
    assert res["Chamfer-L1"] < 12.0, res
    assert np.isfinite(res["Chamfer-L1"])
