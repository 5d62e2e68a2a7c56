"""The adaptive-tetra extraction on the synthetic box room, port against the
JAX package on the CPU, at the production MeshExtractionConfig (the
orchestrator's: downsample 0.5, flatness 2e-4, truncation 0.005 × extent,
8 binary steps, interpolated views from 2 neighbours, texture on) on the
`tiled` backend, cut in scale: box_room(1000), 4 cameras at 96×72, 2
interpolated views per neighbour (production: 10), so 20 cameras.

The two meshes must agree as on the sphere scenes (faces within 1 %, the
symmetric vertex Chamfer distance under 5e-4 m), and so must what
evaluate_mesh reads for each against the GT mesh culled to the input views
(Acc, Comp and Chamfer-L1 within 0.01 cm). The adaptive TSDF counts space no
view observes as inside, so both packages put surfaces in mid-air at frustum
edges and behind the box, and their Acc and Chamfer-L1 on this room sit
above evaluate_mesh's 5 cm threshold; this test holds the port to the JAX
package there, whatever the reading.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from g4splat_torch.convert import camera_from, scene_from
from g4splat_torch.eval.mesh_metrics import evaluate_mesh
from g4splat_torch.eval.synthetic import cull_mesh_to_views
from g4splat_torch.pipeline import mesh_extraction as tme
from g4splat_tpu.eval import synthetic as jsyn
from g4splat_tpu.pipeline import mesh_extraction as jme

DENSITY, VIEWS, PER_NEIGHBOR = 1000, (4, 96, 72), 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_adaptive_tsdf_box_room_production_config():
    js, gt_mesh = jsyn.box_room(DENSITY)
    jc = jsyn.room_cameras(*VIEWS)
    ts, tc = scene_from(js, device="cpu"), camera_from(jc, device="cpu")
    kw = dict(downsample_ratio=0.5, use_interpolated_views=True, backend="tiled",
              interp_per_neighbor=PER_NEIGHBOR)
    assert tme.PRODUCTION_MESH_CONFIG == tme.MeshExtractionConfig(
        downsample_ratio=0.5, use_interpolated_views=True)
    jm = jme.extract_mesh_adaptive_tsdf(js, jc, jme.MeshExtractionConfig(**kw))
    tm = tme.extract_mesh_adaptive_tsdf(ts, tc, tme.PRODUCTION_MESH_CONFIG.replace(
        backend="tiled", interp_per_neighbor=PER_NEIGHBOR))

    assert len(jm.faces) > 1000
    assert abs(len(tm.faces) - len(jm.faces)) <= 0.01 * len(jm.faces)
    d1 = cKDTree(jm.vertices).query(tm.vertices)[0]
    d2 = cKDTree(tm.vertices).query(jm.vertices)[0]
    assert (d1.mean() + d2.mean()) / 2 < 5e-4
    assert np.isfinite(tm.vertices).all()
    assert (tm.vertex_colors >= 0).all() and (tm.vertex_colors <= 1).all()

    views = tme.render_all_views(ts, tc, 1.0, backend="tiled")
    depths = views.depths.numpy().copy()
    depths[depths <= 0] = 3.2
    gt = cull_mesh_to_views(*gt_mesh, tc, depths)
    got = evaluate_mesh(tm.vertices, tm.faces, *gt)
    ref = evaluate_mesh(jm.vertices, jm.faces, *gt)
    for k in ("Acc", "Comp", "Chamfer-L1"):
        assert abs(got[k] - ref[k]) < 0.01, (k, got[k], ref[k])
    print("port / JAX: " + ", ".join(f"{k} {got[k]:.4f} / {ref[k]:.4f}"
                                     for k in ("Acc", "Comp", "Chamfer-L1")))
