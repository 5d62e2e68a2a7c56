"""Evaluation: PSNR/SSIM/LPIPS and mesh metrics → the results dict
(counterpart of `G4SplatPipeline.evaluate`,
g4splat_tpu/pipeline/orchestrator.py:1549-1603).

A plain function over (scene, cameras, …); `G4SplatPipeline.evaluate` runs
the same schema over the pipeline's state and artifact store. The schema is the JAX package's (the reference's
eval/eval.py:67-104): on a held-out split, `test_views_num` and
`Average-PSNR/SSIM/LPIPS` rounded to 5 decimals; against `gt_images`, the
train views' unrounded `PSNR/SSIM/LPIPS`; against `gt_mesh`, the keys of
`evaluate_mesh`; and `LPIPS-uncalibrated` when the LPIPS weights are a
random init. With `out_dir` it writes `result_iter_{iteration}.json/.txt`,
the renders under `{split}/ours_{iteration}/renders` and the extracted mesh.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from g4splat_torch.core.cameras import Camera
from g4splat_torch.eval.image_metrics import LPIPS, evaluate_images
from g4splat_torch.eval.mesh_metrics import evaluate_mesh
from g4splat_torch.io.ply import save_mesh_ply
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.pipeline.mesh_extraction import (
    PRODUCTION_MESH_CONFIG,
    ExtractedMesh,
    MeshExtractionConfig,
    extract_mesh_adaptive_tsdf,
)
from g4splat_torch.pipeline.render_all import render_camera_batch, renders_dir


def evaluate(scene: GaussianScene, cameras: Camera, gt_images=None, gt_mesh=None,
             test_cameras: Optional[Camera] = None, test_images=None,
             lpips_model: Optional[LPIPS] = None, out_dir: Optional[str] = None,
             mesh: Optional[ExtractedMesh] = None, iteration: int = 7000,
             backend: str = "cuda",
             mesh_config: MeshExtractionConfig = PRODUCTION_MESH_CONFIG) -> Dict:
    """The results dict. `gt_mesh` is (vertices, faces); the predicted mesh is
    `mesh`, or else extracted from the scene (adaptive tetra, `mesh_config`).
    `backend` renders both the images and the extraction's views, as the
    orchestrator's one `render_backend` does. A default LPIPS model lies on
    the scene's device."""
    results: Dict = {}
    lp = lpips_model if lpips_model is not None else LPIPS(device=scene.device)
    if not getattr(lp, "calibrated", True):
        results["LPIPS-uncalibrated"] = True

    def out(split):
        return None if out_dir is None else renders_dir(out_dir, split, iteration)

    if test_images is not None and test_cameras is not None:
        n_test = len(test_images)
        test_renders = render_camera_batch(scene, test_cameras, out("test"), backend,
                                           n_views=n_test)
        m = evaluate_images(test_renders, test_images, lpips_model=lp)
        results["test_views_num"] = n_test
        results["Average-PSNR"] = round(m["PSNR"], 5)
        results["Average-SSIM"] = round(m["SSIM"], 5)
        results["Average-LPIPS"] = round(m["LPIPS"], 5)
    if gt_images is not None:
        renders = render_camera_batch(scene, cameras, out("train"), backend)
        n = min(len(renders), len(gt_images))
        results.update(evaluate_images(renders[:n], gt_images[:n], lpips_model=lp))
    if gt_mesh is not None:
        if mesh is None:
            mesh = extract_mesh_adaptive_tsdf(scene, cameras,
                                              mesh_config.replace(backend=backend))
            if out_dir is not None:
                os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
                save_mesh_ply(os.path.join(
                    out_dir, "meshes", f"tetra_mesh_binary_search_7_iter_{iteration}.ply"),
                    mesh.vertices, mesh.faces, mesh.vertex_colors)
        results.update(evaluate_mesh(mesh.vertices, mesh.faces, gt_mesh[0], gt_mesh[1]))
    if out_dir is not None:
        write_results(out_dir, iteration, results)
    return results


def write_results(out_dir: str, iteration: int, results: Dict) -> None:
    """`result_iter_{iteration}.json` and `.txt` under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"result_iter_{iteration}.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(out_dir, f"result_iter_{iteration}.txt"), "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
