"""Render a camera batch to images (counterpart of the single-device branch
of `G4SplatPipeline._render_camera_batch` and of `render_all`,
g4splat_tpu/pipeline/orchestrator.py:1413-1483).

Plain functions over (scene, cameras); `G4SplatPipeline.render_all` calls
them over the pipeline's state and artifact store. Each view is one `render` call with the default
background and no distortion (one B1 launch on the cuda backend); with
`out_dir` the renders are written as `{v:05d}.png`, encoded on the I/O
thread pool while the next view renders. The fan-out over several devices
is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from g4splat_torch.core.cameras import Camera, camera_at
from g4splat_torch.io.images import flush_io, save_image_async
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig


def render_camera_batch(scene: GaussianScene, cameras: Camera,
                        out_dir: Optional[str] = None, backend: str = "cuda",
                        n_views: Optional[int] = None) -> torch.Tensor:
    """The first `n_views` (default all) cameras' (N, H, W, 3) renders on the
    scene's device; written to `out_dir/{v:05d}.png` when out_dir is given."""
    n = cameras.w2c.shape[0] if n_views is None else n_views
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    renders = []
    with torch.no_grad():
        for v in range(n):
            img = render(camera_at(cameras, v), scene,
                         config=RenderConfig(compute_distortion=False),
                         backend=backend)["render"]
            renders.append(img)
            if out_dir is not None:
                save_image_async(os.path.join(out_dir, f"{v:05d}.png"), img)
    flush_io()
    return torch.stack(renders)


def renders_dir(root: str, split: str, iteration: int) -> str:
    """`{root}/{split}/ours_{iteration}/renders`, the artifact store's layout."""
    return os.path.join(root, split, f"ours_{iteration}", "renders")


def render_all(scene: GaussianScene, cameras: Camera, iteration: int,
               out_root: Optional[str] = None, test_cameras: Optional[Camera] = None,
               backend: str = "cuda") -> torch.Tensor:
    """Render the train views, and the held-out test views when given, into
    `{out_root}/{train,test}/ours_{iteration}/renders` (nothing is written
    without out_root). Returns the train renders."""
    def out(split):
        return None if out_root is None else renders_dir(out_root, split, iteration)

    renders = render_camera_batch(scene, cameras, out("train"), backend)
    if test_cameras is not None:
        render_camera_batch(scene, test_cameras, out("test"), backend)
    return renders
