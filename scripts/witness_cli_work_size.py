"""Run the JAX package's CLI on the CPU in posed mode with a view split and
`--work_size` half the photos' size (ROADMAP C23).

The scene is tests/test_torch_pipeline_run.py's (3 photos at 32², its
`sparse/0`), with `split-2views.json` holding view 2 out, `--work_size 16`,
2 iterations, one See3D stage and the test's YAML overlays; the sizes the
CLI has no flag for are cut by a `functools.partial` of `PipelineConfig`.
It prints the training cameras before and after `run_sfm` (the COLMAP
intrinsics are the photos', the images the work size's) and how `main`
ends. The port's CLI scales the cameras to the images
(`g4splat_torch.cli.scale_to_images`).

    python scripts/witness_cli_work_size.py
"""

import functools
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "tests"), REPO]

import conftest  # noqa: E402,F401  (JAX on the CPU)
import numpy as np  # noqa: E402

import g4splat_tpu.cli as JC  # noqa: E402
import g4splat_tpu.pipeline.orchestrator as JO  # noqa: E402
import g4splat_tpu.utils.config as JU  # noqa: E402
from g4splat_torch.io.images import save_image  # noqa: E402
from test_torch_pipeline_run import OVERLAY, scene_and_cameras, source_tree  # noqa: E402


def main():
    load = JU.load_config
    JO.load_config = JU.load_config = lambda g, n="default": {**load(g, n), **OVERLAY.get(g, {})}
    JO.PipelineConfig = functools.partial(
        JO.PipelineConfig, gaussian_capacity=4000, vis_grid_resolution=0, tsdf_resolution=24,
        none_visible_high=0.95, mvd_resolution=None, n_see3d_stages=1)
    tmp = tempfile.mkdtemp()
    images, jc, _ = scene_and_cameras()
    src = source_tree(tmp, jc)
    os.makedirs(os.path.join(src, "images"))
    for v, img in enumerate(images):
        save_image(os.path.join(src, "images", f"frame_{v:06d}.png"), img)
    with open(os.path.join(src, "split-2views.json"), "w") as f:
        json.dump({"train": [0, 1], "test": [2]}, f)
    run_sfm = JO.G4SplatPipeline.run_sfm

    def spy(self):
        for when in ("before", "after"):
            if when == "after":
                run_sfm(self)
            st = self.state
            print(f"{when} run_sfm: images {st.images.shape[1:3]}, cameras "
                  f"{st.cameras.width}x{st.cameras.height}, fx {np.asarray(st.cameras.fx)}, "
                  f"cx {np.asarray(st.cameras.cx)}")

    JO.G4SplatPipeline.run_sfm = spy
    argv = ["-s", src, "-o", os.path.join(tmp, "out"), "--sfm_config", "posed",
            "--use_view_config", "--config_view_num", "2", "--iterations", "2",
            "--render_backend", "tiled", "--work_size", "16", "--alignment_config", "fast",
            "--use_multires_tsdf", "--select_inpaint_num", "2"]
    try:
        print("main returned", JC.main(argv))
    except Exception as e:      # the witness reports how the run ends
        print(f"main raised {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
