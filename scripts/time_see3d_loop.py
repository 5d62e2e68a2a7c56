"""Run one See3D loop of g4splat_torch on one CUDA card: chip_smoke.py's
phase 16 alone.

G4SplatPipeline on box_room(chip_smoke.MESH_DENSITY) seen by
inward_cameras(8, 512, 384): render_chart_views, excavate_planes,
refine_plane_depths and train_gaussians, then for stages 1-3 see3d_stage,
refine_plane_depths and train_gaussians, with full-width See3D priors and
DepthAnything V2 ViT-L on seeded random weights, PipelineConfig's defaults
save chip_smoke.LOOP_SELECT views selected per stage,
chip_smoke.LOOP_ITERATIONS steps per train_gaussians and 5 DDIM
timesteps; its gates (the stage-1 sweep with B1's plain version, DA2 card vs
CPU, the depth lift, the merge, the files, finite training, launch counts);
then each method's host seconds and launches, each stage's counts, DA2's ms
per call and peak device memory.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_see3d_loop.py

Exits non-zero if a gate fails.
"""

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.ops import cuda_build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("time_see3d_loop: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          + cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0])
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    print("== See3D loop")
    r = cs.see3d_loop_phase()
    cs.print_see3d_loop(r)
    if cs.failures:
        print(f"time_see3d_loop: {len(cs.failures)} check(s) failed:", *cs.failures,
              sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
