"""Run G4SplatPipeline.run() from posed photos, then the command line, then
resume on one CUDA card: chip_smoke.py's phases 17, 18 and 19 alone.

box_room(chip_smoke.MESH_DENSITY) photographed by B1 from
inward_cameras(10, 512, 384), views 8 and 9 held out, a calibrated source
tree; MASt3R at full width, DepthAnything V2 ViT-L and the full-width See3D
priors on seeded random weights, MASt3R's descriptors and pointmaps keyed
on the room's surface before they reach the geometry stages; PipelineConfig(sfm_config="posed",
alignment_config="default", use_multires_tsdf=True, n_see3d_stages=1) with
chip_smoke.LOOP_ITERATIONS steps per train_gaussians and 5 DDIM timesteps,
SAM ViT-H on seeded weights proposing the plane masks. Its gates (MASt3R card vs CPU and the matcher vs its unblocked plain
version, the posed cameras kept, the COLMAP trees, charts, finite training,
launch counts, the mesh, the result keys, the snapshots), then each
method's host seconds and launches, MASt3R's ms per chunk, the
correspondences per pair, SfM and chart ms per iteration, the COLMAP
writeout's seconds, SAM's encode, decode and selection + NMS times, its
candidates and kept masks per view, excavate_planes with seeded disc
logits in place of SAM's decoder, and peak device memory. Then phase 18:
`python -m g4splat_torch.cli` (in this process) on a source directory and a
zoo holding the same SAM as sam.npz, with its gates, output and launches.
Then phase 19 on the CLI's artifact store: resume, a retrain under
profiling.trace, a trainer checkpoint, the viewer, quality_run, the matches
export that phase 17 ran through its keyed MASt3R, and the zoo writer.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_front_end.py

Exits non-zero if a gate fails.
"""

import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.ops import cuda_build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("time_front_end: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          + cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0])
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    print("== run() from posed photos")
    r = cs.front_end_phase()
    cs.print_front_end(r)
    print("== the command line")
    with tempfile.TemporaryDirectory() as work:
        _, cli = cs.cli_phase(r.pop("sam_writer"), work)
        print("== resume and the shell")
        cs.print_resume(cs.resume_phase(cli, r.get("matches")))
    if cs.failures:
        print(f"time_front_end: {len(cs.failures)} check(s) failed:", *cs.failures,
              sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
