"""Run the command line and then resume from its artifacts on one CUDA
card: chip_smoke.py's phases 18 and 19 alone.

Phase 18 writes sam.npz from a seeded full-width SAM (SAMConfig(), seed 0,
as phase 17 builds it) and runs `python -m g4splat_torch.cli` in this
process on photos of the box room; phase 19 then runs on the CLI's artifact
store: stage_done, resume_from_artifacts in a fresh pipeline, train_gaussians
under profiling.trace, render_all, a trainer checkpoint and its exact
resume, the viewer, quality_run at the JAX package's gate configuration and
the zoo writer on a DepthAnythingV2 checkpoint, each with its gates, host
seconds and launches. Gate (vii), the matches export, needs phase 17's
keyed MASt3R and is reported as not run (scripts/time_front_end.py runs it).

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_resume.py

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
from g4splat_torch.priors.sam import SAMConfig, SAMPredictor  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("time_resume: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          + cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0])
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    print("== the command line")
    with tempfile.TemporaryDirectory() as work:
        _, cli = cs.cli_phase(SAMPredictor(SAMConfig(), seed=0, device=cs.DEVICE), work)
        torch.cuda.empty_cache()
        print("== resume and the shell")
        cs.print_resume(cs.resume_phase(cli, None))
    if cs.failures:
        print(f"time_resume: {len(cs.failures)} check(s) failed:", *cs.failures, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
