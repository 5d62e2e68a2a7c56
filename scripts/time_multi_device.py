"""Run chip_smoke.py's phase 20 alone on one CUDA card: the multi-device
paths (g4splat_torch.parallel) on a virtual mesh whose entries all are this
card, each against its single-device counterpart, with their gates, host
milliseconds and launches. The inputs are phase 4's: the seeded 200k-splat
bench scene at SH degree 3 and its 8 orbit cameras at 768x576.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_multi_device.py

Exits non-zero if a gate fails.
"""

import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.core.cameras import lookat_camera  # noqa: E402
from g4splat_torch.ops import cuda_build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("time_multi_device: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          + cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0])
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    n, W, H = cs.MAIN_SHAPE
    scene = cs.build_scene(n, 0, sh_degree=3)
    cams = [lookat_camera([6.5 * np.sin(a), -0.8, -6.5 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                          fx=600.0 * W / 768, fy=600.0 * W / 768, width=W, height=H,
                          device=cs.DEVICE)
            for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
    print("== phase 20: the multi-device paths")
    t0 = time.perf_counter()
    cs.print_multi_device(cs.multi_device_phase(scene, cams))
    print(f"  phase 20 {time.perf_counter() - t0:.1f} s")
    if cs.failures:
        print(f"time_multi_device: {len(cs.failures)} check(s) failed:", *cs.failures,
              sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
