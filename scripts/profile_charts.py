"""Time and profile chart alignment (`pipeline/chart_alignment.py`) at the
main path's shape on one CUDA card.

Eight charts at 512×384: box_room(chip_smoke.MESH_DENSITY) rendered by B1
from inward_cameras(8, 512, 384), its depths as the SfM reference (empty
pixels at the view's farthest depth) and the same with a smooth ±5 % bump
as the init. Prints ms per iteration of `align_charts` twice, then a
torch.profiler table of three steps by device time, with the card's name
and power limit.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/profile_charts.py [--steps 20]
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.core.cameras import camera_at  # noqa: E402
from g4splat_torch.eval.synthetic import box_room, inward_cameras  # noqa: E402
from g4splat_torch.ops.rasterize import render  # noqa: E402
from g4splat_torch.pipeline import chart_alignment as C  # noqa: E402


def inputs(n_views, w, h, device):
    scene, _ = box_room(cs.MESH_DENSITY, device=device)
    cams = inward_cameras(n_views, w, h, device=device)
    with torch.no_grad():
        d = torch.stack([render(camera_at(cams, v), scene, backend="cuda" if device == "cuda" else "tiled")["surf_depth"]
                         for v in range(n_views)])
    far = d.flatten(1).amax(1)[:, None, None].expand_as(d)
    ref = torch.where(d > 0, d, far)
    xs = torch.linspace(0, 6.28, w, device=device)
    init = ref * (1 + 0.05 * torch.sin(xs)[None, None, :])
    return cams, init, ref


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shape", type=int, nargs=3, default=(8, 512, 384))
    args = ap.parse_args()
    dev = cs.DEVICE
    if dev == "cuda":
        if not torch.cuda.is_available():
            print("profile_charts: needs a CUDA card", file=sys.stderr)
            return 2
        from g4splat_torch.ops import cuda_build
        cuda_build.build_all()
        print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
              + cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0])
    cams, init, ref = inputs(*args.shape, dev)
    cfg = C.ChartAlignConfig(n_iterations=args.steps)
    for _ in range(2):
        stats = {}
        res = C.align_charts(cams, init, ref, extent=1.0, cfg=cfg, stats=stats)
        print(f"  {1e3 * stats['s_per_iter']:.2f} ms per iteration ({args.steps} steps), last "
              f"loss {res.losses[-1]:.6f}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        C.align_charts(cams, init, ref, extent=1.0, cfg=C.ChartAlignConfig(n_iterations=3))
    key = "self_cuda_time_total" if dev == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
