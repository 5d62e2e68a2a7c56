"""Time the mesh main path of g4splat_torch on one CUDA card: chip_smoke.py's
phases 14 and 15 alone.

The adaptive-tetra extraction at production settings (PRODUCTION_MESH_CONFIG)
on the synthetic box room (chip_smoke.ADAPTIVE_DENSITY splats per m²) seen by
room_cameras(8, 512, 384), with its gates (B1's launch count, B1 vs its
plain version, the TSDF from B1's maps vs the plain version's, the mesh, the
PLY round trip, its completeness and accuracy against the culled GT mesh),
then the multires extraction (its Chamfer-L1); then every stage's seconds,
the TSDF pass beside its bound, the host stages' share and peak device
memory.

With --tsdf-chunks it times instead one TSDF pass (ops/tsdf.py, the
production options) over the extraction's first-pass inputs (the tetra
points and the 168 views' maps) at each point-chunk size, checks that every
size gives the default's result bit for bit, and profiles one pass at the
default size (torch.profiler: kernels launched, device busy share).

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_mesh.py [--tsdf-chunks 262144 2097152 ...]

Exits non-zero if a gate fails.
"""

import argparse
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.ops import cuda_build  # noqa: E402


def time_tsdf(chunks, reps=3):
    """One TSDF pass over the first-pass inputs at each chunk size: host-clock
    seconds (synchronized, median of `reps`), then a profile of one pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from g4splat_torch.eval.synthetic import box_room, room_cameras
    from g4splat_torch.ops.tsdf import integrate_views_chunked
    from g4splat_torch.pipeline import mesh_extraction as me

    n_views, w, h = cs.MESH_VIEWS
    cfg = me.PRODUCTION_MESH_CONFIG
    scene, _ = box_room(cs.MESH_DENSITY, device=cs.DEVICE)
    cams = room_cameras(n_views, w, h, device=cs.DEVICE)
    extent = me.cameras_spatial_extent(cams)
    cams = me.with_interpolated_views(cams, cfg)
    tcfg = me.tsdf_config(cfg, extent)
    pts, _ = scene.tetra_points(cfg.downsample_ratio, cfg.gaussian_flatness * extent, seed=0)
    pts = torch.as_tensor(pts, device=cs.DEVICE)
    views = me.render_all_views(scene, cams, cfg.depth_ratio)
    n_cams = cams.w2c.shape[0]
    bound, by = cs.tsdf_bound(len(pts), n_cams, w, h)

    def one(chunk):
        return integrate_views_chunked(pts, cams, views.rgbs, views.depths, tcfg, chunk=chunk)

    ref = one(cfg.point_chunk)
    for chunk in chunks:
        out = one(chunk)
        cs.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                 f"chunk {chunk}: the pass equals the default chunk's bit for bit")
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(chunk)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        print(f"  TSDF pass, chunk {chunk}: {t:.4f} s (median of {reps}; "
              + ", ".join(f"{x:.4f}" for x in times) + f"), {len(pts) * n_cams / t:.3e} "
              f"point-views per s; bound {bound:.4f} ms ({by}), {100 * bound / 1e3 / t:.3f} %")
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cs.DEVICE == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        ev[0].record()
        one(cfg.point_chunk)
        ev[1].record()
        ev[1].synchronize()
    wall = ev[0].elapsed_time(ev[1])
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    if not busy:
        print("  TSDF pass profile: no device time recorded (not measured)")
        return
    print(f"  TSDF pass profile (chunk {cfg.point_chunk}, torch.profiler): wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / wall:.1f} %, idle "
          f"{100 * (1 - busy / wall):.1f} %), {launches} device kernels, "
          f"{1e3 * wall / launches:.2f} us of wall per kernel")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"      {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:100]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tsdf-chunks", type=int, nargs="*",
                    help="time one TSDF pass at these point-chunk sizes instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_mesh: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
          + cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0])
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s")
    if args.tsdf_chunks:
        print(f"== TSDF pass, box room at {cs.MESH_DENSITY} splats per m²")
        time_tsdf(args.tsdf_chunks)
    else:
        print(f"== mesh main path, box room at {cs.ADAPTIVE_DENSITY} splats per m²")
        r = cs.mesh_phase()
        print("== mesh timings")
        cs.print_mesh_timings(r)
    if cs.failures:
        print(f"time_mesh: {len(cs.failures)} check(s) failed:", *cs.failures, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
