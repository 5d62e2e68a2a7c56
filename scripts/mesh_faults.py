"""Plant faults in g4splat_torch's adaptive-tetra mesh extraction and read
what chip_smoke.py's mesh-accuracy gate reads: evaluate_mesh of the mesh
against the GT mesh culled to the input views, on the CPU.

The scene is the synthetic box room at PRODUCTION_MESH_CONFIG (168 cameras
from 8), cut in scale to 3000 splats per m² and 256x192 so that it runs on
the CPU. Each fault is planted in memory, by wrapping the extraction's TSDF
evaluation, for one run:

  sound      no fault;
  flip1      the TSDF's sign flipped at 1 % of the points (by a hash of the
             point's coordinates, so midpoints are hit too);
  binsearch  the binary search keeps the wrong half (the TSDF's sign
             flipped in the binary steps only);
  narrow     each view observes only the central half of its image (depth
             zeroed elsewhere), so more space counts as unobserved.

The renders and the Delaunay cells do not depend on the fault and are made
once. Prints one JSON line per run, then checks that the sound run's Acc
and Chamfer-L1 lie within chip_smoke.ADAPTIVE_BAND of chip_smoke.ADAPTIVE_REF
and that each fault moves one of them out of that band around the sound
run's reading. Exits non-zero if not.

Run from the repository root (about 15 minutes on 8 CPU cores):

    python3 scripts/mesh_faults.py
"""

import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.eval.mesh_metrics import evaluate_mesh  # noqa: E402
from g4splat_torch.eval.synthetic import box_room, cull_mesh_to_views, room_cameras  # noqa: E402
from g4splat_torch.ops.tsdf import TSDFOut  # noqa: E402
from g4splat_torch.pipeline import mesh_extraction as me  # noqa: E402

DENSITY, VIEWS = 3000, (8, 256, 192)
FAULTS = ("sound", "flip1", "binsearch", "narrow")


def hashed(points, frac):
    """A fixed share `frac` of points, chosen by their coordinates."""
    q = torch.floor(points * 997.0).to(torch.int64)
    h = (q[:, 0] * 73856093) ^ (q[:, 1] * 19349663) ^ (q[:, 2] * 83492791)
    return (h.abs() % 10000) < int(frac * 10000)


def plant(fault, n_binary_steps):
    """The extraction's TSDF evaluation with `fault` planted."""
    tsdf = me.integrate_views_chunked
    calls = [0]

    def faulty(pts, cameras, images, depths, cfg, **kw):
        calls[0] += 1
        if fault == "narrow":
            _, h, w = depths.shape
            keep = torch.zeros_like(depths)
            keep[:, h // 4:h - h // 4, w // 4:w - w // 4] = 1.0
            depths = depths * keep
        out = tsdf(pts, cameras, images, depths, cfg, **kw)
        flip = None
        if fault == "flip1":
            flip = hashed(torch.as_tensor(pts, device=out.tsdf.device), 0.01)
        elif fault == "binsearch" and 2 <= calls[0] <= 1 + n_binary_steps:
            flip = torch.ones_like(out.tsdf, dtype=torch.bool)
        if flip is None:
            return out
        return TSDFOut(torch.where(flip, -out.tsdf, out.tsdf), out.colors, out.weights)

    return faulty


def memo(fn, key):
    cache = {}

    def wrapped(*args, **kw):
        k = key(*args, **kw)
        if k not in cache:
            cache[k] = fn(*args, **kw)
        return cache[k]

    return wrapped


def main():
    me.delaunay_tetrahedralize = memo(me.delaunay_tetrahedralize, lambda p: p.tobytes())
    me.render_all_views = memo(me.render_all_views,
                               lambda s, c, d, b="cuda", sh_degree=None:
                               (c.w2c.shape[0], b, sh_degree))
    scene, (gt_v, gt_f) = box_room(DENSITY, device="cpu")
    cams = room_cameras(*VIEWS, device="cpu")
    cfg = me.PRODUCTION_MESH_CONFIG.replace(backend="tiled")
    depths = me.render_all_views(scene, cams, cfg.depth_ratio, cfg.backend).depths.numpy().copy()
    depths[depths <= 0] = 3.2
    gt = cull_mesh_to_views(gt_v, gt_f, cams, depths)
    extract = me.integrate_views_chunked
    readings = {}
    for fault in FAULTS:
        me.integrate_views_chunked = plant(fault, cfg.n_binary_steps)
        t0 = time.perf_counter()
        mesh = me.extract_mesh_adaptive_tsdf(scene, cams, cfg)
        me.integrate_views_chunked = extract
        m = evaluate_mesh(mesh.vertices, mesh.faces, *gt)
        readings[fault] = m
        print(json.dumps({"fault": fault, "faces": len(mesh.faces),
                          "s": round(time.perf_counter() - t0, 1),
                          **{k: float(v) for k, v in m.items()}}), flush=True)
    keys = cs.ADAPTIVE_REF

    def out_of_band(m, ref):
        return any(abs(m[k] - ref[k]) > cs.ADAPTIVE_BAND * ref[k] for k in keys)

    sound = readings.pop("sound")
    cs.check(not out_of_band(sound, cs.ADAPTIVE_REF),
             "sound: " + ", ".join(f"{k} {sound[k]:.3f}" for k in keys)
             + f" within {cs.ADAPTIVE_BAND:.0%} of chip_smoke's reference {cs.ADAPTIVE_REF}")
    for fault, m in readings.items():
        cs.check(out_of_band(m, sound), f"{fault}: " + ", ".join(
            f"{k} {m[k]:.3f}" for k in keys) + f" outside {cs.ADAPTIVE_BAND:.0%} of "
            "the sound reading")
    if cs.failures:
        print(f"mesh_faults: {len(cs.failures)} check(s) failed:", *cs.failures, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
