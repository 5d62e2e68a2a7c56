"""Drive the g4splat_torch render path on one NVIDIA GPU and hold its CUDA
kernel against the kernel's plain PyTorch version.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device, toolkit and card (TF32 turned off for matmul and cuDNN);
  2. build every kernel from g4splat_torch/csrc (prints nvcc -Xptxas -v);
  3. kernel vs plain version in all three modes on the 8k-splat "spread" and
     "deep-overlap" scenes at 256x192 (fx = fy = 220), and on the spread
     scene seen from close by, where the distortion map is large;
  4. the main path: a 200k-splat scene at SH degree 3, written to PLY and
     read back, rendered by render(backend="cuda") from 8 orbit cameras at
     768x576 with need_aux=False and again with compute_distortion=False;
     the kernel's launch count must rise by exactly 16;
  5. one frame of a 2.4M-splat scene at 512x384 in all three modes;
  6. timings: the kernel, the whole render() and its stages, the plain
     version, the kernel's bound, peak memory.
Prints a {"kernels": [...]} JSON line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 peak outside the tensor cores
# A float map's pixel agrees when |kernel - plain| <= MAP_TOL * max|plain map|
# (at least ABS_FLOOR: distortion is a difference of sums of size ~1, in which
# fp32 rounding leaves up to ~4e-7 of noise). fp32 taken in another order,
# with fused multiply-adds, can flip alpha >= 1/255 or a T crossing at
# isolated pixels, so each map's disagreeing pixels, and n_contrib's, must
# stay under FLIP_FRAC of the image.
MAP_TOL = 1e-3
ABS_FLOOR = 1e-6
FLIP_FRAC = 1e-3
DEVICE = "cuda"
# (splats, width, height) of phases 3, 4 and 5.
CHECK_SHAPE = (8000, 256, 192)
MAIN_SHAPE = (200_000, 768, 576)
BIG_SHAPE = (2_400_000, 512, 384)
MODES = {"infer": (False, True), "nodist": (True, False), "full": (True, True)}
FLOAT_MAPS = ("color", "normal", "depth_acc", "alpha", "distortion", "final_T",
              "m1_tot", "m2_tot")

failures = []
max_abs_err = 0.0


def check(ok, what):
    print(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def build_scene(n, seed, spread=3.0, wall=True, opacity=0.8, log_scale=(-4.5, -3.0),
                sh_degree=0):
    """bench.py's room-like shell (walls/floor plus clutter), or with
    wall=False the uniform cube of scripts/check_pallas.py."""
    import torch

    from g4splat_torch.models.gaussians import GaussianScene

    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    if wall:
        xyz[rng.randint(0, 8, n) == 0, 2] = 3.0
    cols = rng.rand(n, 3).astype(np.float32)
    scales = np.exp(rng.uniform(*log_scale, n)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    scene = GaussianScene.from_points(xyz, cols, scales=scales, quats=quats,
                                      initial_opacity=opacity, device=DEVICE)
    if sh_degree:
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        f_rest = 0.05 * torch.randn(scene.f_rest.shape, generator=gen, device=DEVICE)
        scene = scene.replace(f_rest=f_rest, active_sh_degree=sh_degree)
    return scene


def kernel_inputs(cam, scene):
    from g4splat_torch.ops.rasterize_common import RenderConfig, preprocess
    from g4splat_torch.ops.rasterize_cuda import pack_entries
    from g4splat_torch.ops.rasterize_tiled import bin_splats

    prep = preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw, scene.opacity(),
                      scene.features(), scene.active_sh_degree, config=RenderConfig())
    b = bin_splats(prep, cam.width, cam.height)
    return b, pack_entries(prep, b.gauss_id)


def compare_maps(tag, got, ref):
    """Grade the kernel's maps against the plain version's. Prints, per map,
    the largest |d| over all pixels and over the agreeing ones, the plain
    map's largest value, the share of pixels that disagree, and the share a
    map of zeros would get wrong (what the check can see). Returns the
    latter per map."""
    global max_abs_err
    import torch

    worst, lines, seen = 0.0, [], {}
    for k in FLOAT_MAPS + ("median_depth",):
        d = (got[k] - ref[k]).abs()
        d = d.amax(-1) if d.ndim == 3 else d
        scale = float(ref[k].abs().max())
        tol = max(MAP_TOL * scale, ABS_FLOOR)
        over = d > tol
        flips = float(over.to(torch.float32).mean())
        rest = float(torch.where(over, 0.0, d).max())
        seen[k] = float((ref[k].abs().amax(-1) if ref[k].ndim == 3 else ref[k].abs())
                        .gt(tol).to(torch.float32).mean())
        worst = max(worst, flips)
        if k != "median_depth":       # a flipped median moves by a depth gap
            max_abs_err = max(max_abs_err, float(d.max()))
        lines.append(f"      {k:12s} max|d| {float(d.max()):.2e}  agreeing {rest:.2e}  "
                     f"max|plain| {scale:.2e}  tol {tol:.1e}  disagree {flips:.1e}  "
                     f"zeros would {seen[k]:.1e}")
    nc = float((got["n_contrib"] != ref["n_contrib"]).to(torch.float32).mean())
    check(worst < FLIP_FRAC and nc < FLIP_FRAC,
          f"{tag}: worst map disagrees at {worst:.1e} of pixels, n_contrib at {nc:.1e}")
    print("\n".join(lines))
    return seen


def kernel_vs_plain(tag, b, entries, w, h, modes=MODES):
    """Run kernel and plain version on the same card tensors in each mode.
    Returns the kernel's work on these inputs, (pairs walked, entries its
    tiles must read), and the last mode's compare_maps result."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries, rasterize_entries_plain

    bg = torch.tensor([0.05, 0.1, 0.15], device=DEVICE)
    work = seen = None
    for mode in modes:
        aux, dist = MODES[mode]
        got = rasterize_entries(entries, b.tile_start, b.tile_count, bg, w, h,
                                want_aux=aux, want_dist=dist)
        ref = rasterize_entries_plain(entries, b.tile_start, b.tile_count, bg, w, h,
                                      want_aux=aux, want_dist=dist)
        torch.cuda.synchronize()
        seen = compare_maps(f"{tag} [{mode}]", got, ref)
        work = (int(ref["n_walked"].sum()), tile_reads(ref["n_walked"], w, h))
    return work, seen


def tile_reads(n_walked, w, h):
    """Entries the kernel's tiles must read: per tile, the most that any of
    its pixels walks (the rest of its range lies behind saturated pixels)."""
    from g4splat_torch.ops.rasterize_common import TILE

    gx, gy = -(-w // TILE), -(-h // TILE)
    pad = n_walked.new_zeros((gy * TILE, gx * TILE))
    pad[:h, :w] = n_walked
    return int(pad.reshape(gy, TILE, gx, TILE).amax(dim=(1, 3)).sum())


def cuda_ms(fn, reps=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bound(n_read, n_tiles, w, h, pairs):
    """Least time for the kernel's work on this run's data: the entry rows
    its tiles must read, the tile ranges and bg read once and the maps
    written once, against the fp32 operations on the pairs walked. Returns
    (ms, 'bytes' | 'operations')."""
    from g4splat_torch.ops.rasterize_cuda import ENTRY_F, OPS_PER_PAIR, OUT_BYTES_PER_PIXEL

    nbytes = n_read * ENTRY_F * 4 + n_tiles * 8 + 12 + w * h * OUT_BYTES_PER_PIXEL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_PAIR / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(tag, b, entries, w, h, work, modes):
    """Kernel and plain-version ms per mode at this shape, beside the bound."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries, rasterize_entries_plain

    bg = torch.zeros(3, device=DEVICE)
    rows = {}
    pairs, n_read = work
    bound, bound_by = kernel_bound(n_read, b.tile_count.numel(), w, h, pairs)
    for mode in modes:
        aux, dist = MODES[mode]
        args = (entries, b.tile_start, b.tile_count, bg, w, h)
        k_ms = cuda_ms(lambda: rasterize_entries(*args, want_aux=aux, want_dist=dist))
        p_ms = cuda_ms(lambda: rasterize_entries_plain(*args, want_aux=aux, want_dist=dist),
                       reps=1, warmup=0)   # warm: it just ran in phase 3-5
        rows[mode] = (k_ms, p_ms)
        print(f"  {tag} [{mode}] kernel {k_ms:.4f} ms  plain {p_ms:.2f} ms  bound "
              f"{bound:.4f} ms ({bound_by})  entries {entries.shape[0]}, read {n_read}  "
              f"pairs walked {pairs}")
    return rows, bound, bound_by


def time_render(tag, cam, scene, cfg, need_aux, reps=5):
    """Whole render() ms (host clock, synchronized), then its stages run in
    turn by the functions render() calls, each timed by CUDA events from the
    end of the one before (device time, host gaps included)."""
    import torch

    from g4splat_torch.ops.rasterize import postprocess, render
    from g4splat_torch.ops.rasterize_common import preprocess
    from g4splat_torch.ops.rasterize_cuda import pack_entries, rasterize_entries
    from g4splat_torch.ops.rasterize_tiled import bin_splats

    W, H = cam.width, cam.height
    bg = torch.as_tensor(cfg.bg, dtype=torch.float32).to(DEVICE)
    stages = ("preprocess", "bin", "pack", "kernel", "post")
    splits, totals = {s: [] for s in stages}, []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(cam, scene, cfg, backend="cuda", need_aux=need_aux)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        prep = preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw,
                          scene.opacity(), scene.features(), scene.active_sh_degree,
                          config=cfg)
        ev[1].record()
        b = bin_splats(prep, W, H, max_tiles_per_splat=cfg.max_tiles_per_splat,
                       ellipse_prune=cfg.tile_ellipse_prune)
        ev[2].record()
        entries = pack_entries(prep, b.gauss_id)
        ev[3].record()
        maps = rasterize_entries(entries, b.tile_start, b.tile_count, bg, W, H,
                                 near=cfg.near, far=cfg.far, want_aux=need_aux,
                                 want_dist=cfg.compute_distortion)
        ev[4].record()
        postprocess(cam, cfg, prep, maps, b.n_dropped, b.n_overflow)
        ev[5].record()
        torch.cuda.synchronize()
        if i == 0:
            continue          # warm-up
        totals.append(total)
        for s, a, e in zip(stages, ev, ev[1:]):
            splits[s].append(a.elapsed_time(e))
    med = {s: float(np.median(v)) for s, v in splits.items()}
    split = " ".join(f"{k} {v:.3f}" for k, v in med.items())
    print(f"  {tag} render() {np.median(totals):.3f} ms (median of {reps}); "
          f"stages ms: {split} (sum {sum(med.values()):.3f})")
    return float(np.median(totals))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from g4splat_torch.ops import cuda_build, rasterize_cuda
        from g4splat_torch.core.cameras import lookat_camera
        from g4splat_torch.io.ply import load_gaussian_ply, save_gaussian_ply
        from g4splat_torch.ops.rasterize import render
        from g4splat_torch.ops.rasterize_common import RenderConfig
    except ImportError as e:
        print(f"chip_smoke: cannot import g4splat_torch next to this script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    print("== phase 1: device")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = [l for l in run([cuda_build._nvcc(), "--version"]).splitlines() if "release" in l]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    print(f"  nvcc: {nvcc[0] if nvcc else 'unknown'}")
    print(f"  nvidia-smi name, power.limit: {smi}")
    print("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    print("== phase 2: build")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"  built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if line.strip():
                print(f"  [{name}] {line.strip()}")

    n3, w3, h3 = CHECK_SHAPE
    print(f"== phase 3: kernel vs plain version, {n3} splats at {w3}x{h3}")
    print(f"  tolerance: a float map's pixel agrees when |kernel - plain| <= "
          f"{MAP_TOL} * max|plain map| (at least {ABS_FLOOR}); every map's "
          f"disagreeing pixels, and n_contrib's, < {FLIP_FRAC} of the image")
    # "near" is the spread scene seen from close by (depths 0.6-4.6, as from a
    # camera inside a room): its distortion stands well above fp32 noise.
    for tag, spread, seed, cam_z in (("spread", 2.0, 1, -5.5), ("deep-overlap", 0.35, 3, -5.5),
                                     ("near", 2.0, 1, -2.6)):
        cam3 = lookat_camera([0, 0, cam_z], [0, 0, 0], [0, -1, 0], fx=220.0, fy=220.0,
                             width=w3, height=h3, device=DEVICE)
        scene = build_scene(n3, seed, spread=spread, wall=False, opacity=0.7,
                            log_scale=(-3.5, -2.0))
        with torch.no_grad():
            b, entries = kernel_inputs(cam3, scene)
            print(f"  {tag}: {entries.shape[0]} entries, densest tile "
                  f"{int(b.tile_count.max())}")
            _, seen = kernel_vs_plain(tag, b, entries, w3, h3)
            cpu = render(cam3.to("cpu"), scene.to("cpu"), backend="cuda")
            gpu = render(cam3, scene, backend="cuda")
        check(int(cpu["n_dropped"]) == int(gpu["n_dropped"]),
              f"{tag} n_dropped card {int(gpu['n_dropped'])} == cpu {int(cpu['n_dropped'])}")
    check(seen["distortion"] > 0.1, f"near: a zero distortion map would disagree at "
          f"{seen['distortion']:.2f} of pixels (> 0.1), so the distortion check can fail")

    n4, W, H = MAIN_SHAPE
    print(f"== phase 4: main path, {n4} splats, SH 3, 8 cameras at {W}x{H}")
    torch.cuda.reset_peak_memory_stats()
    src = build_scene(n4, 0, sh_degree=3)
    smoke_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(smoke_dir, exist_ok=True)
    ply = os.path.join(smoke_dir, "point_cloud.ply")
    save_gaussian_ply(ply, src)
    scene = load_gaussian_ply(ply, device=DEVICE)
    os.remove(ply)
    check(scene.active_sh_degree == 3 and all(torch.equal(a, b) for a, b in
                                              zip(scene.tensors(), src.tensors())),
          "PLY round trip restores the scene exactly (SH degree 3)")
    cams = [lookat_camera([6.5 * np.sin(a), -0.8, -6.5 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                          fx=600.0 * W / 768, fy=600.0 * W / 768, width=W, height=H,
                          device=DEVICE)
            for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
    main_cfgs = (("infer", RenderConfig(), False),
                 ("nodist", RenderConfig(compute_distortion=False), True))
    torch.cuda.synchronize()
    rasterize_cuda.RASTERIZE_FWD.launches = 0
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    t0 = time.perf_counter()
    with torch.no_grad():
        for _, cfg, need_aux in main_cfgs:
            for cam in cams:
                out = render(cam, scene, cfg, backend="cuda", need_aux=need_aux)
                for v in out.values():
                    if v.is_floating_point():
                        finite &= torch.isfinite(v).all()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = rasterize_cuda.RASTERIZE_FWD.launches
    check(launches == 16, f"main path launched the kernel {launches} times (16 expected)")
    check(bool(finite), "every main-path output is finite")
    print(f"  16 frames in {main_s:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.no_grad():
        b4, e4 = kernel_inputs(cams[0], scene)
        work4, _ = kernel_vs_plain("main frame 0", b4, e4, W, H, modes=("infer", "nodist"))

    n5, w5, h5 = BIG_SHAPE
    print(f"== phase 5: production shape, {n5} splats, SH 3, {w5}x{h5}")
    torch.cuda.reset_peak_memory_stats()
    big = build_scene(n5, 0, sh_degree=3)
    cam5 = lookat_camera([0, -0.8, -6.5], [0, 0, 0], [0, -1, 0], fx=600.0 * w5 / 768,
                         fy=600.0 * w5 / 768, width=w5, height=h5, device=DEVICE)
    with torch.no_grad():
        b5, e5 = kernel_inputs(cam5, big)
        print(f"  {e5.shape[0]} entries, densest tile {int(b5.tile_count.max())}")
        work5, _ = kernel_vs_plain("production", b5, e5, w5, h5)
        out5 = {m: render(cam5, big, RenderConfig(compute_distortion=d), backend="cuda",
                          need_aux=a) for m, (a, d) in MODES.items()}
    check(all(bool(torch.isfinite(v).all()) for o in out5.values() for v in o.values()
              if v.is_floating_point()), "production-shape render() outputs finite in all modes")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print("== phase 6: timing")
    with torch.no_grad():
        tag4, tag5 = f"{W}x{H} {n4}", f"{w5}x{h5} {n5}"
        rows4, bound4, by4 = time_kernel(tag4, b4, e4, W, H, work4, MODES)
        time_kernel(tag5, b5, e5, w5, h5, work5, MODES)
        for mode, cfg, need_aux in main_cfgs:
            time_render(f"{tag4} [{mode}]", cams[0], scene, cfg, need_aux)
        for mode, (a, d) in MODES.items():
            time_render(f"{tag5} [{mode}]", cam5, big,
                        RenderConfig(compute_distortion=d), a, reps=3)
    print("  library_ms: none (no single PyTorch call computes this function)")
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", *failures, sep="\n  ")
        return 1
    # One launch of the main path = its two modes at frame 0, averaged.
    main_ms = float(np.mean([rows4[m][0] for m in ("infer", "nodist")]))
    main_plain = float(np.mean([rows4[m][1] for m in ("infer", "nodist")]))
    info = rasterize_cuda.RASTERIZE_FWD
    print(json.dumps({"kernels": [{
        "name": info.name, "route": "cuda", "source": info.source,
        "replaces": info.replaces, "launches": launches, "max_abs_err": max_abs_err,
        "ms": main_ms, "plain_ms": main_plain, "bound_ms": bound4, "bound_by": by4,
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
