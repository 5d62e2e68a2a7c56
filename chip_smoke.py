"""Drive the g4splat_torch render, training, See3D inpainting, output and
See3D-loop paths on one NVIDIA GPU and hold their CUDA kernels (B1 forward
rasterizer, B2 backward rasterizer, B3 attention) against the kernels'
plain PyTorch versions.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device, toolkit and card; PyTorch's TF32 flags, which the port's
     entry points turn off while they run (g4splat_torch.device.fp32_math);
  2. build every kernel from g4splat_torch/csrc, one nvcc per source, all
     started together (prints nvcc -Xptxas -v); count each kernel's
     tensor-core instructions in its SASS (cuobjdump): B3's D = 64 kernel
     must hold wgmma's (HGMMA);
  3. B1 vs its plain version in all three modes, and B2 vs its plain
     version in both modes (B1's saved aux, seeded random cotangents), on
     the 8k-splat "spread" and "deep-overlap" scenes at 256x192
     (fx = fy = 220), and on the spread scene seen from close by, where the
     distortion map is large; on each, B1 reading rows through gauss_id
     bitwise equal to B1 on the gathered rows, no pair with alpha >= 1/255
     that B1 walks and no contributing pair of B2 outside its entry's reach
     box, and (deep-overlap too) B2's work list vs its plain version; B2's
     time;
  4. the render main path: a 200k-splat scene at SH degree 3, written to PLY
     and read back, rendered by render(backend="cuda") from 8 orbit cameras
     at 768x576 with need_aux=False and again with compute_distortion=False;
     B1's launch count must rise by exactly 16; on each orbit frame B1 vs
     its plain version in all three modes and B1's reach boxes;
  5. one frame of a 2.4M-splat scene at 512x384: B1 in all three modes and
     B2 in both, against their plain versions; the gauss_id bitwise check;
     no pair outside its reach box (B1, and B2 in either mode); B2's time;
  6. render timings: B1, the whole render() and its stages (preprocess,
     binning, the splat table, B1, post), the plain version, B1's bound (on
     the pairs its reach boxes leave, beside the bound on every pair
     walked), its per-tile reads, reach-box skip share, registers and waves;
  7. whole-chain gradients: render(backend="cuda") (B1 + B2 in one autograd
     Function) against render(backend="tiled") (PyTorch autograd) on a small
     scene, every scene parameter and the screen-space offset; B1 and B2 rise
     by exactly one per backward;
  8. the training main path: 5 views at 512x384 rendered by B1 from a seeded
     1.2M-splat scene, a jittered grey init in a 2.4M-slot buffer, SH 3,
     TrainConfig's production defaults; 30 Trainer.step() calls with a
     densify window (densify at 10, 20, 30), then 5 with lambda_dist > 0;
     finite losses, loss down and PSNR up over the view cycle, and exactly
     one B1 and one B2 launch per step; no pair outside its reach box (B1
     and B2) on the trained scene;
  9. training timings: the median step and its split (forward render,
     losses, backward, Adam, densify); at the training shape (the first
     step's scene): B1's per-tile reads, reach-box skip share, registers,
     waves and bound; B2's per-tile walk lengths, its walk kernel's registers
     and resident blocks, the (warp, entry) steps its reach boxes skip (none
     holding a contributor), its work list and its gradients vs their plain
     versions, and its time (whole call) beside its bound and the plain
     version's; peak memory.
 10. B3 vs its plain version (chunked_attention) at every attention shape of
     the See3D main path, at odd shapes and at D = 128: max|kernel - plain|
     <= B3_TOL * max|plain|, with the dense plain version's error beside
     B3's where its logits fit; on ±30-scaled logits against a float64
     reference (B3_TOL64); B3, plain and F.scaled_dot_product_attention ms
     (CUDA events) beside the tensor-core and CUDA-core bounds;
 11. the See3D main path at full MVDream width (UNetConfig(), AutoencoderKL(),
     CLIPVision(), CLIPText(), seeded random weights, the zero-init layers
     re-drawn): 4 reference images and 5 warps with their masks rendered by
     B1 at 512x512 from the phase-4 scene, run_see3d_inpaint with 5 DDIM
     timesteps; finite outputs, exactly 32 B3 launches per UNet call, the
     UNet run with TF32 off, and the same stage with plain attention agrees
     (images);
 12. See3D timings: the stage's split (CLIP, VAE encode, UNet call, DDIM
     loop, VAE decode) by CUDA events; the DDIM loop's latents with B3 and
     with plain attention agree; peak memory.
 13. render_all and eval on phase 8's trained scene: render_camera_batch over
     its 5 views at 512x384 through B1 (exactly 5 launches) writing PNGs
     that read back equal to the uint8 renders; PSNR/SSIM/LPIPS (random-init
     VGG16) finite against the training images; LPIPS on the card vs on the
     CPU with the same params within LPIPS_REL; evaluate() with the last two
     views held out gives and writes the JAX package's keys (7 launches);
 14. the mesh main path at production settings: box_room(9000 per m²),
     room_cameras(8, 512, 384), PRODUCTION_MESH_CONFIG (downsample 0.5,
     2 x 10 interpolated views: 168 cameras, 8 binary steps, texture on);
     B1 launches exactly 2 x 168 times; B1 vs its plain version on an input
     and an interpolated camera; the first-pass TSDF at every tetra point
     from B1's maps of the 8 input views vs the plain version's (TSDF_TOL,
     FLIP_FRAC); the mesh finite with colours in [0, 1]; keep_largest_clusters,
     then a PLY round trip; against the GT mesh culled to the input views,
     Comp < CHAMFER_CM and recall > RECALL_MIN, Acc and Chamfer-L1 within
     ADAPTIVE_BAND of ADAPTIVE_REF; the multires extraction at 128^3 (8 launches)
     non-empty and finite, Chamfer-L1 < CHAMFER_CM;
 15. mesh timings: every stage of the adaptive extraction (tetra points,
     Delaunay, both render_all_views, the first TSDF pass, each binary step,
     marching, colours) and of the multires levels; the TSDF's point-views
     per second beside its bound; the host stages' share of the wall time;
     peak device memory.
 16. one See3D loop through G4SplatPipeline (run()'s order without SfM,
     charts, mesh and eval): box_room(MESH_DENSITY) rendered by B1 from
     inward_cameras(8, 512, 384) as the inputs and the stand-in chart depths;
     PipelineConfig() save LOOP_ITERATIONS steps per train_gaussians and 5
     DDIM timesteps; full-width See3D priors and DepthAnything("vitl") on
     seeded random weights; render_chart_views, excavate_planes,
     refine_plane_depths, train_gaussians, then per stage see3d_stage(k),
     refine_plane_depths(k == 3), train_gaussians. Gates: (i) stage 1's
     candidate sweep again with B1's plain version gives every none-visible
     rate within RATE_TOL and the same selection; (ii) DA2 on one inpainted
     view, card vs the same module on the CPU, within DA2_REL * max|CPU|;
     (iii) lifted depths equal the rendered depth inside each visible mask
     bit for bit, finite and > 0; (iv) the views grow by the selected count,
     the anchor ids are that range, see3d_cameras.npz's n_views is the sum;
     (v) each stage directory holds the files by name; (vi) after each
     train_gaussians no non-finite live splat and finite losses; (vii) B3
     launches 32 per UNet call per stage, B2 one per training step. Prints
     each method's host seconds and launches, per stage the candidates,
     selected and views, DA2 ms per call, launches and peak memory.
Prints a {"kernels": [...]} JSON line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 peak outside the tensor cores
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 tensor-core peak
# exp2 on the SFUs: 16 per clock and SM, 132 SMs at the 1.98 GHz boost clock.
EXP2_PER_S = 16 * 132 * 1.98e9
# A float map's pixel agrees when |kernel - plain| <= MAP_TOL * max|plain map|
# (at least ABS_FLOOR: distortion is a difference of sums of size ~1, in which
# fp32 rounding leaves up to ~4e-7 of noise). fp32 taken in another order,
# with fused multiply-adds, can flip alpha >= 1/255 or a T crossing at
# isolated pixels, so each map's disagreeing pixels, and n_contrib's, must
# stay under FLIP_FRAC of the image.
MAP_TOL = 1e-3
ABS_FLOOR = 1e-6
FLIP_FRAC = 1e-3
# B2 vs its plain version: ||kernel - plain|| / ||plain|| per gradient group
# (dT, d_center, d_opacity, d_rgb, d_normal), the JAX package's Pallas gate
# (scripts/check_pallas.py). Atomics add in another order on every run, and a
# contributor or median decision flipped by fused multiply-adds moves a whole
# entry's share of the gradient.
GRAD_TOL = 2e-2
# render(backend="cuda") gradients vs render(backend="tiled") (autograd).
CHAIN_TOL = 1e-2
DEVICE = "cuda"
# (splats, width, height) of phases 3, 4, 5 and 7.
CHECK_SHAPE = (8000, 256, 192)
MAIN_SHAPE = (200_000, 768, 576)
BIG_SHAPE = (2_400_000, 512, 384)
CHAIN_SHAPE = (3000, 160, 120)
# Phase 8: (live splats, capacity, width, height, views, steps, steps with
# distortion). Capacity is the orchestrator's rule max(2n, n + 1024).
TRAIN_SHAPE = (1_200_000, 2_400_000, 512, 384, 5, 30, 5)
# The plain backward's (tiles, chunk, 256) working set on the card.
PLAIN_BWD_ELEMS = 1 << 22
MODES = {"infer": (False, True), "nodist": (True, False), "full": (True, True)}
FLOAT_MAPS = ("color", "normal", "depth_acc", "alpha", "distortion", "final_T",
              "m1_tot", "m2_tot")
GRAD_GROUPS = {"dT": slice(0, 9), "d_center": slice(9, 11), "d_opacity": slice(11, 12),
               "d_rgb": slice(12, 15), "d_normal": slice(15, 18)}
PARAMS = ("xyz", "scaling_raw", "rotation_raw", "opacity_raw", "f_dc", "f_rest")
# B3 vs its plain version: max|kernel - plain| <= B3_TOL * max|plain| (fp32
# sums taken in another order, exp2 instead of exp, 3xTF32 products).
B3_TOL = 1e-4
# The ±30-logit rows are graded against a float64 reference (attention64):
# max|kernel - ref64| <= max(B3_TOL * max|ref64|, B3_TOL64 * max|plain - ref64|).
# There (scores ~3000) the fp32 plain version itself lies 3.1e-4 * max from
# float64 at (2, 4096, 5, 64), so any other order of summation can move it by
# more than B3_TOL: against the plain version the gate would measure
# summation order, which any tensor-core kernel changes, not accuracy.
B3_TOL64 = 1.5
# Phase 10: (q shape, k/v shape, logit scale). First the main path's
# attention shapes at 512 px (9 frames of 64x64 latents, two branches):
# self-attention (2, 9*h*w, C/64, 64) and cross-attention (18, h*w, C/64, 64)
# against 77 context tokens at h*w = 4096, 1024, 256, 64; then odd shapes,
# D = 128 and extreme logits.
B3_SHAPES = (
    ((2, 36864, 5, 64), (2, 36864, 5, 64), 1.0),
    ((2, 9216, 10, 64), (2, 9216, 10, 64), 1.0),
    ((2, 2304, 20, 64), (2, 2304, 20, 64), 1.0),
    ((2, 576, 20, 64), (2, 576, 20, 64), 1.0),
    ((18, 4096, 5, 64), (18, 77, 5, 64), 1.0),
    ((18, 1024, 10, 64), (18, 77, 10, 64), 1.0),
    ((18, 256, 20, 64), (18, 77, 20, 64), 1.0),
    ((18, 64, 20, 64), (18, 77, 20, 64), 1.0),
    ((1, 50, 2, 16), (1, 33, 2, 16), 1.0),
    ((2, 1000, 3, 32), (2, 257, 3, 32), 1.0),
    ((1, 300, 2, 128), (1, 300, 2, 128), 1.0),
    ((2, 1000, 4, 128), (2, 257, 4, 128), 1.0),
    ((1, 130, 2, 16), (1, 130, 2, 16), 30.0),
    ((2, 4096, 5, 64), (2, 4096, 5, 64), 30.0),
)
# Printed, not gated: at D = 128 with ±30-scaled logits (scores of size
# ~3000) the two plain versions, dense and chunked, already differ by more
# than the gate, which is why the card tests hold extreme logits at D <= 64.
B3_ILL_CONDITIONED = ((2, 130, 3, 128), (2, 130, 3, 128), 30.0)
# The dense plain version's error is printed where its logits take at most
# this many elements.
DENSE_LOGITS_MAX = 1 << 28
# Phase 11: (reference views, warps, MVD resolution, DDIM steps). 4 steps on
# the trailing grid give 5 timesteps, so 5 UNet calls.
SEE3D_SHAPE = (4, 5, 512, 4)
# Full-width See3D priors: UNetConfig() and CLIP widths by default;
# a CPU rehearsal shrinks these.
SEE3D_MODELS = dict(unet={}, vae={}, clip_vision={}, clip_text={})
# The See3D stage with B3 against the same stage with plain attention:
# latents ||d|| / ||plain|| and images max|d|.
SEE3D_LAT_TOL = 1e-3
SEE3D_IMG_TOL = 2e-3

# Phase 13: the held-out views of evaluate() (the last two training views),
# and LPIPS on the card vs on the CPU with the same params (TF32 off).
LPIPS_REL = 1e-4
EVAL_KEYS = ["LPIPS-uncalibrated", "test_views_num", "Average-PSNR", "Average-SSIM",
             "Average-LPIPS", "PSNR", "SSIM", "LPIPS"]
# Phase 14: box_room's splat density (its default, 9000 per m² over 28.8 m²)
# and room_cameras(8, 512, 384), the training resolution; the multires
# extraction's lattice (PipelineConfig.tsdf_resolution).
MESH_DENSITY = 9000
MESH_VIEWS = (8, 512, 384)
MULTIRES_RESOLUTION = 128
# The first-pass TSDF from B1's maps against the plain version's: |d| <=
# TSDF_TOL at all but FLIP_FRAC of the tetra points (the rest sit on a pixel
# whose median or alpha crossing flipped).
TSDF_TOL = 1e-3
# The adaptive mesh against the GT mesh culled to the input views (cm): its
# completeness by evaluate_mesh's own threshold (Comp < CHAMFER_CM, recall at
# 5 cm > RECALL_MIN %), its accuracy by Acc and Chamfer-L1 within ADAPTIVE_BAND
# (relative) of the reading the extraction gives on this scene, ADAPTIVE_REF
# (an H100, deterministic from run to run). Those sit above 5 cm: the
# adaptive TSDF counts space no view observes as inside (-1, as the JAX
# package and the reference do), so marching puts surfaces in mid-air where
# observed free space meets unobserved space, and the JAX package reads the
# same as the port on a reduced room (tests/test_torch_mesh_room.py). Faults
# planted by scripts/mesh_faults.py (CPU, 3000 per m² at 256x192; sound Acc
# 11.66, Chamfer-L1 6.23) leave the band on both sides: the TSDF's sign
# flipped at 1 % of the points reads 16.48 / 8.64, views observing half their
# image 13.00 / 19.52, a binary search that keeps the wrong half pulls the
# vertices onto the tetra points, 3.95 / 2.38. The multires mesh drops faces
# at unobserved points: Chamfer-L1 < CHAMFER_CM.
CHAMFER_CM = 5.0
RECALL_MIN = 90.0
ADAPTIVE_REF = {"Acc": 11.62, "Chamfer-L1": 6.19}
ADAPTIVE_BAND = 0.1
# Phase 16: one See3D loop (run()'s order without SfM, charts, mesh and eval)
# on box_room(MESH_DENSITY) from inward_cameras(8, 512, 384): room_cameras'
# eyes sit at the open front, outside the space the views observe, where the
# stage-1 orbit proposes nothing. PipelineConfig() defaults save
# LOOP_ITERATIONS steps per train_gaussians (phase 8's cut) and phase 11's
# 5 DDIM timesteps; full-width See3D priors and DepthAnything("vitl").
LOOP_VIEWS = (8, 512, 384)
LOOP_ITERATIONS = 35
LOOP_DA2 = "vitl"
# Gate (i): stage 1's none-visible rates from B1's sweep vs its plain version's.
RATE_TOL = 1e-4
# Gate (ii): DA2 on the card vs the same module on the CPU, one inpainted view.
DA2_REL = 1e-3
# Phase 17: G4SplatPipeline.run() from posed photos: box_room(MESH_DENSITY)
# rendered by B1 from inward_cameras(10, 512, 384), the last two views held
# out, a calibrated source tree naming FRONT_DENSE in dense_view.json;
# MASt3RConfig() at full width.
FRONT_VIEWS = (10, 512, 384)
FRONT_EVAL = [8, 9]
FRONT_DENSE = [0, 2, 4, 6]
# Gate (i): MASt3R on the card vs on the CPU, and the matching crop (h, w).
MAST3R_REL = 1e-3
MATCH_CROP = (48, 64)
RESULT_KEYS = EVAL_KEYS[:5] + ["Acc", "Comp", "Chamfer-L1", "Prec", "Recal", "F-score",
                               "Normal-Acc", "Normal-Comp", "Normal-Consistency"]
# fp32 operations of one (point, view) step of ops/tsdf.integrate_views in the
# production options: projection 21, rounding and clamps 6, validity 11,
# bilinear depth 22, difference and truncation 7, weight and running mean 9,
# bilinear colour 33, colour mean 18.
TSDF_OPS_PER_POINT_VIEW = 127

failures = []
max_abs_err = 0.0
max_abs_err_bwd = 0.0


def check(ok, what):
    print(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def scene_arrays(n, seed, spread=3.0, wall=True, log_scale=(-4.5, -3.0)):
    """bench.py's room-like shell (walls/floor plus clutter), or with
    wall=False the uniform cube of scripts/check_pallas.py, as numpy arrays
    (xyz, colours, scales, quaternions)."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    if wall:
        xyz[rng.randint(0, 8, n) == 0, 2] = 3.0
    cols = rng.rand(n, 3).astype(np.float32)
    scales = np.exp(rng.uniform(*log_scale, n)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    return xyz, cols, scales, quats


def build_scene(n, seed, spread=3.0, wall=True, opacity=0.8, log_scale=(-4.5, -3.0),
                sh_degree=0):
    import torch

    from g4splat_torch.models.gaussians import GaussianScene

    xyz, cols, scales, quats = scene_arrays(n, seed, spread, wall, log_scale)
    scene = GaussianScene.from_points(xyz, cols, scales=scales, quats=quats,
                                      initial_opacity=opacity, device=DEVICE)
    if sh_degree:
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
        f_rest = 0.05 * torch.randn(scene.f_rest.shape, generator=gen, device=DEVICE)
        scene = scene.replace(f_rest=f_rest, active_sh_degree=sh_degree)
    return scene


def kernel_inputs(cam, scene):
    """The kernels' inputs for one frame: the binning and the splat table."""
    from g4splat_torch.ops.rasterize_common import RenderConfig, preprocess
    from g4splat_torch.ops.rasterize_cuda import splat_table
    from g4splat_torch.ops.rasterize_tiled import bin_splats

    prep = preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw, scene.opacity(),
                      scene.features(), scene.active_sh_degree, config=RenderConfig())
    b = bin_splats(prep, cam.width, cam.height)
    return b, splat_table(prep)


def compare_maps(tag, got, ref, quiet=False):
    """Grade the kernel's maps against the plain version's. Prints (unless
    quiet), per map, the largest |d| over all pixels and over the agreeing
    ones, the plain map's largest value, the share of pixels that disagree,
    and the share a map of zeros would get wrong (what the check can see).
    Returns the latter per map."""
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
    if not quiet:
        print("\n".join(lines))
    return seen


def kernel_vs_plain(tag, b, table, w, h, modes=MODES, quiet=False):
    """Run kernel and plain version on the same card tensors in each mode.
    Returns the last mode's compare_maps result and the last plain maps."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries, rasterize_entries_plain

    bg = torch.tensor([0.05, 0.1, 0.15], device=DEVICE)
    seen = ref = None
    for mode in modes:
        aux, dist = MODES[mode]
        got = rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count, bg, w, h,
                                want_aux=aux, want_dist=dist)
        ref = rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count, bg, w, h,
                                      want_aux=aux, want_dist=dist)
        torch.cuda.synchronize()
        seen = compare_maps(f"{tag} [{mode}]", got, ref, quiet)
    return seen, ref


def gathered_bitwise(tag, b, table, w, h, modes=MODES):
    """B1 reading rows through gauss_id against B1 on the rows gathered
    beforehand (table[gauss_id] with identity ids): every map bit-identical
    in each mode, since the data and the arithmetic are the same."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries

    bg = torch.tensor([0.05, 0.1, 0.15], device=DEVICE)
    rows = table[b.gauss_id.long()].contiguous()
    ids = torch.arange(rows.shape[0], dtype=torch.int32, device=DEVICE)
    for mode in modes:
        aux, dist = MODES[mode]
        got = rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count, bg, w, h,
                                want_aux=aux, want_dist=dist)
        ref = rasterize_entries(rows, ids, b.tile_start, b.tile_count, bg, w, h,
                                want_aux=aux, want_dist=dist)
        same = all(torch.equal(got[k], ref[k]) for k in got)
        check(same, f"{tag} [{mode}]: B1 through gauss_id is bitwise equal to B1 on the "
              f"gathered rows ({rows.shape[0]} entries)")


def histogram(x):
    """{"max", "mean", "p50", "p90", "p99", "over_2x_mean", "tiles"} of a
    per-tile count."""
    import torch

    x = x.to(torch.float64)
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                       device=x.device))
    mean = float(x.mean())
    return {"max": float(x.max()), "mean": mean, "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "over_2x_mean": int((x > 2 * mean).sum()), "tiles": x.numel()}


def format_histogram(hist):
    return ", ".join(f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in hist.items()) + f"; max/mean {hist['max'] / hist['mean']:.2f}"


def box_scan(table, gauss_id, tile_start, tile_count, limit, n_contrib, w, h):
    """A kernel's walk over these inputs, from the plain intersections: pixel
    p walks its tile's entries below limit[p] (B1: n_walked, up to where it
    stops; B2: n_contrib), and its contributors (alpha >= 1/255) lie below
    n_contrib[p]. Over the (warp, entry) steps of each tile's walk, up to its
    deepest pixel's limit, it counts: walked (8 warps per entry), live (a
    lane below its limit), contributing (a contributing lane) and skipped
    (live, but the entry's reach box, rasterize_cuda_bwd.reach_boxes, misses
    the warp's 16x2 pixels). Over the (pixel, entry) pairs below the limit:
    pairs, needed (those of the steps the boxes leave) and outside (alpha >=
    1/255 outside the entry's box: a warp that skipped it would change T for
    everything behind it). Returns the counts and each tile's walk length."""
    import torch

    from g4splat_torch.ops.rasterize_common import TILE, alpha_depth, conic_center
    from g4splat_torch.ops.rasterize_cuda_bwd import reach_boxes
    from g4splat_torch.ops.rasterize_tiled import disassemble_tiles

    gx = -(-w // TILE)
    lim_t = disassemble_tiles(limit, w, h).long()                    # (n_tiles, 256)
    nc_t = disassemble_tiles(n_contrib, w, h).long()
    lens = torch.minimum(lim_t.amax(1), tile_count.long())
    box = reach_boxes(table)
    T_all = table[:, :9].reshape(-1, 3, 3)
    center, _, ok = conic_center(T_all)
    center = torch.where(ok[:, None], center, 0.0)
    gid = gauss_id.long()
    lin = torch.arange(256, device=table.device)
    n = dict(walked=0, live=0, contributing=0, skipped=0, pairs=0, needed=0, outside=0)
    live_tiles = torch.nonzero(lens > 0).flatten()
    K = 64
    for b0 in range(0, live_tiles.numel(), 64):
        t = live_tiles[b0:b0 + 64]
        nb = t.numel()
        px = ((t % gx) * TILE)[:, None] + (lin % TILE)                # (nb, 256)
        py = ((t // gx) * TILE)[:, None] + (lin // TILE)
        for lo in range(0, int(lens[t].max()), K):
            pos = torch.arange(lo, lo + K, device=table.device)
            inside = pos[None, :] < lens[t][:, None]                   # (nb, K)
            rows = gid[torch.clamp(tile_start[t].long()[:, None] + pos, max=gid.numel() - 1)]
            alpha, _ = alpha_depth(T_all[rows], center[rows], table[rows, 9], inside,
                                   px.float(), py.float())             # (nb, K, 256)
            walking = (pos[None, :, None] < lim_t[t][:, None, :]) & inside[..., None]
            contrib = (alpha > 0) & (pos[None, :, None] < nc_t[t][:, None, :])
            bx = box[rows]
            pxd, pyd = px[:, None, :].double(), py[:, None, :].double()
            in_box = ((pxd >= bx[..., 0:1]) & (pxd <= bx[..., 1:2])
                      & (pyd >= bx[..., 2:3]) & (pyd <= bx[..., 3:4]))
            wx = px.view(nb, 8, 32)[..., 0][:, None].double()
            wy = py.view(nb, 8, 32)[..., 0][:, None].double()
            reach = ((bx[..., 0:1] <= wx + 15) & (bx[..., 1:2] >= wx)
                     & (bx[..., 2:3] <= wy + 1) & (bx[..., 3:4] >= wy))  # (nb, K, 8)
            lanes = walking.view(nb, K, 8, 32)
            live = lanes.any(-1)
            n["walked"] += int(inside.sum()) * 8
            n["live"] += int(live.sum())
            n["contributing"] += int(contrib.view(nb, K, 8, 32).any(-1).sum())
            n["skipped"] += int((live & ~reach).sum())
            n["pairs"] += int(walking.sum())
            n["needed"] += int((lanes & reach[..., None]).sum())
            n["outside"] += int(((alpha > 0) & walking & ~in_box).sum())
    return n, lens


def fwd_activity(tag, b, table, maps, w, h):
    """B1's walk on these inputs (box_scan), from its plain version's maps (a
    run with want_aux=True: n_walked and n_contrib). Checks that no pair a
    pixel walks with alpha >= 1/255 (a contributor, or the entry that stops
    the pixel) lies outside its entry's box. Returns the counts, with the
    entries the tiles read ("reads"), and the per-tile read histogram."""
    n, reads = box_scan(table, b.gauss_id, b.tile_start, b.tile_count, maps["n_walked"],
                        maps["n_contrib"], w, h)
    n["reads"] = int(reads.sum())
    check(n["outside"] == 0, f"{tag}: every walked pair with alpha >= 1/255 lies inside its "
          f"entry's reach box ({n['outside']} outside)")
    print(f"  {tag}: B1 (warp, entry) steps walked {n['walked']}, with a lane still walking "
          f"{n['live']} ({100 * n['live'] / max(n['walked'], 1):.1f} %), with a contributing "
          f"lane {n['contributing']} ({100 * n['contributing'] / max(n['walked'], 1):.1f} %), "
          f"still walking but outside the entry's reach box {n['skipped']} "
          f"({100 * n['skipped'] / max(n['live'], 1):.1f} % of those still walking); "
          f"(pixel, entry) pairs walked {n['pairs']}, of them in steps the boxes leave "
          f"{n['needed']}")
    return n, histogram(reads)


def plain_walk(b, table, w, h):
    """B1's plain version in mode want_aux=True, no distortion: the maps
    fwd_activity reads (n_walked, n_contrib)."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries_plain

    return rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                   torch.zeros(3, device=DEVICE), w, h, want_dist=False)


def print_b1_walk(tag, act, b, modes=MODES):
    """B1's per-tile reads and reach-box skip share (from fwd_activity), and
    each mode's kernel: registers, spills, resident blocks per SM and the
    waves its grid of one block per tile takes."""
    from g4splat_torch.ops import rasterize_cuda

    n, hist = act
    print(f"  {tag}: B1 reads per tile {format_histogram(hist)}; reach boxes skip "
          f"{100 * n['skipped'] / max(n['live'], 1):.1f} % of the (warp, entry) steps with a "
          f"lane still walking")
    for mode in modes:
        info = rasterize_cuda.kernel_info(*MODES[mode])
        slots = info["blocks_per_sm"] * info["sms"]
        print(f"  {tag}: B1 [{mode}] {info['registers']} registers, {info['spill_bytes']} B "
              f"spilled, {info['shared_bytes']} B shared, {info['blocks_per_sm']} blocks per SM "
              f"on {info['sms']} SMs: {b.tile_count.numel()} tiles take "
              f"{b.tile_count.numel() / max(slots, 1):.2f} waves")


def walk_histogram(args):
    """B2's per-tile walk lengths on its inputs `args`, min(deepest n_contrib
    in the tile, tile count), as {"max", "mean", "p50", "p90", "p99",
    "over_2x_mean", "tiles"}."""
    from g4splat_torch.ops.rasterize_cuda_bwd import tile_walks

    return histogram(tile_walks(args[4], args[3], args[7], args[8]))


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
    written once, against the fp32 operations on `pairs` (pixel, entry)
    pairs. Returns (ms, 'bytes' | 'operations')."""
    from g4splat_torch.ops.rasterize_cuda import ENTRY_F, OPS_PER_PAIR, OUT_BYTES_PER_PIXEL

    nbytes = n_read * ENTRY_F * 4 + n_tiles * 8 + 12 + w * h * OUT_BYTES_PER_PIXEL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * OPS_PER_PAIR / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_bound(tag, n, n_tiles, w, h):
    """B1's bound on the work these inputs need (fwd_activity's counts `n`):
    the pairs the reach boxes leave, since every skipped one has alpha below
    1/255. Prints it beside the bound over every pair walked. Returns (ms,
    'bytes' | 'operations')."""
    bound, by = kernel_bound(n["reads"], n_tiles, w, h, n["needed"])
    walked, _ = kernel_bound(n["reads"], n_tiles, w, h, n["pairs"])
    print(f"  {tag}: B1 bound {bound:.4f} ms ({by}) over the {n['needed']} pairs the reach "
          f"boxes leave; {walked:.4f} ms over every pair walked ({n['pairs']})")
    return bound, by


def time_kernel(tag, b, table, w, h, act, modes):
    """Kernel and plain-version ms per mode at this shape, beside the bound
    (b1_bound of fwd_activity's counts `act`)."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries, rasterize_entries_plain

    bg = torch.zeros(3, device=DEVICE)
    rows = {}
    bound, bound_by = b1_bound(tag, act, b.tile_count.numel(), w, h)
    for mode in modes:
        aux, dist = MODES[mode]
        args = (table, b.gauss_id, b.tile_start, b.tile_count, bg, w, h)
        k_ms = cuda_ms(lambda: rasterize_entries(*args, want_aux=aux, want_dist=dist))
        p_ms = cuda_ms(lambda: rasterize_entries_plain(*args, want_aux=aux, want_dist=dist),
                       reps=1, warmup=0)   # warm: it just ran in phase 3-5
        rows[mode] = (k_ms, p_ms)
        print(f"  {tag} [{mode}] kernel {k_ms:.4f} ms  plain {p_ms:.2f} ms  bound "
              f"{bound:.4f} ms ({bound_by})  entries {b.gauss_id.numel()}, read {act['reads']}")
    return rows, bound, bound_by


def time_render(tag, cam, scene, cfg, need_aux, reps=5):
    """Whole render() ms (host clock, synchronized), then its stages run in
    turn by the functions render() calls, each timed by CUDA events from the
    end of the one before (device time, host gaps included)."""
    import torch

    from g4splat_torch.ops.rasterize import postprocess, render
    from g4splat_torch.ops.rasterize_common import preprocess
    from g4splat_torch.ops.rasterize_cuda import rasterize_entries, splat_table
    from g4splat_torch.ops.rasterize_tiled import bin_splats

    W, H = cam.width, cam.height
    bg = torch.as_tensor(cfg.bg, dtype=torch.float32).to(DEVICE)
    stages = ("preprocess", "bin", "table", "kernel", "post")
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
        table = splat_table(prep)
        ev[3].record()
        maps = rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count, bg, W, H,
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


def bwd_inputs(b, table, w, h, want_dist, seed):
    """B1's saved aux (the kernel in mode want_aux=True) and a seeded random
    cotangent image, as the autograd Function hands them to B2."""
    import torch

    from g4splat_torch.ops.rasterize_cuda import rasterize_entries
    from g4splat_torch.ops.rasterize_cuda_bwd import COT_C

    bg = torch.tensor([0.05, 0.1, 0.15], device=DEVICE)
    maps = rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count, bg, w, h,
                             want_aux=True, want_dist=want_dist)
    aux = torch.stack([maps["final_T"], maps["n_contrib"].to(torch.float32),
                       maps["m1_tot"], maps["m2_tot"]], -1)
    cot = np.random.RandomState(seed).randn(h, w, COT_C).astype(np.float32)
    cot[..., 10:] = 0.0
    return (table, b.gauss_id, b.tile_start, b.tile_count, aux,
            torch.from_numpy(cot).to(DEVICE), bg, w, h)


def bwd_vs_plain(tag, b, table, w, h, seed=0):
    """B2 and its plain version on the same card tensors, in both modes.
    Returns {want_dist: (kernel args, the plain version's work stats)}."""
    global max_abs_err_bwd
    import torch

    from g4splat_torch.ops.rasterize_cuda_bwd import (
        rasterize_backward,
        rasterize_backward_plain,
    )

    runs = {}
    for want_dist in (False, True):
        args = bwd_inputs(b, table, w, h, want_dist, seed)
        got = rasterize_backward(*args, want_dist=want_dist)
        stats = {}
        ref = rasterize_backward_plain(*args, want_dist=want_dist,
                                       max_elems=PLAIN_BWD_ELEMS, stats=stats)
        torch.cuda.synchronize()
        max_abs_err_bwd = max(max_abs_err_bwd, float((got - ref).abs().max()))
        errs = []
        for name, sl in GRAD_GROUPS.items():
            norm = float(ref[:, sl].norm())
            r = float((got[:, sl] - ref[:, sl]).norm()) / max(norm, 1e-30)
            errs.append(f"{name} {r:.2e} (|plain| {norm:.2e})")
            check(norm > 0 and r <= GRAD_TOL,
                  f"{tag} B2 [{'full' if want_dist else 'nodist'}] {name}: "
                  f"||kernel - plain|| / ||plain|| = {r:.2e} <= {GRAD_TOL}, ||plain|| > 0")
        print(f"      {'; '.join(errs)}; max|d| {float((got - ref).abs().max()):.2e}; "
              f"pairs {stats['pairs']}, contributors {stats['contributors']}, "
              f"rows walked {stats['rows']}, splats {stats['splats']}")
        runs[want_dist] = (args, stats)
    return runs


def bwd_bound(stats, w, h, n_tiles, want_dist):
    """Least time for B2's work on this run's data: the entry rows (and ids)
    the tiles walk, the tile ranges, aux, cotangents and bg read once and the
    touched splats' gradient rows read-modified-written, against the fp32
    operations on the pairs walked and the contributors. Returns
    (ms, 'bytes' | 'operations')."""
    from g4splat_torch.ops.rasterize_cuda import ENTRY_F
    from g4splat_torch.ops.rasterize_cuda_bwd import (
        AUX_C,
        COT_C,
        GRAD_F,
        OPS_PER_CONTRIB_BWD,
        OPS_PER_CONTRIB_DIST,
        OPS_PER_PAIR_BWD,
    )

    nbytes = (stats["rows"] * (ENTRY_F * 4 + 4) + n_tiles * 8 + w * h * (AUX_C + COT_C) * 4
              + 12 + stats["splats"] * GRAD_F * 4 * 2)
    ops = stats["pairs"] * OPS_PER_PAIR_BWD + stats["contributors"] * (
        OPS_PER_CONTRIB_BWD + (OPS_PER_CONTRIB_DIST if want_dist else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_activity(tag, args):
    """B2's walk on its inputs `args` (box_scan up to each pixel's n_contrib).
    Checks that no contributing (entry, pixel) pair lies outside its entry's
    box: the box lets a warp skip an entry, and a skipped contributor would
    corrupt its pixel's walk without a trace. Returns the counts."""
    table, gid, tile_start, tile_count, aux, cot, bg, w, h = args
    n, _ = box_scan(table, gid, tile_start, tile_count, aux[..., 1], aux[..., 1], w, h)
    check(n["outside"] == 0, f"{tag}: every contributing (entry, pixel) pair lies inside the "
          f"entry's reach box ({n['outside']} outside)")
    print(f"  {tag}: (warp, entry) steps walked {n['walked']}, with a lane inside n_contrib "
          f"{n['live']}, with a contributing lane {n['contributing']}, skipped by the reach "
          f"boxes {n['skipped']} ({100 * n['skipped'] / max(n['live'], 1):.1f} % of the active)")
    return n


def b2_ms(args, want_dist, reps=10):
    """B2's whole backward call (rasterize_backward: the gradient buffer,
    tile walks, tile order and walk), timed by CUDA events."""
    from g4splat_torch.ops import rasterize_cuda_bwd as bwd

    return cuda_ms(lambda: bwd.rasterize_backward(*args, want_dist=want_dist), reps=reps)


def print_b2_times(tag, runs, w, h, n_tiles):
    """B2's times in both modes beside its bound."""
    for want_dist, (args, stats) in runs.items():
        bound, by = bwd_bound(stats, w, h, n_tiles, want_dist)
        print(f"  {tag} B2 [{'full' if want_dist else 'nodist'}] {b2_ms(args, want_dist):.4f} "
              f"ms; bound {bound:.4f} ms ({by})")


def worklist_vs_plain(tag, args, want_dist):
    """B2's work list against its plain version on the same card tensors: the
    tile walks equal, and the tiles taken in the buckets of tile_order_plain
    (the order within a bucket varies with the atomics)."""
    import torch

    from g4splat_torch.ops import rasterize_cuda_bwd as bwd

    n_tiles = args[3].numel()
    grad = torch.zeros((args[0].shape[0], bwd.GRAD_F), device=DEVICE)
    got = bwd.worklist(bwd.launch_backward(args, grad, want_dist=want_dist), n_tiles)
    walk = bwd.tile_walks(args[4], args[3], args[7], args[8])
    ref = bwd.tile_order_plain(walk)
    bucket = bwd.walk_buckets(walk)
    same = (torch.equal(got["walk"].long(), walk)
            and torch.equal(torch.sort(got["order"])[0], torch.sort(ref)[0])
            and torch.equal(bucket[got["order"].long()], bucket[ref.long()]))
    check(same, f"{tag} B2 [{'full' if want_dist else 'nodist'}] work list (tile walks, "
          f"{ref.numel()} of {n_tiles} tiles longest first by {bwd.NBUCKET} buckets) equals "
          f"its plain version")


def chain_gradients():
    """render(backend="cuda") vs render(backend="tiled") gradients on the
    card, every scene parameter and the screen-space offset; B1 and B2 each
    launch once per cuda backward."""
    import torch

    from g4splat_torch.core.cameras import lookat_camera
    from g4splat_torch.ops import rasterize_cuda, rasterize_cuda_bwd
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.ops.rasterize_common import RenderConfig

    n, w, h = CHAIN_SHAPE
    scene = build_scene(n, 5, spread=1.0, wall=False, opacity=0.6, log_scale=(-3.5, -2.2),
                        sh_degree=3)
    cam = lookat_camera([0, 0, -3.0], [0, 0, 0], [0, -1, 0], fx=120.0, fy=120.0,
                        width=w, height=h, device=DEVICE)
    for dist in (False, True):
        cfg = RenderConfig(bg=(0.05, 0.1, 0.15), compute_distortion=dist, tile_k=4096)
        keys = ("render", "rend_alpha", "rend_normal", "rend_depth", "depth_median",
                "surf_normal") + (("rend_dist",) if dist else ())
        weights, grads = {}, {}
        for backend in ("tiled", "cuda"):
            params = {k: getattr(scene, k).clone().requires_grad_(True) for k in PARAMS}
            off = torch.zeros((n, 2), device=DEVICE, requires_grad=True)
            before = (rasterize_cuda.RASTERIZE_FWD.launches,
                      rasterize_cuda_bwd.RASTERIZE_BWD.launches)
            out = render(cam, scene.replace(**params), cfg, center_offset=off, backend=backend)
            for k in keys:
                gen = torch.Generator(device=DEVICE).manual_seed(len(weights))
                weights.setdefault(k, torch.randn(out[k].shape, device=DEVICE, generator=gen))
            sum((out[k] * weights[k]).sum() for k in keys).backward()
            torch.cuda.synchronize()
            after = (rasterize_cuda.RASTERIZE_FWD.launches,
                     rasterize_cuda_bwd.RASTERIZE_BWD.launches)
            if backend == "cuda":
                check(after == (before[0] + 1, before[1] + 1),
                      f"cuda backward launched B1 {after[0] - before[0]} and B2 "
                      f"{after[1] - before[1]} times (1 and 1 expected)")
            else:
                check(after == before, "tiled backward launched no kernel")
            grads[backend] = {**{k: p.grad for k, p in params.items()},
                              "center_offset": off.grad}
        line = []
        for k, ref in grads["tiled"].items():
            r = float((grads["cuda"][k] - ref).norm() / ref.norm())
            line.append(f"{k} {r:.2e}")
            check(float(ref.norm()) > 0 and r <= CHAIN_TOL,
                  f"chain [{'full' if dist else 'nodist'}] {k}: ||cuda - tiled|| / "
                  f"||tiled|| = {r:.2e} <= {CHAIN_TOL}")
        print(f"      [{'full' if dist else 'nodist'}] " + "; ".join(line))


def training_data(n_live, capacity, w, h, n_views):
    """tests/test_train.py's synthetic problem at full width: a seeded
    room-like scene (SH 3) rendered by B1 from `n_views` cameras gives the
    images and the depth/normal priors; the init is the same points jittered
    with grey colours, in a `capacity`-slot buffer."""
    import torch

    from g4splat_torch.core.cameras import lookat_camera, stack_cameras
    from g4splat_torch.models.gaussians import GaussianScene
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.train.trainer import ViewData

    xyz, cols, scales, quats = scene_arrays(n_live, 11)
    gt = GaussianScene.from_points(xyz, cols, scales=scales, quats=quats,
                                   initial_opacity=0.8, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    gt = gt.replace(f_rest=0.05 * torch.randn(gt.f_rest.shape, generator=gen, device=DEVICE),
                    active_sh_degree=3)
    cams = [lookat_camera([6.5 * np.sin(a), -0.8, -6.5 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                          fx=600.0 * w / 768, fy=600.0 * w / 768, width=w, height=h,
                          device=DEVICE)
            for a in (np.arange(n_views) - n_views // 2) * 0.2]
    with torch.no_grad():
        outs = [render(c, gt, backend="cuda") for c in cams]
    views = ViewData(
        image=torch.stack([o["render"] for o in outs]),
        prior_depth=torch.stack([o["surf_depth"] for o in outs]),
        prior_normal=torch.stack([o["rend_normal"] for o in outs]),
        prior_curv=torch.zeros((n_views, h, w), device=DEVICE),
        confidence=torch.ones((n_views, h, w), device=DEVICE),
        color_weight=torch.ones(n_views, device=DEVICE),
        scale_factor=torch.tensor(10.0, device=DEVICE))
    rng = np.random.RandomState(13)
    init = GaussianScene.from_points(
        xyz + 0.03 * rng.randn(*xyz.shape).astype(np.float32),
        np.full((n_live, 3), 0.5, np.float32), capacity=capacity, scales=scales,
        quats=quats, initial_opacity=0.5, device=DEVICE)
    return init.replace(active_sh_degree=3), stack_cameras(cams), views


def timed_step(trainer, events=True):
    """One training step run stage by stage with the functions train_step
    calls (render and the losses, backward, Adam with the stat accumulation),
    each timed by CUDA events from the end of the one before, with TF32 off
    as train_step runs. Returns {stage: ms}."""
    import torch

    from g4splat_torch.device import fp32_math
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.ops.rasterize_common import RenderConfig
    from g4splat_torch.train.densify import accumulate_stats
    from g4splat_torch.train.trainer import adam_step, losses_from_render

    cfg = trainer.cfg
    trainer.iteration += 1
    it = trainer.iteration
    cam, view = trainer._view_slice(trainer._next_view())
    scene = trainer.scene
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    with fp32_math():
        ev[0].record()
        offset = torch.zeros((scene.capacity, 2), device=DEVICE, requires_grad=True)
        out = render(cam, scene, RenderConfig(bg=(0.0, 0.0, 0.0), depth_ratio=cfg.depth_ratio,
                                              compute_distortion=cfg.lambda_dist != 0.0,
                                              max_tiles_per_splat=cfg.raster_max_tiles_per_splat),
                     center_offset=offset, backend=cfg.backend)
        ev[1].record()
        loss, aux = losses_from_render(scene, out, view, cfg, it, generator=trainer.generator)
        ev[2].record()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        adam_step(trainer.optimizer, cfg)
        trainer.dstate = accumulate_stats(trainer.dstate, offset.grad, aux["radii"],
                                          aux["visibility"])
        ev[4].record()
    torch.cuda.synchronize()
    names = ("forward render", "losses", "backward", "Adam + stats")
    return {k: a.elapsed_time(b) for k, a, b in zip(names, ev, ev[1:])}


def b3_bound(qs, ks):
    """Least time for B3's work on these shapes: q, k, v read once and the
    output written once, against the arithmetic of the route B3 takes. For
    head widths on the tensor cores that is the larger of TF32_PRODUCTS · 4 ·
    B·H·N·M·D TF32 operations (the 3xTF32 split) and B·H·N·M exp2 on the
    SFUs; for the others 4·B·H·N·M·D fp32 operations on the CUDA cores.
    Returns (ms, 'bytes' | 'operations', what binds it, the CUDA-core fp32
    bound in ms)."""
    from g4splat_torch.ops.attention_cuda import (FLOPS_PER_PAIR_PER_DIM, TC_HEAD_DIMS,
                                                  TF32_PRODUCTS)

    B, N, H, D = qs
    M = ks[1]
    ops = FLOPS_PER_PAIR_PER_DIM * B * H * N * M * D
    t_fp32 = ops / FP32_OPS_PER_S * 1e3
    t_bytes = 4 * (2 * B * N * H * D + 2 * B * M * H * D) / HBM_BYTES_PER_S * 1e3
    if D in TC_HEAD_DIMS:
        t_ops, what = max((TF32_PRODUCTS * ops / TF32_OPS_PER_S * 1e3, "tensor cores, 3xTF32"),
                          (B * H * N * M / EXP2_PER_S * 1e3, "exp2 on the SFUs"))
    else:
        t_ops, what = t_fp32, "fp32 on the CUDA cores"
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "bytes", t_fp32
    return t_ops, "operations", what, t_fp32


def sass_check():
    """Tensor-core instructions per kernel function in each built library
    (cuobjdump -sass); B3's D = 64 kernel (attention_fwd_tc) must hold
    wgmma's."""
    from g4splat_torch.ops import cuda_build

    b3_64 = []
    for name in cuda_build.SOURCES:
        for fn, c in cuda_build.sass_mma_counts(name).items():
            print(f"  [{name}] SASS {fn}: HMMA {c['HMMA']}, HGMMA {c['HGMMA']}")
            if "attention_fwd_tc" in fn:
                b3_64.append(c["HGMMA"])
    check(len(b3_64) == 1 and b3_64[0] > 0,
          f"B3's D = 64 kernel holds wgmma instructions (HGMMA {b3_64})")


def attention64(q, k, v):
    """softmax(QKᵀ/√D)V in float64 on the card, (B, N, H, D): the accuracy
    reference of the ±30-logit rows (not a port function)."""
    import torch

    s = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) / q.shape[-1] ** 0.5
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.double())


def b3_main_launches(cfg, frames, lat, n_calls, n_ctx=77):
    """{(q shape, keys): B3 launches} on the See3D main path, from the UNet's layout:
    each transformer block makes one self-attention over the 2 branches'
    frames jointly and one cross-attention per frame, at its level's
    latent size."""
    out = {}
    last = len(cfg.channel_mult) - 1
    for i, mult in enumerate(cfg.channel_mult):
        ds = 2 ** i
        blocks = cfg.transformer_depth * (
            (2 * cfg.num_res_blocks + 1 if ds in cfg.attention_resolutions else 0)
            + (1 if i == last else 0))
        if not blocks:
            continue
        heads, dh = cfg.heads_for(cfg.model_channels * mult)
        hw = (lat // ds) ** 2
        for key in (((2, frames * hw, heads, dh), frames * hw),
                    ((2 * frames, hw, heads, dh), n_ctx)):
            out[key] = out.get(key, 0) + blocks * n_calls
    return out


def sdpa_backend(q, k, v):
    """The backend F.scaled_dot_product_attention picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({e})"


def attention_vs_plain(main_launches):
    """Phase 10: B3 against chunked_attention on the same card tensors at
    every B3_SHAPES entry (the ±30-logit rows against a float64 reference,
    B3_TOL64); times B3, the plain version and SDPA (the yardstick, never
    called by the port). `main_launches` maps (q shape, keys) to the main
    path's launches. Returns {shape entry: (B3 ms, plain ms, SDPA ms, bound
    ms, bound_by)} and the largest graded error."""
    import torch
    import torch.nn.functional as F

    from g4splat_torch.device import fp32_math
    from g4splat_torch.ops.attention import (chunked_attention, dot_product_attention_plain,
                                             memory_efficient_attention)

    gen = torch.Generator(device=DEVICE).manual_seed(21)

    def draw(qs, ks, scale):
        return (scale * torch.randn(qs, device=DEVICE, generator=gen),
                scale * torch.randn(ks, device=DEVICE, generator=gen),
                torch.randn(ks, device=DEVICE, generator=gen))

    def errors(q, k, v):
        """(B3 output, chunked plain output, max|B3 - plain|, max|dense plain
        - plain| or None where the dense logits do not fit)."""
        got = memory_efficient_attention(q, k, v)
        ref = chunked_attention(q, k, v)
        dense = None
        if q.shape[0] * q.shape[1] * q.shape[2] * k.shape[1] <= DENSE_LOGITS_MAX:
            dense = float((dot_product_attention_plain(q, k, v) - ref).abs().max())
        torch.cuda.synchronize()
        return got, ref, float((got - ref).abs().max()), dense

    def dense_note(dense):
        return "not run (logits too large)" if dense is None else f"{dense:.2e}"

    rows, worst = {}, 0.0
    with fp32_math():
        for qs, ks, scale in B3_SHAPES:
            q, k, v = draw(qs, ks, scale)
            got, ref, err, dense = errors(q, k, v)
            top = float(ref.abs().max())
            finite = bool(torch.isfinite(got).all())
            if scale == 1.0:
                worst = max(worst, err)
                check(finite and err <= B3_TOL * top,
                      f"B3 {qs} x {ks[1]} keys, logits x{scale:g}: max|kernel - plain| {err:.2e} "
                      f"<= {B3_TOL} * max|plain| {top:.3e}; max|dense plain - plain| "
                      + dense_note(dense))
            else:
                r64 = attention64(q, k, v)
                e64 = float((got - r64).abs().max())
                p64 = float((ref - r64).abs().max())
                tol = max(B3_TOL * float(r64.abs().max()), B3_TOL64 * p64)
                worst = max(worst, e64)
                check(finite and e64 <= tol,
                      f"B3 {qs} x {ks[1]} keys, logits x{scale:g}: max|kernel - ref64| {e64:.2e} "
                      f"<= max({B3_TOL} * max|ref64|, {B3_TOL64} * max|plain - ref64| {p64:.2e}) "
                      f"= {tol:.2e}; beside it max|kernel - plain| {err:.2e} against "
                      f"{B3_TOL} * max|plain| = {B3_TOL * top:.2e}, max|dense plain - plain| "
                      + dense_note(dense))
                del r64
            k_ms = cuda_ms(lambda: memory_efficient_attention(q, k, v), reps=3, warmup=1)
            p_ms = cuda_ms(lambda: chunked_attention(q, k, v), reps=1, warmup=0)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # (B, H, tokens, D)
            l_err = float((F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2) - ref)
                          .abs().max())
            l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=3, warmup=1)
            bound, by, what, fp32_bound = b3_bound(qs, ks)
            rows[(qs, ks, scale)] = (k_ms, p_ms, l_ms, bound, by)
            print(f"      B3 {k_ms:.4f} ms  plain {p_ms:.3f} ms  SDPA {l_ms:.4f} ms "
                  f"({sdpa_backend(qt, kt, vt)}, max|SDPA - plain| {l_err:.2e})  bound "
                  f"{bound:.4f} ms ({what}), B3 at {100 * bound / k_ms:.1f} % of it; CUDA-core "
                  f"fp32 bound {fp32_bound:.4f} ms; main-path launches "
                  f"{main_launches.get((qs, ks[1]), 0) if scale == 1.0 else 0}")
        qs, ks, scale = B3_ILL_CONDITIONED
        q, k, v = draw(qs, ks, scale)
        got, ref, err, dense = errors(q, k, v)
        r64 = attention64(q, k, v)
        d64 = float((dot_product_attention_plain(q, k, v) - r64).abs().max())
        print(f"  not gated, {qs} x {ks[1]} keys, logits x{scale:g}: max|kernel - plain| "
              f"{err:.2e}, max|dense plain - plain| {dense:.2e}, against a gate of "
              f"{B3_TOL * float(ref.abs().max()):.2e}; from float64: kernel "
              f"{float((got - r64).abs().max()):.2e}, chunked plain "
              f"{float((ref - r64).abs().max()):.2e}, dense plain {d64:.2e} "
              f"(max|ref64| {float(r64.abs().max()):.3e})")
    return rows, worst


def see3d_priors(seed, n_steps):
    """Full-width See3D priors with seeded random weights, built on the card:
    the MV-UNet (its zero-init layers re-drawn from a seeded normal, so every
    transformer's output reaches the result), the VAE and both CLIP towers.
    Returns (Priors, layers re-drawn)."""
    import torch

    from g4splat_torch.pipeline.orchestrator import Priors
    from g4splat_torch.priors.clip_text import CLIPText, CLIPTextEmbedder
    from g4splat_torch.priors.clip_vision import CLIPImageEmbedder, CLIPVision
    from g4splat_torch.priors.see3d import DDIMConfig, MultiViewUNet, See3DPipeline, UNetConfig
    from g4splat_torch.priors.vae import AutoencoderKL

    torch.manual_seed(seed)
    with torch.device(DEVICE):
        unet = MultiViewUNet(UNetConfig(**SEE3D_MODELS["unet"])).eval()
        vae = AutoencoderKL(**SEE3D_MODELS["vae"]).eval()
        cv = CLIPVision(**SEE3D_MODELS["clip_vision"]).eval()
        ct = CLIPText(**SEE3D_MODELS["clip_text"]).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    redrawn = 0
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith(("proj_out.weight", "out_layers.3.weight", "out.2.weight")):
                p.normal_(0.0, 0.5 / p[0].numel() ** 0.5, generator=gen)
                redrawn += 1
    n_params = sum(p.numel() for m in (unet, vae, cv, ct) for p in m.parameters())
    print(f"  priors: {n_params / 1e6:.1f}M parameters (UNet "
          f"{sum(p.numel() for p in unet.parameters()) / 1e6:.1f}M); {redrawn} zero-init "
          f"layers re-drawn")
    return Priors(see3d=See3DPipeline(unet, DDIMConfig(num_steps=n_steps)), vae=vae,
                  image_embedder=CLIPImageEmbedder(cv), text_embedder=CLIPTextEmbedder(ct))


def see3d_inputs(scene, n_ref, n_warp, res):
    """Reference images and warps rendered by B1 at res x res from orbit
    cameras around `scene`, and the warps' masks (rend_alpha > 0.5, standing
    in for the novel-view visibility mask)."""
    import torch

    from g4splat_torch.core.cameras import lookat_camera
    from g4splat_torch.ops.rasterize import render

    cams = [lookat_camera([6.5 * np.sin(a), -0.8, -6.5 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                          fx=600.0 * res / 768, fy=600.0 * res / 768, width=res, height=res,
                          device=DEVICE)
            for a in np.linspace(0, 2 * np.pi, n_ref + n_warp, endpoint=False)]
    with torch.no_grad():
        outs = [render(c, scene, backend="cuda", need_aux=False) for c in cams]
    images = [torch.clamp(o["render"], 0.0, 1.0) for o in outs]
    masks = [(o["rend_alpha"] > 0.5).to(torch.float32) for o in outs[n_ref:]]
    return torch.stack(images[:n_ref]), images[n_ref:], masks


def profile_unet_call(call, top=8):
    """One UNet call under torch.profiler: device time by kernel (the top
    `top`, and B3's share), and the device's busy share of the call's wall
    time (CUDA events). A diagnostic: prints "not measured" if the profiler
    records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    torch.cuda.synchronize()
    try:
        with profile(activities=activities) as prof:
            ev[0].record()
            call()
            ev[1].record()
            ev[1].synchronize()
    except RuntimeError as e:      # a diagnostic only: the checks do not read it
        print(f"  UNet call profile: torch.profiler failed ({e}); not measured")
        return
    wall = ev[0].elapsed_time(ev[1])
    # Device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched.
    rows = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  reverse=True)
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows)
    if not busy:
        print("  UNet call profile: no device time recorded (not measured)")
        return
    b3 = sum(r[0] for r in rows if "attention_fwd" in r[2])
    print(f"  UNet call profile (torch.profiler): wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} %); B3 {b3:.1f} ms "
          f"({100 * b3 / busy:.1f} % of device time)")
    for t, n, key in rows[:top]:
        print(f"      {t:9.2f} ms  x{n:<4d} {key[:110]}")


def see3d_split(priors, refs, warps, masks, n_ref, reps=3):
    """Phase 12: the stage's parts run in turn by the functions
    run_see3d_inpaint calls, each between CUDA events: the CLIP towers, the
    VAE encode of every frame, UNet calls at the stage's shape (mean of
    `reps`), the DDIM loop with B3 and with plain attention, the VAE decode,
    with TF32 off as run_see3d_inpaint runs them. Returns ({part: ms},
    latents with B3, latents with plain attention)."""
    import torch

    from g4splat_torch.device import fp32_math
    from g4splat_torch.ops.attention import chunked_attention

    pipe, vae = priors.see3d, priors.vae
    ms = {}

    def timed(name, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        ms[name] = ev[0].elapsed_time(ev[1])
        return out

    with torch.no_grad(), fp32_math():
        ctx_img = timed("CLIP image tower", lambda: priors.image_embedder(refs[0]))
        priors.text_embedder._empty = None          # time the tower, not its cache
        ctx_txt = timed("CLIP text tower", lambda: priors.text_embedder())
        frames = torch.cat([refs, torch.stack(warps)])
        f = vae.factor
        z = timed("VAE encode", lambda: vae.encode(frames.permute(0, 3, 1, 2) * 2.0 - 1.0))
        m = torch.cat([torch.ones((n_ref,) + masks[0].shape, device=DEVICE),
                       torch.stack(masks)])[:, None, ::f, ::f]
        ctx = (ctx_txt + ctx_img).repeat(len(frames), 1, 1)
        n = len(frames)
        inp = torch.cat([z, z, m], 1).repeat(2, 1, 1, 1)
        t_vec = torch.full((2 * n,), 999, dtype=torch.int64, device=DEVICE)
        timed("UNet call", lambda: [pipe.unet(inp, t_vec, ctx.repeat(2, 1, 1), num_frames=n)
                                    for _ in range(reps)])
        ms["UNet call"] /= reps
        profile_unet_call(lambda: pipe.unet(inp, t_vec, ctx.repeat(2, 1, 1), num_frames=n))
        noise = pipe.draw_noise(z.shape, DEVICE, torch.Generator(device=DEVICE).manual_seed(1000))
        lat = timed("DDIM loop", lambda: pipe.inpaint_latents(z, m, ctx, gt_num=n_ref,
                                                              noise=noise))
        lat_p = timed("DDIM loop, plain attention", lambda: pipe.inpaint_latents(
            z, m, ctx, gt_num=n_ref, noise=noise, attention=chunked_attention))
        timed("VAE decode", lambda: vae.decode(lat[n_ref:]))
    return ms, lat, lat_p


def tsdf_bound(n_points, n_views, w, h):
    """Least time for one TSDF pass (integrate_views over n_points x
    n_views): the points, the views' colour and depth maps read once and the
    tsdf, colours and weights written once, against TSDF_OPS_PER_POINT_VIEW
    fp32 operations per (point, view). Returns (ms, 'bytes' | 'operations')."""
    nbytes = n_points * 12 + n_views * w * h * 16 + n_points * 20
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_points * n_views * TSDF_OPS_PER_POINT_VIEW / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_b1():
    """B1's plain version in place of its kernel under rasterize_entries:
    render() and everything over it run as they are, only the composite
    differs, and no launch is counted."""
    from g4splat_torch.ops import rasterize_cuda

    def plain(*args):
        maps = rasterize_cuda.rasterize_entries_plain(*args)
        maps.pop("n_walked")
        return maps

    kernel = rasterize_cuda._rasterize_entries_cuda
    rasterize_cuda._rasterize_entries_cuda = plain
    try:
        yield
    finally:
        rasterize_cuda._rasterize_entries_cuda = kernel


def render_all_phase(scene, cams, images):
    """Phase 13: render_camera_batch over the training views with PNGs, the
    image metrics, LPIPS card vs CPU, and evaluate()'s results dict. Returns
    B1's launches on these paths."""
    import tempfile

    import torch

    from g4splat_torch.core.cameras import camera_at, stack_cameras
    from g4splat_torch.eval.image_metrics import LPIPS, evaluate_images
    from g4splat_torch.io.images import read_png, to_uint8
    from g4splat_torch.ops import rasterize_cuda
    from g4splat_torch.pipeline.evaluate import evaluate
    from g4splat_torch.pipeline.render_all import render_camera_batch

    n = cams.w2c.shape[0]
    fwd = rasterize_cuda.RASTERIZE_FWD
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        fwd.launches = 0
        t0 = time.perf_counter()
        renders = render_camera_batch(scene, cams, out_dir=os.path.join(tmp, "renders"))
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3
        batch_launches = fwd.launches
        check(batch_launches == n, f"render_camera_batch launched B1 {batch_launches} times "
              f"({n} views)")
        same = all(np.array_equal(read_png(os.path.join(tmp, "renders", f"{v:05d}.png")),
                                  to_uint8(renders[v])) for v in range(n))
        check(same and renders.shape == (n, cams.height, cams.width, 3),
              f"{n} PNGs read back equal to the uint8 renders")
        lp = LPIPS(device=DEVICE)
        m = evaluate_images(renders, images, lpips_model=lp)
        check(all(np.isfinite(v) for v in m.values()),
              "PSNR / SSIM / LPIPS finite against the training images: " + ", ".join(
                  f"{k} {v:.5f}" for k, v in m.items()))
        card = lp(renders[0], images[0])
        host_params = {"conv": [{k: t.cpu() for k, t in c.items()} for c in lp.params["conv"]],
                       "lin": [t.cpu() for t in lp.params["lin"]]}
        host = LPIPS(host_params, calibrated=False, device="cpu")(renders[0].cpu(),
                                                                   images[0].cpu())
        check(abs(card - host) <= LPIPS_REL * abs(host),
              f"LPIPS on the card {card:.7f} vs the CPU {host:.7f} (same params, TF32 off): "
              f"relative {abs(card - host) / abs(host):.2e} <= {LPIPS_REL}")
        test = list(range(n - 2, n))
        torch.cuda.synchronize()
        fwd.launches = 0
        t0 = time.perf_counter()
        res = evaluate(scene, cams, gt_images=images,
                       test_cameras=stack_cameras([camera_at(cams, v) for v in test]),
                       test_images=images[test], lpips_model=lp,
                       out_dir=os.path.join(tmp, "eval"), iteration=35)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        eval_launches = fwd.launches
        written = os.path.join(tmp, "eval", "result_iter_35.json")
        check(list(res) == EVAL_KEYS and res["LPIPS-uncalibrated"] is True
              and os.path.exists(written) and list(json.load(open(written))) == EVAL_KEYS,
              f"evaluate() gives and writes the JAX package's keys {list(res)}")
        check(eval_launches == n + len(test), f"evaluate() launched B1 {eval_launches} times "
              f"({n} views + {len(test)} held out)")
    print(f"  results: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    print(f"  render_camera_batch {batch_ms:.1f} ms for {n} views with PNGs; evaluate() "
          f"{eval_ms:.1f} ms (host clock, synchronized)")
    return batch_launches + eval_launches


def mesh_phase():
    """Phase 14: the adaptive-tetra extraction at production settings on the
    box room through B1, its gates (launches, B1 vs plain, TSDF from B1's
    maps vs the plain version's, the mesh, PLY, Chamfer), then the multires
    extraction. Returns what phase 15 prints."""
    import tempfile

    import torch

    from g4splat_torch.core.cameras import camera_at, interpolate_cameras
    from g4splat_torch.eval.mesh_metrics import evaluate_mesh
    from g4splat_torch.eval.synthetic import box_room, cull_mesh_to_views, room_cameras
    from g4splat_torch.io.ply import load_mesh_ply, save_mesh_ply
    from g4splat_torch.ops import rasterize_cuda
    from g4splat_torch.ops.tsdf import integrate_views_chunked
    from g4splat_torch.pipeline import mesh_extraction as me

    n_views, w, h = MESH_VIEWS
    cfg = me.PRODUCTION_MESH_CONFIG
    fwd = rasterize_cuda.RASTERIZE_FWD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene, (gt_v, gt_f) = box_room(MESH_DENSITY, device=DEVICE)
    cams = room_cameras(n_views, w, h, device=DEVICE)
    n_cams = n_views * (1 + cfg.interp_neighbors * cfg.interp_per_neighbor)
    print(f"  box_room({MESH_DENSITY}): {scene.capacity} splats; {n_views} cameras at {w}x{h}, "
          f"{n_cams} with the interpolated ones; config {cfg}")
    timings = {}
    torch.cuda.synchronize()
    fwd.launches = 0
    t0 = time.perf_counter()
    mesh = me.extract_mesh_adaptive_tsdf(scene, cams, cfg, timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fwd.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == 2 * n_cams, f"extract_mesh_adaptive_tsdf launched B1 {launches} times "
          f"(2 x {n_cams} renders)")
    print(f"  extraction {wall:.2f} s; {len(mesh.vertices)} vertices, {len(mesh.faces)} faces")

    interp = interpolate_cameras(cams, cfg.interp_neighbors, cfg.interp_per_neighbor)
    with torch.no_grad():
        for tag, cam in (("input camera 0", camera_at(cams, 0)),
                         ("interpolated camera 3", camera_at(interp, 3))):
            b, table = kernel_inputs(cam, scene)
            kernel_vs_plain(f"mesh {tag}", b, table, w, h, modes=("nodist",), quiet=True)
        del b, table
    extent = me.cameras_spatial_extent(cams)
    tcfg = me.tsdf_config(cfg, extent)
    pts, _ = scene.tetra_points(cfg.downsample_ratio, cfg.gaussian_flatness * extent, seed=0)
    views = me.render_all_views(scene, cams, cfg.depth_ratio)
    with plain_b1():
        pviews = me.render_all_views(scene, cams, cfg.depth_ratio)
    a = integrate_views_chunked(pts, cams, views.rgbs, views.depths, tcfg, chunk=cfg.point_chunk)
    p = integrate_views_chunked(pts, cams, pviews.rgbs, pviews.depths, tcfg,
                                chunk=cfg.point_chunk)
    d = (a.tsdf - p.tsdf).abs()
    off = float((d > TSDF_TOL).to(torch.float32).mean())
    check(off < FLIP_FRAC, f"first-pass TSDF at {len(pts)} tetra points from B1's maps of the "
          f"{n_views} input views vs the plain version's: |d| > {TSDF_TOL} at {off:.1e} of "
          f"points (< {FLIP_FRAC}); max|d| {float(d.max()):.2e}, on the rest "
          f"{float(torch.where(d > TSDF_TOL, 0.0, d).max()):.2e}; observed "
          f"{float((a.weights > 0).to(torch.float32).mean()):.3f}")
    del pviews, a, p, d

    c = mesh.vertex_colors
    check(len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all() and c is not None
          and np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1,
          "the mesh is non-empty and finite, its colours in [0, 1]")
    kept = me.keep_largest_clusters(mesh)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tetra_mesh_binary_search_7_iter_35.ply")
        save_mesh_ply(path, kept.vertices, kept.faces, kept.vertex_colors)
        v, f, col = load_mesh_ply(path)
    check(np.array_equal(v, kept.vertices) and np.array_equal(f, kept.faces)
          and np.array_equal(col, (np.clip(kept.vertex_colors, 0, 1) * 255).astype(np.uint8)),
          f"keep_largest_clusters ({len(kept.faces)} of {len(mesh.faces)} faces), then "
          f"save_mesh_ply / load_mesh_ply round-trip exactly")
    depths = views.depths.cpu().numpy()
    depths[depths <= 0] = 3.2
    gt = cull_mesh_to_views(gt_v, gt_f, cams, depths)
    metrics = evaluate_mesh(mesh.vertices, mesh.faces, *gt)
    print(f"  GT mesh culled to the input views: {len(gt[0])} of {len(gt_v)} vertices")
    print("  adaptive mesh vs GT: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    check(metrics["Comp"] < CHAMFER_CM and metrics["Recal"] > RECALL_MIN,
          f"adaptive mesh covers the GT: Comp {metrics['Comp']:.3f} cm < {CHAMFER_CM}, recall "
          f"{metrics['Recal']:.2f} % > {RECALL_MIN}")
    check(all(abs(metrics[k] - ref) <= ADAPTIVE_BAND * ref for k, ref in ADAPTIVE_REF.items()),
          "adaptive mesh accuracy at this scene's reading: " + ", ".join(
              f"{k} {metrics[k]:.3f} cm within {ADAPTIVE_BAND:.0%} of {ref}"
              for k, ref in ADAPTIVE_REF.items()))
    del views

    mr_timings = {}
    torch.cuda.synchronize()
    fwd.launches = 0
    t0 = time.perf_counter()
    mr = me.keep_largest_clusters(me.extract_mesh_multires_tsdf(
        scene, cams, resolution=MULTIRES_RESOLUTION, timings=mr_timings), cluster_to_keep=50)
    torch.cuda.synchronize()
    mr_wall = time.perf_counter() - t0
    mr_launches = fwd.launches
    check(mr_launches == n_views, f"the multires extraction launched B1 {mr_launches} times "
          f"({n_views} views)")
    check(len(mr.faces) > 0 and np.isfinite(mr.vertices).all(),
          f"multires mesh at {MULTIRES_RESOLUTION}^3 non-empty and finite ({len(mr.faces)} faces)")
    mr_metrics = evaluate_mesh(mr.vertices, mr.faces, *gt)
    print(f"  multires {MULTIRES_RESOLUTION}^3 (after keep_largest_clusters) vs GT: "
          + ", ".join(f"{k} {v:.4f}" for k, v in mr_metrics.items()))
    check(mr_metrics["Chamfer-L1"] < CHAMFER_CM,
          f"multires mesh Chamfer-L1 {mr_metrics['Chamfer-L1']:.3f} cm < {CHAMFER_CM}")
    return dict(timings=timings, wall=wall, launches=launches + mr_launches, peak=peak,
                n_points=len(pts), n_cams=n_cams, w=w, h=h, mr_timings=mr_timings,
                mr_wall=mr_wall, edges=len(mesh.vertices))


def stage_files(stage, n_train, n_cand, n_sel):
    """The files see3d_stage(stage) writes under its stage directory (the
    CPU test holds the same names against the JAX package's), without the
    optional invisible_points.ply."""
    names = {f"stage{stage}_need_inpaint_views_points.ply"}
    for i in range(n_train):
        names |= {f"render-train-views/{i:05d}.png", f"render-train-views/depth_{i:05d}.tiff"}
    for i in range(n_cand):
        names |= {f"raw-gs/ori_warp_frame{i:06d}.png", f"raw-gs/depth_frame{i:06d}.tiff",
                  f"raw-gs/alpha_{i:06d}.npy", f"raw-gs/alpha_mask_frame{i:06d}.png",
                  f"raw-gs/mask_frame{i:06d}.png", f"raw-gs/warp_frame{i:06d}.png"}
    for k in range(n_sel):
        names |= {f"select-gs/warp_frame{k:06d}.png", f"select-gs/mask_frame{k:06d}.png",
                  f"select-gs/depth_frame{k:06d}.tiff",
                  f"select-gs-inpainted/predict_warp_frame{k:06d}.png"}
    return names


def see3d_loop_phase():
    """Phase 16: one See3D loop through G4SplatPipeline on the card, with
    gates (i)-(vii). Returns what the summary prints."""
    import tempfile

    import torch

    from g4splat_torch.core.cameras import camera_at
    from g4splat_torch.eval.synthetic import box_room, inward_cameras
    from g4splat_torch.ops import attention_cuda
    from g4splat_torch.ops import rasterize_cuda, rasterize_cuda_bwd
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.ops.rasterize_common import RenderConfig
    from g4splat_torch.pipeline import orchestrator as orch
    from g4splat_torch.pipeline.novel_views import none_visible_rate_from_alpha
    from g4splat_torch.priors.depth_anything import DepthAnything
    from g4splat_torch.train.trainer import Trainer

    n_views, w, h = LOOP_VIEWS
    fwd, bwd = rasterize_cuda.RASTERIZE_FWD, rasterize_cuda_bwd.RASTERIZE_BWD
    att = attention_cuda.ATTENTION_FWD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    scene, _ = box_room(MESH_DENSITY, device=DEVICE)
    cams = inward_cameras(n_views, w, h, device=DEVICE)
    with torch.no_grad():
        outs = [render(camera_at(cams, v), scene, config=RenderConfig(depth_ratio=0.5),
                       backend="cuda") for v in range(n_views)]
    images = torch.stack([o["render"].clamp(0, 1) for o in outs])
    # Where a view sees past the room's open sides the render's depth is 0.
    # Such pixels have no chart point and no init faces (ROADMAP C12); the
    # loop runs on these depths as they are.
    depths = torch.stack([o["surf_depth"] for o in outs])
    empty = (depths <= 0).flatten(1).float().mean(1)
    print(f"  box_room({MESH_DENSITY}): {scene.capacity} splats; inputs and the depths standing "
          f"in for the chart depths rendered by B1 from inward_cameras({n_views}, {w}, {h}); "
          f"covered share per view "
          + " ".join(f"{float((o['rend_alpha'] > 0.5).float().mean()):.2f}" for o in outs))
    check(bool((empty > 0).any()),
          "input depths hold empty (0) pixels, share per view "
          + " ".join(f"{float(e):.3f}" for e in empty))
    del outs, scene
    priors = see3d_priors(5, SEE3D_SHAPE[3])
    priors.depth_model = DepthAnything(LOOP_DA2, seed=6, device=DEVICE)
    # With the default init the head's last convolution is negative over the
    # whole image and its ReLU gives a disparity of 0 everywhere: its bias is
    # set to 1, so the lift fits a disparity that varies.
    with torch.no_grad():
        priors.depth_model.model.depth_head.scratch.output_conv2[2].bias.fill_(1.0)
    n_da2 = sum(p.numel() for p in priors.depth_model.model.parameters())
    n_calls = len(priors.see3d.sampler.timesteps)
    per_call_b3 = 2 * priors.see3d.unet.cfg.n_transformer_blocks()
    print(f"  DepthAnything({LOOP_DA2!r}): {n_da2 / 1e6:.1f}M parameters, seeded random "
          f"weights; See3D DDIM {n_calls} timesteps")

    # Instruments, all outside the library: DA2 time per infer_images call,
    # the selection's inputs, the depth lift's inputs, each step's loss.
    da2 = priors.depth_model
    infer = da2.infer_images
    da2_ms, da2_first = [], []

    def timed_infer(imgs, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer(imgs, **kw)
        torch.cuda.synchronize()
        da2_ms.append((len(imgs), (time.perf_counter() - t0) * 1e3))
        if not da2_first:
            da2_first.append(imgs[0].detach().clone())
        return out

    da2.infer_images = timed_infer
    select = orch.select_need_inpaint_views
    sel_calls, lifts, losses = [], [], []

    def select_spy(cand, rates, xyz, **kw):
        ids = select(cand, rates, xyz, **kw)
        sel_calls.append(dict(cand=cand, rates=list(rates), xyz=xyz, kw=kw, ids=list(ids)))
        return ids

    align = orch.depth_linear_align

    def align_spy(disp, depth, mask):
        lifts.append((depth, mask))
        return align(disp, depth, mask)

    step = Trainer.step

    def step_spy(self, sync_metrics=True):
        m = step(self, sync_metrics)
        losses.append(m["loss"])
        return m

    orch.select_need_inpaint_views, orch.depth_linear_align = select_spy, align_spy
    Trainer.step = step_spy
    rows = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            pipe = orch.G4SplatPipeline(orch.PipelineConfig(output_path=tmp),
                                        priors, device=DEVICE)
            parts_s = {"sweeps": 0.0, "see3d": 0.0}

            def timed(part, fn):
                def run(*a, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                    parts_s[part] += time.perf_counter() - t0
                    return out
                return run

            pipe._render_maps_batch = timed("sweeps", pipe._render_maps_batch)
            pipe._run_see3d_inpaint = timed("see3d", pipe._run_see3d_inpaint)
            cfg = pipe.cfg
            print(f"  PipelineConfig: select_inpaint_num {cfg.select_inpaint_num}, "
                  f"{cfg.n_see3d_stages} stages, vis_grid_resolution "
                  f"{cfg.vis_grid_resolution}, none-visible bounds {cfg.none_visible_low}/"
                  f"{cfg.none_visible_high}, gaussian_capacity {cfg.gaussian_capacity}, "
                  f"render_backend {cfg.render_backend!r}; {LOOP_ITERATIONS} iterations per "
                  f"train_gaussians")
            pipe.load_inputs(images, cams)
            pipe.state.depths, pipe.state.prior_depths = depths.clone(), depths.clone()
            steps = [("render_chart_views", ()), ("excavate_planes", ()),
                     ("refine_plane_depths", ()), ("train_gaussians", (LOOP_ITERATIONS,))]
            for k in range(1, cfg.n_see3d_stages + 1):
                steps += [("see3d_stage", (k,)), ("refine_plane_depths", (k == 3,)),
                          ("train_gaussians", (LOOP_ITERATIONS,))]
            n_selected = 0
            torch.cuda.synchronize()
            fwd.launches = bwd.launches = att.launches = 0
            t_loop = time.perf_counter()
            for name, args in steps:
                st = pipe.state
                c0 = (fwd.launches, bwd.launches, att.launches)
                v0, n_sel_calls, n_lifts, n_losses = len(st.images), len(sel_calls), len(lifts), \
                    len(losses)
                getattr(pipe, name)(*args)
                delta = tuple(a - b for a, b in zip((fwd.launches, bwd.launches, att.launches), c0))
                rows.append((f"{name}{args if args and name != 'train_gaussians' else ''}",
                             pipe.timing_log[-1][1], delta, dict(parts_s)))
                parts_s.update(sweeps=0.0, see3d=0.0)
                if name == "train_gaussians":
                    sc = st.scene
                    live = sc.alive
                    bad = sum(int((~torch.isfinite(getattr(sc, f)[live])).any(-1).sum()) for f in
                              ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw",
                               "rotation_raw"))
                    step_losses = torch.stack(losses[n_losses:])
                    check(bad == 0 and bool(torch.isfinite(step_losses).all())
                          and len(step_losses) == LOOP_ITERATIONS,
                          f"train_gaussians after {len(rows) - 1} methods: {int(live.sum())} live "
                          f"splats in {sc.capacity} slots, {bad} rows with a non-finite value; "
                          f"{len(step_losses)} losses, "
                          f"{int(torch.isfinite(step_losses).sum())} finite "
                          f"({float(step_losses[0]):.4f} -> {float(step_losses[-1]):.4f})")
                    check(delta[1] == LOOP_ITERATIONS,
                          f"train_gaussians launched B2 {delta[1]} times ({LOOP_ITERATIONS})")
                if name != "see3d_stage":
                    continue
                k = args[0]
                call = sel_calls[n_sel_calls]
                sel = call["ids"]
                n_cand = call["cand"].w2c.shape[0]
                n_selected += len(sel)
                check(len(st.images) == v0 + len(sel) and len(sel) > 0
                      and st.anchor_view_ids == list(range(v0, v0 + len(sel))),
                      f"stage {k}: {n_cand} candidates, {len(sel)} selected {sel}; views "
                      f"{v0} -> {len(st.images)}, anchor ids {st.anchor_view_ids[:1]}.."
                      f"{st.anchor_view_ids[-1:]}")
                new = st.depths[v0:]
                lifted = lifts[n_lifts:]
                same = all(torch.equal(new[i][m], d[m]) for i, (d, m) in enumerate(lifted))
                shown = (f"visible share {float(torch.stack([m for _, m in lifted]).float().mean()):.3f}; "
                         f"min {float(new.min()):.3e}, max {float(new.max()):.3e}"
                         if lifted else "no views")
                check(len(lifted) == len(sel) > 0 and same and bool(torch.isfinite(new).all())
                      and bool((new > 0).all()),
                      f"stage {k}: lifted depths equal the rendered depth inside each visible "
                      f"mask bit for bit, finite and > 0 everywhere ({shown})")
                check(delta[2] == per_call_b3 * n_calls,
                      f"stage {k} launched B3 {delta[2]} times ({per_call_b3} per UNet call x "
                      f"{n_calls} calls)")
                stage_dir = os.path.join(pipe.store.see3d_root, f"stage{k}")
                written = {os.path.relpath(os.path.join(d, f), stage_dir)
                           for d, _, fs in os.walk(stage_dir) for f in fs}
                check(written - {"invisible_points.ply"} == stage_files(k, v0, n_cand, len(sel)),
                      f"stage {k}: {len(written)} files under stage{k}/, by name")
                if k == 1:
                    cand = call["cand"]
                    with plain_b1():
                        alphas = pipe._render_maps_batch(cand, n_cand, keys=("rend_alpha",))
                    rates = [none_visible_rate_from_alpha(a) for a in alphas["rend_alpha"]]
                    d_rate = max(abs(a - b) for a, b in zip(rates, call["rates"]))
                    ids = select(cand, rates, call["xyz"], **call["kw"])
                    check(d_rate <= RATE_TOL and ids == sel,
                          f"stage 1 sweep again with B1's plain version: none-visible rates "
                          f"max|d| {d_rate:.2e} <= {RATE_TOL}, selection {ids} == {sel}")
                    del alphas
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t_loop
            launches = (fwd.launches, bwd.launches, att.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            cum = np.load(os.path.join(pipe.store.see3d_root, "see3d_cameras.npz"))
            check(int(cum["n_views"]) == n_selected == len(pipe.state.images) - n_views,
                  f"see3d_cameras.npz n_views {int(cum['n_views'])} == {n_selected} selected "
                  f"over the stages")
            reports = dict(pipe.stage_reports)
            timing_log = list(pipe.timing_log)
    finally:
        orch.select_need_inpaint_views, orch.depth_linear_align = select, align
        Trainer.step = step
        da2.infer_images = infer

    img = da2_first[0]
    card = infer(img[None])[0]
    host_model = DepthAnything(LOOP_DA2, model=da2.model.to("cpu"))
    host = host_model.infer_images(img[None].cpu())[0]
    d = float((card.cpu() - host).abs().max())
    check(d <= DA2_REL * float(host.abs().max()) and float(host.std()) > 0,
          f"DA2 {LOOP_DA2} on one inpainted view, card vs the same module on the CPU (TF32 "
          f"off): max|d| {d:.3e} <= {DA2_REL} * max|CPU| {float(host.abs().max()):.4e}; CPU "
          f"disparity std {float(host.std()):.3e} > 0")
    return dict(rows=rows, loop_s=loop_s, launches=launches, peak=peak, reports=reports,
                da2_ms=da2_ms, timing_log=timing_log,
                phase_s=time.perf_counter() - t_phase)


def print_see3d_loop(r):
    """Phase 16's numbers: per method host seconds and launches, per stage
    counts, DA2 ms per call, launches, peak memory."""
    print("  method: host-clock s (synchronized), launches (B1, B2, B3)")
    for name, sec, delta, parts in r["rows"]:
        inner = (f"; sweeps {parts['sweeps']:.3f} s (render_maps_batch), See3D "
                 f"{parts['see3d']:.3f} s" if name.startswith("see3d_stage") else "")
        print(f"    {name}: {sec:.3f} s, {delta}{inner}")
    for k, rep in sorted(r["reports"].items()):
        print(f"  stage {k}: {rep['candidates']} candidates, {len(rep['selected'])} selected, "
              f"{rep['views']} views after the merge")
    print("  DA2 infer_images ms per call (views): " + ", ".join(
        f"{ms:.1f} ({n})" for n, ms in r["da2_ms"]))
    b1, b2, b3 = r["launches"]
    print(f"  launches in the loop: B1 {b1}, B2 {b2}, B3 {b3}")
    print(f"  loop {r['loop_s']:.1f} s, phase {r['phase_s']:.1f} s (host clock); peak device "
          f"memory {r['peak']:.2f} GiB")


def plain_matches(d1, d2, c1, c2, subsample=8):
    """extract_correspondences' plain version: the whole similarity of the
    two (H, W, D) maps at once (no blocks), argmax both ways, the mutual
    pairs on the subsample grid of image 1, conf sqrt(c1 c2). Host numpy."""
    import torch

    H, W, D = d1.shape
    a, b = d1.reshape(-1, D), d2.reshape(-1, D)
    nn12, nn21 = torch.argmax(a @ b.T, 1), torch.argmax(b @ a.T, 1)
    idx = torch.arange(H * W, device=a.device)
    grid = ((idx // W) % subsample == 0) & ((idx % W) % subsample == 0)
    idx1 = idx[(nn21[nn12] == idx) & grid]
    idx2 = nn12[idx1]
    conf = torch.sqrt(c1.reshape(-1)[idx1] * c2.reshape(-1)[idx2])
    i1, i2 = idx1.cpu().numpy(), idx2.cpu().numpy()
    return (np.stack([i1 % W, i1 // W], 1), np.stack([i2 % d2.shape[1], i2 // d2.shape[1]], 1),
            conf.cpu().numpy())


def front_end_phase():
    """Phase 17: G4SplatPipeline.run() from posed photos on the card, with
    gates (i)-(vii). Returns what the summary prints."""
    import copy
    import tempfile

    import torch

    from g4splat_torch.core.cameras import camera_at
    from g4splat_torch.device import fp32_math
    from g4splat_torch.eval.synthetic import box_room, inward_cameras
    from g4splat_torch.io import colmap as colmap_io
    from g4splat_torch.ops import attention_cuda, rasterize_cuda, rasterize_cuda_bwd
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.pipeline import orchestrator as orch
    from g4splat_torch.pipeline import sfm as S
    from g4splat_torch.priors.depth_anything import DepthAnything
    from g4splat_torch.priors.mast3r import (MASt3RConfig, MASt3RModel,
                                             extract_correspondences, reciprocal_nn_matches)
    from g4splat_torch.train.trainer import Trainer

    n_views, w, h = FRONT_VIEWS
    fwd, bwd = rasterize_cuda.RASTERIZE_FWD, rasterize_cuda_bwd.RASTERIZE_BWD
    att = attention_cuda.ATTENTION_FWD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    scene, gt_mesh = box_room(MESH_DENSITY, device=DEVICE)
    cams = inward_cameras(n_views, w, h, device=DEVICE)
    with torch.no_grad():
        maps = [render(camera_at(cams, v), scene, backend="cuda") for v in range(n_views)]
        images = torch.stack([r["render"].clamp(0, 1) for r in maps])
    print(f"  box_room({MESH_DENSITY}): {scene.capacity} splats and its GT mesh "
          f"({len(gt_mesh[1])} faces); {n_views} photos rendered by B1 from "
          f"inward_cameras({n_views}, {w}, {h}), no depth passed on; views {FRONT_EVAL} "
          f"held out")
    priors = see3d_priors(7, SEE3D_SHAPE[3])
    priors.depth_model = DepthAnything(LOOP_DA2, seed=8, device=DEVICE)
    with torch.no_grad():       # as phase 16: a disparity that varies
        priors.depth_model.model.depth_head.scratch.output_conv2[2].bias.fill_(1.0)
    mcfg = MASt3RConfig()
    model = MASt3RModel(mcfg, seed=9, device=DEVICE)
    # Random weights, set as phase 16 sets DA2's bias, so that the geometry
    # stages get what a trained MASt3R gives them in kind: a trained MASt3R
    # puts every point in front of its camera, where on random weights half
    # the pixels get z <= 0, clamped to 1e-3. Each head's last convolution
    # has its xyz weights scaled by 0.1 and its z bias set to 0.75: points
    # near (0, 0, expm1(0.75) = 1.12) in the camera's frame (at a bias of 1.0
    # and above, no stage-1 candidate saw half its pixels; PERF.md section 4).
    with torch.no_grad():
        for head in (model.model.downstream_head1, model.model.downstream_head2):
            last = head.dpt.head[4]
            last.weight[:3] *= 0.1
            last.bias[:3] = torch.tensor([0.0, 0.0, 0.75])
    # A trained MASt3R's descriptors match the same surface point across
    # views, and its pointmaps follow the surface, edges included. Random
    # descriptors give random matches, which posed SfM pulls together until
    # its depths span 1e-4 to 1.6e2 (ROADMAP C14); random pointmaps carry no
    # edge, so SfM's stride-8 depth anchors blur each depth step, and chart
    # alignment took one pixel by such a step below 0 in 1 of 3 runs on the
    # same inputs (ROADMAP C19). The network runs at full width, its heads
    # too (gate (i) holds their outputs), and what reaches the geometry
    # stages is keyed on each pixel's box_room surface point (B1's surface
    # depth backprojected), where the pixel sees a surface:
    # - the descriptors: the point lifted onto the unit 3-sphere by inverse
    #   stereographic projection of (X - centre) / radius. The dot product of
    #   two lifts is 1 - 2|p - q|^2 / ((1 + |p|^2)(1 + |q|^2)), greatest at
    #   the same point, so the mutual nearest neighbours are true matches.
    #   Pixels that see no surface share one unit vector orthogonal to the
    #   lifts: at most one such pair per image pair survives the mutual test;
    # - the pointmaps: the point in the frame of the pair's camera (X11 and
    #   X21 in the first image's, X22 and X12 in the second's). Pixels that
    #   see no surface keep the network's points.
    with torch.no_grad():
        world = [camera_at(cams, v).backproject(r["surf_depth"]) for v, r in enumerate(maps)]
        hit = [(r["rend_alpha"] > 0.5) & (r["surf_depth"] > 0) for r in maps]
        w2cs = [camera_at(cams, v).w2c for v in range(n_views)]
        pts = torch.cat([x[m] for x, m in zip(world, hit)])
        centre = pts.mean(0)
        radius = float((pts - centre).norm(dim=-1).max())
        surface_desc = []
        for x, m in zip(world, hit):
            p = (x - centre) / radius
            n2 = (p * p).sum(-1, keepdim=True)
            d = torch.zeros(h, w, mcfg.local_feat_dim, device=DEVICE)
            d[..., :4] = torch.cat([2 * p, n2 - 1], -1) / (n2 + 1)
            d[~m] = 0.0
            d[~m, 4] = 1.0
            surface_desc.append(d[None])
    empty = [int((~m).sum()) for m in hit]
    del scene, maps, pts
    priors.mast3r = model
    print(f"  MASt3R {mcfg.enc_embed_dim}/{mcfg.enc_depth} encoder, {mcfg.dec_embed_dim}/"
          f"{mcfg.dec_depth} decoders: {sum(p.numel() for p in model.model.parameters()) / 1e6:.1f}M "
          f"parameters, seeded random weights; DepthAnything({LOOP_DA2!r}); See3D DDIM "
          f"{SEE3D_SHAPE[3] + 1} timesteps; sam_generator None; descriptors and pointmaps "
          f"keyed on the surface point (pixels on no surface per view: {empty})")
    n_calls = len(priors.see3d.sampler.timesteps)
    per_call_b3 = 2 * priors.see3d.unet.cfg.n_transformer_blocks()

    # Instruments, all outside the library.
    infer, sym = model.infer_pair, model.symmetric_inference_batch
    chunk_ms, corres, rectified, sfm_runs, chart_runs, losses = [], [], [], [], [], []

    def timed_infer(a, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer(a, b)
        torch.cuda.synchronize()
        chunk_ms.append((len(a), (time.perf_counter() - t0) * 1e3))
        return out

    def keyed_batch(imgs1, imgs2, **kw):
        ims = pipe.state.images

        def view(img):
            return next(v for v in range(len(ims)) if torch.equal(img, ims[v]))

        def keyed(x, v, f):     # image v's maps in camera f's frame
            pts = torch.where(hit[v][..., None], world[v] @ w2cs[f][:3, :3].T + w2cs[f][:3, 3],
                              x["pts3d"][0])
            return dict(x, pts3d=pts[None], desc=surface_desc[v])

        return [tuple(keyed(x, v, f) for x, v, f in zip(o, (i, j, j, i), (i, i, j, j)))
                for o, i, j in ((o, view(a), view(b)) for o, a, b in
                                zip(sym(imgs1, imgs2, **kw), imgs1, imgs2))]

    ext, rect, sga, ac, step = (orch.extract_correspondences, S.rectify_to_center_pp,
                                S.sparse_global_alignment, orch.align_charts, Trainer.step)

    def ext_spy(*a, **kw):
        out = ext(*a, **kw)
        corres.append(len(out[0]))
        return out

    def rect_spy(*a, **kw):
        out = rect(*a, **kw)
        rectified.append(out[1])
        return out

    def sga_spy(*a, **kw):
        stats = {}
        res = sga(*a, stats=stats, **kw)
        sfm_runs.append((res, stats))
        return res

    def ac_spy(*a, **kw):
        stats = {}
        res = ac(*a, stats=stats, **kw)
        chart_runs.append((res, stats))
        return res

    def step_spy(self, sync_metrics=True):
        m = step(self, sync_metrics)
        losses.append(m["loss"])
        return m

    model.infer_pair, model.symmetric_inference_batch = timed_infer, keyed_batch
    orch.extract_correspondences, orch.align_charts = ext_spy, ac_spy
    S.rectify_to_center_pp, S.sparse_global_alignment = rect_spy, sga_spy
    Trainer.step = step_spy
    rows, meshes, colmap_s = [], [], []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            src, out = os.path.join(tmp, "source"), os.path.join(tmp, "out")
            ccams, cimgs = {}, {}
            for v in range(n_views):
                c = camera_at(cams, v)
                w2c = c.w2c.cpu().numpy().astype(np.float64)
                ccams[v + 1] = colmap_io.ColmapCamera(v + 1, "PINHOLE", w, h, np.array(
                    [float(c.fx), float(c.fy), float(c.cx), float(c.cy)]))
                cimgs[v + 1] = colmap_io.ColmapImage(v + 1, colmap_io.rotmat2qvec(w2c[:3, :3]),
                                                     w2c[:3, 3], v + 1, f"frame_{v:06d}.png")
            colmap_io.write_model(ccams, cimgs, {}, os.path.join(src, "sparse", "0"))
            with open(os.path.join(src, "dense_view.json"), "w") as f:
                json.dump({"train": FRONT_DENSE}, f)
            pipe = orch.G4SplatPipeline(orch.PipelineConfig(
                source_path=src, output_path=out, sfm_config="posed", alignment_config="default",
                use_multires_tsdf=True, n_see3d_stages=1, train_iterations=LOOP_ITERATIONS,
                eval_split=FRONT_EVAL), priors, device=DEVICE)
            cfg = pipe.cfg
            print(f"  PipelineConfig: sfm {cfg.sfm_config!r}, alignment "
                  f"{cfg.alignment_config!r}, {cfg.n_see3d_stages} See3D stage, multires mesh "
                  f"at {cfg.tsdf_resolution}^3, {cfg.train_iterations} iterations per "
                  f"train_gaussians, capacity {cfg.gaussian_capacity}, render_backend "
                  f"{cfg.render_backend!r}; the rest PipelineConfig's defaults")
            write_colmap = pipe._write_colmap

            def timed_write(*a, **kw):
                t0 = time.perf_counter()
                write_colmap(*a, **kw)
                colmap_s.append(time.perf_counter() - t0)

            pipe._write_colmap = timed_write
            st = pipe.state

            def after_sfm():
                res, stats = sfm_runs[-1]
                r = rectified[-1]
                d_w2c = float((st.cameras.w2c - r.w2c).abs().max())
                d_f = float((st.cameras.fx - r.fx).abs().max() / r.fx.abs().max())
                check(d_w2c <= 1e-5 and d_f <= 1e-6 and bool(torch.equal(st.cameras.fx,
                                                                            st.cameras.fy)),
                      f"(ii) posed mode keeps the cameras: max|w2c - rectified| {d_w2c:.2e} <= "
                      f"1e-5, focal rel. |d| {d_f:.2e} <= 1e-6 (float32 log and exp of the "
                      f"shared focal), fx == fy")
                d = st.prior_depths
                check(bool(torch.isfinite(d).all()) and bool((d > 0).all()),
                      f"(ii) SfM depths finite and > 0 (min {float(d.min()):.3e}, max "
                      f"{float(d.max()):.3e})")
                n1 = stats.get("phase1_iters", 0)
                k1 = len(range(0, n1, max(1, n1 // 10)))
                ph = [res.losses[:k1], res.losses[k1:]]
                check(all(p and p[-1] <= p[0] for p in ph),
                      "(ii) each Adam phase's last sampled loss <= its first: "
                      + ", ".join(f"{p[0]:.4e} -> {p[-1]:.4e}" for p in ph if p))
                sfm_root = os.path.join(out, "sfm")
                rc, ri, _ = colmap_io.read_model(os.path.join(sfm_root, "sparse", "0"))
                n_train = len(st.images)
                ok = len(rc) == len(ri) == n_train and all(
                    np.allclose(rc[v + 1].params, [res.focals[v], res.focals[v], (w - 1) / 2,
                                                   (h - 1) / 2])
                    and np.allclose(ri[v + 1].tvec, res.w2c[v][:3, 3], atol=1e-6)
                    and np.allclose(colmap_io.rotmat2qvec(res.w2c[v][:3, :3]), ri[v + 1].qvec,
                                    atol=1e-6) for v in range(n_train))
                ac_, ai, _ = colmap_io.read_model(os.path.join(sfm_root, "all-sparse", "0"))
                ok &= (sorted(ai) == sorted(cimgs)
                       and all(np.allclose(ai[k].tvec, cimgs[k].tvec) for k in cimgs))
                dc, di, _ = colmap_io.read_model(os.path.join(sfm_root, "dense-view-sparse", "0"))
                ok &= [di[k].name for k in sorted(di)] == [f"frame_{v:06d}.png"
                                                           for v in FRONT_DENSE]
                files = ["points.ply", "cameras.json"] + [
                    f"pointmaps/frame_{v:06d}.json" for v in range(n_train)]
                present = all(os.path.exists(os.path.join(sfm_root, f)) for f in files)
                check(ok and present,
                      f"(iii) sparse/0 ({n_train} views), all-sparse/0 ({len(ai)}) and "
                      f"dense-view-sparse/0 ({len(di)}) read back with the cameras and poses "
                      f"written; points.ply, cameras.json and {n_train} pointmaps present")

            def after_charts():
                res, stats = chart_runs[-1]
                data = np.load(os.path.join(out, "sfm", "charts_data.npz"))
                ok = sorted(data.files) == ["confs", "depths", "prior_depths", "pts",
                                            "scale_factor"]
                d, c = st.depths, st.confidences
                check(ok and bool(torch.isfinite(d).all()) and bool((d > 0).all())
                      and bool(torch.isfinite(c).all()) and res.losses[-1] < res.losses[0],
                      f"(iv) charts_data.npz keys {sorted(data.files)}; chart depths finite "
                      f"and > 0 (min {float(d.min()):.3e}), confidences finite; loss "
                      f"{res.losses[0]:.4e} -> {res.losses[-1]:.4e}")

            def after_train(delta, n_losses):
                sc = st.scene
                live = sc.alive
                bad = sum(int((~torch.isfinite(getattr(sc, f)[live])).any(-1).sum()) for f in
                          ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw"))
                step_losses = torch.stack(losses[n_losses:])
                check(bad == 0 and bool(torch.isfinite(step_losses).all())
                      and delta[1] == LOOP_ITERATIONS,
                      f"(v) train_gaussians: {int(live.sum())} live splats in {sc.capacity} "
                      f"slots, {bad} rows with a non-finite value; losses finite "
                      f"({float(step_losses[0]):.4f} -> {float(step_losses[-1]):.4f}); B2 "
                      f"{delta[1]} launches ({LOOP_ITERATIONS})")

            def after_see3d(delta, n_losses):
                check(delta[2] == per_call_b3 * n_calls,
                      f"(v) see3d_stage launched B3 {delta[2]} times ({per_call_b3} per UNet "
                      f"call x {n_calls} calls)")

            gates = {"run_sfm": lambda *a: after_sfm(), "align_charts": lambda *a: after_charts(),
                     "train_gaussians": after_train, "see3d_stage": after_see3d}

            def instrument(name):
                fn = getattr(pipe, name)

                def run_(*a, **kw):
                    c0 = (fwd.launches, bwd.launches, att.launches)
                    n_losses = len(losses)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = fn(*a, **kw)
                    torch.cuda.synchronize()
                    delta = tuple(x - y for x, y in
                                  zip((fwd.launches, bwd.launches, att.launches), c0))
                    rows.append((f"{name}{a if a else ''}", time.perf_counter() - t0, delta))
                    if name == "extract_mesh":
                        meshes.append(res)
                    gates.get(name, lambda *x: None)(delta, n_losses)
                    return res
                setattr(pipe, name, run_)

            for name in ("run_sfm", "align_charts", "render_chart_views", "excavate_planes",
                         "refine_plane_depths", "train_gaussians", "see3d_stage",
                         "extract_mesh", "evaluate"):
                instrument(name)
            torch.cuda.synchronize()
            fwd.launches = bwd.launches = att.launches = 0
            t_run = time.perf_counter()
            results = pipe.run(images, cams, gt_mesh=gt_mesh)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = (fwd.launches, bwd.launches, att.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            mesh = meshes[-1]
            check(len(mesh.faces) > 0 and bool(np.isfinite(mesh.vertices).all())
                  and mesh.vertex_colors is not None and float(mesh.vertex_colors.min()) >= 0
                  and float(mesh.vertex_colors.max()) <= 1,
                  f"(vi) mesh: {len(mesh.vertices)} vertices, {len(mesh.faces)} faces, "
                  f"finite, colours in [0, 1]")
            it = LOOP_ITERATIONS
            written = json.load(open(os.path.join(out, f"result_iter_{it}.json")))
            txt = [l.split(":")[0] for l in
                   open(os.path.join(out, f"result_iter_{it}.txt")).read().splitlines()]
            check(list(results) == list(written) == txt == RESULT_KEYS,
                  f"(vi) result_iter_{it}.json and .txt hold the JAX package's keys for a "
                  f"held-out split with a GT mesh: "
                  + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in results.items()))
            g = os.path.join(out, "free_gaussians")
            names = [f"point_cloud-ori/iteration_{it}/point_cloud.ply",
                     f"point_cloud/iteration_{it}/point_cloud.ply",
                     f"test/ours_{it}/renders/00000.png"]
            stage1 = os.path.join(out, "sfm", "see3d_render", "stage1")
            check(all(os.path.exists(os.path.join(g, n)) for n in names)
                  and os.path.isdir(stage1) and sorted(os.listdir(g)) == [
                      "point_cloud", "point_cloud-ori", "test"]
                  and os.path.exists(os.path.join(
                      out, "tetra_meshes", f"tetra_mesh_binary_search_7_iter_{it}.ply")),
                  f"(vii) free_gaussians/ holds {sorted(os.listdir(g))}: the stage-1 snapshot "
                  f"point_cloud-ori, then the final point_cloud; the test renders, "
                  f"see3d_render/stage1 and the mesh")
            timing_log = list(pipe.timing_log)
            pair = st.images[0:1], st.images[1:2]
    finally:
        model.infer_pair, model.symmetric_inference_batch = infer, sym
        orch.extract_correspondences, orch.align_charts = ext, ac
        S.rectify_to_center_pp, S.sparse_global_alignment = rect, sga
        Trainer.step = step

    # (i) MASt3R on one pair, card vs the same module on the CPU.
    card = model.infer_pair(*pair)
    host = MASt3RModel(mcfg, model=copy.deepcopy(model.model).to("cpu")).infer_pair(
        *(x.cpu() for x in pair))
    errs = {}
    for i, (a, b) in enumerate(zip(card, host)):
        for k in ("pts3d", "conf", "desc", "desc_conf"):
            errs[f"out{i + 1}.{k}"] = (float((a[k].cpu() - b[k]).abs().max()),
                                       float(b[k].abs().max()))
    check(all(d <= MAST3R_REL * m for d, m in errs.values()),
          f"(i) MASt3R on one pair, card vs the same module on the CPU (TF32 off): max|d| <= "
          f"{MAST3R_REL} * max|CPU| for " + ", ".join(f"{k} {d:.2e}/{m:.3e}"
                                                      for k, (d, m) in errs.items()))
    ch, cw = MATCH_CROP
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    rand = [torch.nn.functional.normalize(torch.randn(ch, cw, mcfg.local_feat_dim, device=DEVICE,
                                                      generator=gen), dim=-1) for _ in range(2)]
    for what, d1, d2 in (("that pair's descriptors", card[0]["desc"][0, :ch, :cw],
                          card[1]["desc"][0, :ch, :cw]),
                         ("seeded random unit descriptors", *rand)):
        c1, c2 = card[0]["desc_conf"][0, :ch, :cw], card[1]["desc_conf"][0, :ch, :cw]
        with fp32_math():
            want = plain_matches(d1, d2, c1, c2)
        got = extract_correspondences(d1, d2, c1, c2)
        nn_b, mut_b = reciprocal_nn_matches(d1, d2, block=ch * cw // 5)
        nn_u, mut_u = reciprocal_nn_matches(d1, d2, block=ch * cw)
        check(all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got[0]) > 0
              and torch.equal(nn_b, nn_u) and torch.equal(mut_b, mut_u),
              f"(i) extract_correspondences on a {cw}x{ch} crop of {what} equals the "
              f"unblocked plain version: {len(got[0])} matches; blocks of {ch * cw // 5} give "
              f"the unblocked indices and mutual mask ({int(mut_u.sum())} mutual)")
    del host, card
    return dict(rows=rows, chunk_ms=chunk_ms, corres=corres,
                sfm_stats=sfm_runs[-1][1], chart_stats=chart_runs[-1][1], colmap_s=colmap_s,
                launches=launches, peak=peak, run_s=run_s, timing_log=timing_log,
                phase_s=time.perf_counter() - t_phase)


def print_front_end(r):
    """Phase 17's numbers."""
    print("  method: host-clock s (synchronized), launches (B1, B2, B3)")
    for name, sec, delta in r["rows"]:
        print(f"    {name}: {sec:.3f} s, {delta}")
    print("  _timed (the JAX package's names): " + ", ".join(
        f"{n} {s:.3f}" for n, s in r["timing_log"]))
    print("  MASt3R ms per symmetric_inference_batch chunk (pair orderings): " + ", ".join(
        f"{ms:.1f} ({n})" for n, ms in r["chunk_ms"]))
    c = r["corres"]
    print(f"  pairs {len(c)}; correspondences per pair min {min(c)}, median "
          f"{int(np.median(c))}, max {max(c)}")
    s = r["sfm_stats"]
    print("  SfM ms per iteration: " + ", ".join(
        f"phase {k} {1e3 * s[f'phase{k}_s_per_iter']:.3f} ({s[f'phase{k}_iters']} iterations)"
        for k in (1, 2) if f"phase{k}_s_per_iter" in s))
    print(f"  kinematic tree (scipy ward linkage, host) {1e3 * s['tree_s']:.3f} ms")
    cs_ = r["chart_stats"]
    print(f"  chart alignment ms per iteration {1e3 * cs_['s_per_iter']:.3f} "
          f"({cs_['iters']} iterations)")
    print(f"  _write_colmap {sum(r['colmap_s']):.3f} s")
    b1, b2, b3 = r["launches"]
    print(f"  launches in run(): B1 {b1}, B2 {b2}, B3 {b3}")
    print(f"  run() {r['run_s']:.1f} s, phase {r['phase_s']:.1f} s (host clock); peak device "
          f"memory {r['peak']:.2f} GiB")


def print_mesh_timings(r):
    """Phase 15: the extraction's stages, the TSDF pass beside its bound, the
    host share and peak memory."""
    t = r["timings"]
    print("  adaptive stages s (host clock, synchronized): "
          + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; sum {sum(t.values()):.3f}, wall {r['wall']:.3f}")
    pv = r["n_points"] * r["n_cams"]
    bound, by = tsdf_bound(r["n_points"], r["n_cams"], r["w"], r["h"])
    print(f"  first TSDF pass: {r['n_points']} points x {r['n_cams']} views = {pv} point-views "
          f"in {t['tsdf']:.3f} s, {pv / t['tsdf']:.3e} per s; bound {bound:.4f} ms ({by}), "
          f"{100 * bound / 1e3 / t['tsdf']:.3f} % of it")
    steps = [v for k, v in t.items() if k.startswith("binary_step_")]
    ev = r["edges"] * r["n_cams"]
    print(f"  binary steps: {r['edges']} crossing edges x {r['n_cams']} views = {ev} "
          f"point-views each, median {np.median(steps):.3f} s, bound "
          f"{tsdf_bound(r['edges'], r['n_cams'], r['w'], r['h'])[0]:.4f} ms")
    host = sum(t[k] for k in ("tetra_points", "delaunay", "marching"))
    print(f"  host stages (tetra points, Delaunay, marching) {host:.3f} s = "
          f"{100 * host / r['wall']:.1f} % of the extraction's wall time")
    print(f"  peak device memory over the extraction {r['peak']:.2f} GiB")
    print("  multires stages s: " + ", ".join(f"{k} {v:.3f}" for k, v in r["mr_timings"].items())
          + f"; wall {r['mr_wall']:.3f}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from g4splat_torch.ops import cuda_build, rasterize_cuda, rasterize_cuda_bwd
        from g4splat_torch.core.cameras import lookat_camera
        from g4splat_torch.io.ply import load_gaussian_ply, save_gaussian_ply
        from g4splat_torch.ops.rasterize import render
        from g4splat_torch.ops.rasterize_common import RenderConfig
        from g4splat_torch.train.trainer import Trainer, TrainConfig, camera_at
    except ImportError as e:
        print(f"chip_smoke: cannot import g4splat_torch next to this script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    print("== phase 1: device")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = [l for l in run([cuda_build._nvcc(), "--version"]).splitlines() if "release" in l]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"  device {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    print(f"  nvcc: {nvcc[0] if nvcc else 'unknown'}")
    print(f"  nvidia-smi name, power.limit: {smi}")
    print(f"  PyTorch's TF32 flags (matmul, cuDNN) {tf32}; the port's entry points "
          f"(train_step, run_see3d_inpaint) turn both off while they run")

    print("== phase 2: build")
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"  built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if line.strip():
                print(f"  [{name}] {line.strip()}")
    try:
        sass_check()
    except (RuntimeError, subprocess.SubprocessError) as e:
        check(False, f"tensor-core instruction count: {e}")

    n3, w3, h3 = CHECK_SHAPE
    print(f"== phase 3: kernels vs plain versions, {n3} splats at {w3}x{h3}")
    print(f"  B1 tolerance: a float map's pixel agrees when |kernel - plain| <= "
          f"{MAP_TOL} * max|plain map| (at least {ABS_FLOOR}); every map's "
          f"disagreeing pixels, and n_contrib's, < {FLIP_FRAC} of the image")
    print(f"  B2 tolerance: ||kernel - plain|| / ||plain|| <= {GRAD_TOL} in every "
          f"gradient group, ||plain|| > 0")
    # "near" is the spread scene seen from close by (depths 0.6-4.6, as from a
    # camera inside a room): its distortion stands well above fp32 noise.
    for tag, spread, seed, cam_z in (("spread", 2.0, 1, -5.5), ("deep-overlap", 0.35, 3, -5.5),
                                     ("near", 2.0, 1, -2.6)):
        cam3 = lookat_camera([0, 0, cam_z], [0, 0, 0], [0, -1, 0], fx=220.0, fy=220.0,
                             width=w3, height=h3, device=DEVICE)
        scene = build_scene(n3, seed, spread=spread, wall=False, opacity=0.7,
                            log_scale=(-3.5, -2.0))
        with torch.no_grad():
            b, table = kernel_inputs(cam3, scene)
            print(f"  {tag}: {b.gauss_id.numel()} entries, densest tile "
                  f"{int(b.tile_count.max())}")
            seen, ref = kernel_vs_plain(tag, b, table, w3, h3)
            gathered_bitwise(tag, b, table, w3, h3)
            fwd_activity(tag, b, table, ref, w3, h3)
            runs3 = bwd_vs_plain(tag, b, table, w3, h3)
            walk_activity(tag, runs3[False][0])
            worklist_vs_plain(tag, runs3[True][0], True)
            print_b2_times(tag, runs3, w3, h3, b.tile_count.numel())
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
        # B1 against its plain version, and its reach boxes, on every orbit
        # frame; frame 0 is the one timed.
        for i, cam in enumerate(cams):
            bi, ti = kernel_inputs(cam, scene)
            _, ref = kernel_vs_plain(f"main frame {i}", bi, ti, W, H, quiet=i > 0)
            act = fwd_activity(f"main frame {i}", bi, ti, ref, W, H)
            if i == 0:
                b4, t4, act4 = bi, ti, act
        del bi, ti, ref

    n5, w5, h5 = BIG_SHAPE
    print(f"== phase 5: production shape, {n5} splats, SH 3, {w5}x{h5}")
    torch.cuda.reset_peak_memory_stats()
    big = build_scene(n5, 0, sh_degree=3)
    cam5 = lookat_camera([0, -0.8, -6.5], [0, 0, 0], [0, -1, 0], fx=600.0 * w5 / 768,
                         fy=600.0 * w5 / 768, width=w5, height=h5, device=DEVICE)
    with torch.no_grad():
        b5, t5 = kernel_inputs(cam5, big)
        print(f"  {b5.gauss_id.numel()} entries, densest tile {int(b5.tile_count.max())}")
        _, ref5 = kernel_vs_plain("production", b5, t5, w5, h5)
        gathered_bitwise("production", b5, t5, w5, h5)
        act5 = fwd_activity("production", b5, t5, ref5, w5, h5)
        del ref5
        runs5 = bwd_vs_plain("production", b5, t5, w5, h5)
        for want_dist, (args5, _) in runs5.items():
            walk_activity(f"production [{'full' if want_dist else 'nodist'}]", args5)
        print_b2_times("production", runs5, w5, h5, b5.tile_count.numel())
        del runs5
        out5 = {m: render(cam5, big, RenderConfig(compute_distortion=d), backend="cuda",
                          need_aux=a) for m, (a, d) in MODES.items()}
    check(all(bool(torch.isfinite(v).all()) for o in out5.values() for v in o.values()
              if v.is_floating_point()), "production-shape render() outputs finite in all modes")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print("== phase 6: timing")
    with torch.no_grad():
        tag4, tag5 = f"{W}x{H} {n4}", f"{w5}x{h5} {n5}"
        rows4, bound4, by4 = time_kernel(tag4, b4, t4, W, H, act4[0], MODES)
        time_kernel(tag5, b5, t5, w5, h5, act5[0], MODES)
        print_b1_walk(tag4, act4, b4)
        print_b1_walk(tag5, act5, b5)
        for mode, cfg, need_aux in main_cfgs:
            time_render(f"{tag4} [{mode}]", cams[0], scene, cfg, need_aux)
        for mode, (a, d) in MODES.items():
            time_render(f"{tag5} [{mode}]", cam5, big,
                        RenderConfig(compute_distortion=d), a, reps=3)
    print("  library_ms: none (no single PyTorch call computes this function)")
    del big, b5, t5, out5

    nc, wc, hc = CHAIN_SHAPE
    print(f"== phase 7: whole-chain gradients, cuda vs tiled backend, {nc} splats, SH 3, "
          f"{wc}x{hc}; tolerance ||cuda - tiled|| / ||tiled|| <= {CHAIN_TOL}")
    chain_gradients()

    n_live, cap, w8, h8, n_views, n_steps, n_dist = TRAIN_SHAPE
    print(f"== phase 8: training main path, {n_live} live splats in {cap} slots, SH 3, "
          f"{n_views} views at {w8}x{h8}, {n_steps} + {n_dist} steps")
    torch.cuda.reset_peak_memory_stats()
    init, cams8, views8 = training_data(n_live, cap, w8, h8, n_views)
    # On this scene the screen-space gradient statistic stays below 1e-5 over
    # these steps (its 99.9 % quantile near 1e-6), far under the default 2e-4,
    # so the threshold is cut to 2e-7 to make densify clone and split on the
    # card; max_capacity keeps the buffer at its 2.4M slots (candidates past
    # the free slots are dropped and counted).
    cfg8 = TrainConfig(densify_from_iter=5, densification_interval=10,
                       densify_until_iter=n_steps + 1, normal_consistency_from=0,
                       densify_grad_threshold=2e-7, max_capacity=cap)
    print(f"  TrainConfig defaults (chart priors, per-pixel depth order, mip filter, "
          f"anisotropy, lambda_dist 0, backend {cfg8.backend!r}) except: densify "
          f"statistics from step 5, densify at 10, 20, 30 with grad threshold 2e-7, "
          f"max_capacity {cap}, normal consistency from 0; then lambda_dist 100 from "
          f"step {n_steps + 1} (distortion_from 0)")
    trainer = Trainer(init, cams8, views8, cfg8, seed=0)
    del init
    # B2's inputs for phase 9: the first step's scene (mip filter applied)
    # from view 0. The state after training depends on the run (atomics), so
    # the gated comparison reads this one.
    with torch.no_grad():
        b8, t8 = kernel_inputs(camera_at(cams8, 0), trainer.scene)
    torch.cuda.synchronize()
    rasterize_cuda.RASTERIZE_FWD.launches = 0
    rasterize_cuda_bwd.RASTERIZE_BWD.launches = 0
    hist, step_ms, per_step = [], [], set()
    for i in range(n_steps + n_dist):
        if i == n_steps:
            trainer.cfg = trainer.cfg.replace(lambda_dist=100.0, distortion_from=0)
        it = trainer.iteration + 1
        densifies = it % cfg8.densification_interval == 0 and it < cfg8.densify_until_iter
        alive = int(trainer.scene.num_alive) if densifies else None
        if densifies:
            d = trainer.dstate
            g = (d.grad_accum / torch.clamp(d.denom, min=1.0))[trainer.scene.alive]
            q = torch.quantile(g[torch.randperm(g.numel(), device=g.device)[:1 << 20]],
                               torch.tensor([0.5, 0.9, 0.99, 0.999], device=g.device))
            print(f"  step {it}: screen-gradient statistic before this step, quantiles "
                  f"50/90/99/99.9 % " + " ".join(f"{float(v):.2e}" for v in q)
                  + f", max {float(g.max()):.2e}")
        before = (rasterize_cuda.RASTERIZE_FWD.launches,
                  rasterize_cuda_bwd.RASTERIZE_BWD.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step()
        torch.cuda.synchronize()
        step_ms.append(((time.perf_counter() - t0) * 1e3, densifies, i >= n_steps))
        per_step.add((rasterize_cuda.RASTERIZE_FWD.launches - before[0],
                      rasterize_cuda_bwd.RASTERIZE_BWD.launches - before[1]))
        hist.append(m)
        if densifies:
            print(f"  step {it}: densify/prune n_alive {alive} -> "
                  f"{int(trainer.scene.num_alive)} (capacity {trainer.scene.capacity})")
    torch.cuda.synchronize()
    launches8 = (rasterize_cuda.RASTERIZE_FWD.launches,
                 rasterize_cuda_bwd.RASTERIZE_BWD.launches)
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    for k in range(0, n_steps + n_dist, n_views):
        ms = hist[k:k + n_views]
        print(f"  steps {k + 1}-{k + len(ms)}: loss "
              + " ".join(f"{x['loss']:.5f}" for x in ms)
              + f"; psnr " + " ".join(f"{x['psnr']:.3f}" for x in ms))
    n_total = n_steps + n_dist
    check(launches8 == (n_total, n_total) and per_step == {(1, 1)},
          f"training launched B1 {launches8[0]} and B2 {launches8[1]} times over "
          f"{n_total} steps, (B1, B2) per step {sorted(per_step)} (one each per step "
          f"expected)")
    check(all(np.isfinite(x["loss"]) and np.isfinite(x["psnr"]) for x in hist),
          "every training loss and PSNR is finite")
    # Each run of n_views steps visits every view once (a permutation), so the
    # first and last such cycles of the 30 steps compare like with like.
    first = hist[:n_views]
    last = hist[n_steps - n_views:n_steps]
    loss0, loss1 = (float(np.mean([x["loss"] for x in c])) for c in (first, last))
    psnr0, psnr1 = (float(np.mean([x["psnr"] for x in c])) for c in (first, last))
    check(loss1 < loss0, f"mean loss over the last view cycle {loss1:.5f} < first {loss0:.5f}")
    check(psnr1 > psnr0, f"mean PSNR over the last view cycle {psnr1:.3f} > first {psnr0:.3f}")
    check(hist[n_steps - 1]["loss"] < hist[0]["loss"],
          f"last loss {hist[n_steps - 1]['loss']:.5f} < first {hist[0]['loss']:.5f}")
    check(hist[n_steps - 1]["psnr"] > hist[0]["psnr"],
          f"last PSNR {hist[n_steps - 1]['psnr']:.3f} > first {hist[0]['psnr']:.3f}")
    print(f"  peak memory {peak8:.2f} GiB")
    # B1 and B2 skip entries by their reach boxes on every step, so the boxes
    # are checked on the scene training left too (view 0, seeded cotangents).
    with torch.no_grad():
        b8t, t8t = kernel_inputs(camera_at(cams8, 0), trainer.scene)
        fwd_activity("trained scene", b8t, t8t, plain_walk(b8t, t8t, w8, h8), w8, h8)
        walk_activity("trained scene", bwd_inputs(b8t, t8t, w8, h8, False, 8))
        del b8t, t8t

    print("== phase 9: training timing")
    plain_steps = [t for t, d, dist in step_ms[2:] if not d and not dist]
    dist_steps = [t for t, d, dist in step_ms[n_steps:] if not d]
    dens_steps = [t for t, d, _ in step_ms if d]
    print(f"  train step (host clock, synchronized): median {np.median(plain_steps):.3f} ms "
          f"over {len(plain_steps)} steps without densify (steps 3-{n_steps}); with "
          f"distortion median {np.median(dist_steps):.3f} ms; with densify "
          + ", ".join(f"{t:.1f}" for t in dens_steps) + " ms")
    trainer.cfg = trainer.cfg.replace(lambda_dist=0.0)
    splits = [timed_step(trainer) for _ in range(4)][1:]
    split = {k: float(np.median([s_[k] for s_ in splits])) for k in splits[0]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.densify(trainer.iteration)
    torch.cuda.synchronize()
    split["densify"] = (time.perf_counter() - t0) * 1e3
    print("  step split ms (CUDA events, median of 3; densify: one call, host clock): "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items()))
    with torch.no_grad():
        print(f"  training shape (the first step's scene, view 0): {b8.gauss_id.numel()} entries, "
              f"densest tile {int(b8.tile_count.max())}")
        act8 = fwd_activity("training shape", b8, t8, plain_walk(b8, t8, w8, h8), w8, h8)
        print_b1_walk("training shape", act8, b8, modes=("nodist", "full"))
        b1_bound("training shape", act8[0], b8.tile_count.numel(), w8, h8)
        runs8 = bwd_vs_plain("training shape", b8, t8, w8, h8)
        rows8 = {}
        for want_dist, (args, stats) in runs8.items():
            mode = "full" if want_dist else "nodist"
            walks = walk_histogram(args)
            print(f"  B2 [{mode}] walk per tile (entries): " + ", ".join(
                f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}" for k, v in walks.items())
                + f"; max/mean {walks['max'] / walks['mean']:.2f}")
            info = rasterize_cuda_bwd.kernel_info(want_dist)
            print(f"  B2 [{mode}] walk kernel on {info['sms']} SMs: {info['registers']} "
                  f"registers, {info['spill_bytes']} B spilled, {info['shared_bytes']} B "
                  f"shared, {info['blocks_per_sm']} blocks per SM")
            if not want_dist:
                walk_activity("training shape", args)
            worklist_vs_plain("training shape", args, want_dist)
            k_ms = b2_ms(args, want_dist)
            p_ms = cuda_ms(lambda: rasterize_cuda_bwd.rasterize_backward_plain(
                *args, want_dist=want_dist, max_elems=PLAIN_BWD_ELEMS), reps=1, warmup=0)
            bound, by = bwd_bound(stats, w8, h8, b8.tile_count.numel(), want_dist)
            f_ms = cuda_ms(lambda: rasterize_cuda.rasterize_entries(
                *args[:4], args[6], w8, h8, want_aux=True, want_dist=want_dist))
            rows8[mode] = (k_ms, p_ms, bound, by)
            print(f"  B2 [{mode}] kernel {k_ms:.4f} ms (whole call)  plain {p_ms:.2f} ms  "
                  f"bound {bound:.4f} ms ({by}); B1 [{mode}] at this shape {f_ms:.4f} ms")
    print("  B2 library_ms: none (no single PyTorch call computes this function)")

    print("== phase 10: B3 (attention) vs its plain version (chunked_attention); "
          f"tolerance max|kernel - plain| <= {B3_TOL} * max|plain|, and at ±30 logits "
          f"max|kernel - ref64| <= max({B3_TOL} * max|ref64|, {B3_TOL64} * max|plain - ref64|)")
    scene8, images8 = trainer.scene, views8.image
    del trainer, views8, b8, t8, runs8
    torch.cuda.empty_cache()
    from g4splat_torch.ops import attention_cuda
    from g4splat_torch.ops.attention import chunked_attention
    from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint

    n_ref, n_warp, res, n_steps = SEE3D_SHAPE
    n_frames = n_ref + n_warp
    priors = see3d_priors(3, n_steps)
    ucfg = priors.see3d.unet.cfg
    n_calls = len(priors.see3d.sampler.timesteps)
    main_launches = b3_main_launches(ucfg, n_frames, res // priors.vae.factor, n_calls)
    rows10, err10 = attention_vs_plain(main_launches)

    print(f"== phase 11: See3D main path, full width: {n_ref} references + {n_warp} warps "
          f"at {res}x{res}, DDIM {n_steps} steps")
    refs, warps, masks = see3d_inputs(scene, n_ref, n_warp, res)
    print(f"  inputs rendered by B1 from the phase-4 scene; visible share of each warp "
          + " ".join(f"{float(m.mean()):.3f}" for m in masks))
    print(f"  timesteps {priors.see3d.sampler.timesteps.tolist()}: {n_calls} UNet calls over "
          f"{2 * n_frames} frames (cond + uncond)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rasterize_cuda.RASTERIZE_FWD.launches = 0
    rasterize_cuda_bwd.RASTERIZE_BWD.launches = 0
    attention_cuda.ATTENTION_FWD.launches = 0
    tf32_seen = set()
    spy = priors.see3d.unet.register_forward_pre_hook(lambda *_: tf32_seen.add(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    t0 = time.perf_counter()
    outs11, _ = run_see3d_inpaint(priors, refs, n_ref, warps, masks, stage=1,
                                  mvd_resolution=res, device=DEVICE)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    spy.remove()
    check(tf32_seen == {(False, False)} and tf32 == (torch.backends.cuda.matmul.allow_tf32,
                                                     torch.backends.cudnn.allow_tf32),
          f"the stage ran the UNet with TF32 (matmul, cuDNN) {sorted(tf32_seen)} (off "
          f"expected) and gave back the caller's flags {tf32}")
    launches11 = attention_cuda.ATTENTION_FWD.launches
    peak11 = torch.cuda.max_memory_allocated() / 2**30
    expect = 2 * ucfg.n_transformer_blocks() * n_calls
    check(launches11 == expect == sum(main_launches.values()),
          f"See3D stage launched B3 {launches11} times ({expect} expected: "
          f"{2 * ucfg.n_transformer_blocks()} per UNet call x {n_calls} calls)")
    check((rasterize_cuda.RASTERIZE_FWD.launches, rasterize_cuda_bwd.RASTERIZE_BWD.launches)
          == (0, 0), "See3D stage launched no rasterizer kernel")
    check(len(outs11) == n_warp and all(o.shape == (res, res, 3) and bool(torch.isfinite(o).all())
                                        for o in outs11),
          f"{n_warp} finite ({res}, {res}, 3) images")
    print(f"  stage {stage_ms:.1f} ms (host clock, synchronized); peak memory {peak11:.2f} GiB")
    outs11p, _ = run_see3d_inpaint(priors, refs, n_ref, warps, masks, stage=1,
                                   mvd_resolution=res, attention=chunked_attention,
                                   device=DEVICE)
    torch.cuda.synchronize()
    d_img = max(float((a - b).abs().max()) for a, b in zip(outs11, outs11p))
    spread = float(torch.stack(outs11p).std())
    check(d_img <= SEE3D_IMG_TOL,
          f"See3D images with B3 vs plain attention: max|d| {d_img:.2e} <= {SEE3D_IMG_TOL} "
          f"(plain images' std {spread:.3f})")
    check(max(float((o - w).abs().mean()) for o, w in zip(outs11, warps)) > 1e-2,
          "the stage's images differ from its warps")

    print("== phase 12: See3D timing")
    torch.cuda.reset_peak_memory_stats()
    split12, lat_k, lat_p = see3d_split(priors, refs, warps, masks, n_ref)
    gen_k, gen_p = lat_k[n_ref:], lat_p[n_ref:]
    r12 = float((gen_k - gen_p).norm() / gen_p.norm())
    check(bool(torch.isfinite(lat_k).all()) and r12 <= SEE3D_LAT_TOL,
          f"DDIM latents with B3 vs plain attention (generated frames): ||d|| / ||plain|| "
          f"{r12:.2e} <= {SEE3D_LAT_TOL} (||plain|| {float(gen_p.norm()):.3e})")
    print("  split ms (CUDA events): " + "; ".join(f"{k} {v:.1f}" for k, v in split12.items()))
    print(f"  stage total {stage_ms:.1f} ms; peak memory over the split "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del priors, refs, warps, masks, outs11, outs11p, lat_k, lat_p, gen_k, gen_p
    torch.cuda.empty_cache()

    print(f"== phase 13: render_all and eval on phase 8's trained scene "
          f"({int(scene8.num_alive)} live splats in {scene8.capacity} slots, SH "
          f"{scene8.active_sh_degree}), {cams8.w2c.shape[0]} views at {w8}x{h8}")
    launches13 = render_all_phase(scene8, cams8, images8)
    del scene8, images8
    torch.cuda.empty_cache()

    print(f"== phase 14: mesh main path at production settings (box room, "
          f"{MESH_DENSITY} splats per m²)")
    t0 = time.perf_counter()
    mesh14 = mesh_phase()
    print(f"  phase 14 {time.perf_counter() - t0:.1f} s")

    print("== phase 15: mesh timings")
    print_mesh_timings(mesh14)
    torch.cuda.empty_cache()

    print(f"== phase 16: one See3D loop through G4SplatPipeline, full width ({LOOP_DA2} "
          f"DepthAnything V2, MVDream See3D), production PipelineConfig save "
          f"{LOOP_ITERATIONS} steps per train_gaussians and {SEE3D_SHAPE[3] + 1} DDIM timesteps")
    loop16 = see3d_loop_phase()
    print_see3d_loop(loop16)
    torch.cuda.empty_cache()

    print(f"== phase 17: G4SplatPipeline.run() from {FRONT_VIEWS[0]} posed photos at "
          f"{FRONT_VIEWS[1]}x{FRONT_VIEWS[2]} (MASt3R at full width, SfM, charts, one See3D "
          f"stage, the multires mesh, eval)")
    front17 = front_end_phase()
    print_front_end(front17)
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", *failures, sep="\n  ")
        return 1
    # B1: one launch of the render main path = its two modes at frame 0,
    # averaged; its launches are those of the render, training, render_all /
    # eval and mesh paths.
    main_ms = float(np.mean([rows4[m][0] for m in ("infer", "nodist")]))
    main_plain = float(np.mean([rows4[m][1] for m in ("infer", "nodist")]))
    fwd, bwd = rasterize_cuda.RASTERIZE_FWD, rasterize_cuda_bwd.RASTERIZE_BWD
    # B2: the training path's production mode (no distortion).
    k_ms, p_ms, bound8, by8 = rows8["nodist"]
    # B3: the See3D self-attention at full resolution, the main path's
    # largest shape.
    att = attention_cuda.ATTENTION_FWD
    a_ms, a_plain, a_lib, a_bound, a_by = rows10[B3_SHAPES[0]]
    print(json.dumps({"kernels": [
        {"name": fwd.name, "route": "cuda", "source": fwd.source, "replaces": fwd.replaces,
         "launches": launches + launches8[0] + launches13 + mesh14["launches"]
                     + loop16["launches"][0] + front17["launches"][0],
         "max_abs_err": max_abs_err, "ms": main_ms,
         "plain_ms": main_plain, "bound_ms": bound4, "bound_by": by4, "library_ms": None},
        {"name": bwd.name, "route": "cuda", "source": bwd.source, "replaces": bwd.replaces,
         "launches": launches8[1] + loop16["launches"][1] + front17["launches"][1],
         "max_abs_err": max_abs_err_bwd,
         "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": bound8, "bound_by": by8, "library_ms": None},
        {"name": att.name, "route": "cuda", "source": att.source, "replaces": att.replaces,
         "launches": launches11 + loop16["launches"][2] + front17["launches"][2],
         "max_abs_err": err10, "ms": a_ms,
         "plain_ms": a_plain,
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": a_lib}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
