"""Tile binning, and tile-binned differentiable compositing in plain PyTorch
(counterpart of `g4splat_tpu.ops.rasterize_tiled`).

Binning follows the reference's pipeline (rasterizer_impl.cu:198-342): each
splat is duplicated into the tiles of its dual-conic rect, the (tile, depth)
keys are sorted, and each tile gets its contiguous [start, start+count) range.
Unlike the JAX package, which packs 31-bit keys with depth quantized below the
tile bits into a static buffer, the port sorts int64 keys on EXACT depth (tile
id in the high 32 bits, the float bits of the positive depth below; ties break
by splat index) into an exactly sized entry list, so no entry ever overflows.
`bin_splats` dispatches on the tensors' device: on CUDA tensors it runs the
kernel chain of `csrc/binning.cu` (one thread per splat, the candidate test
in registers), on CPU tensors `bin_splats_plain`, its plain version over the
(P, cap) candidate slots. Both give the same binning, bit for bit.

The tiled compositing (`_render_tiles`) is autograd-differentiable and keeps
only the front-most `tile_k` entries of each tile; the CUDA kernel in
`rasterize_cuda` consumes the same binning without that cap.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from g4splat_torch.ops.cuda_build import KernelInfo
from g4splat_torch.ops.rasterize_common import (
    ALPHA_EPS,
    FAR_N,
    FILTER_INV_SQUARE,
    NEAR_N,
    TILE,
    Preprocessed,
    alpha_depth,
    tile_rect,
)
from g4splat_torch.ops.rasterize_dense import composite
from g4splat_torch.utils.profiling import annotate, annotated, count

MAX_TILES_PER_SPLAT = 16   # splats covering more tiles are truncated
TILE_K = 1024              # `tiled` backend: max splats composited per tile

BINNING = KernelInfo(
    name="binning",
    source="g4splat_torch/csrc/binning.cu",
    replaces="g4splat_tpu/ops/rasterize_tiled.py:242",
)


class Binning(NamedTuple):
    gauss_id: torch.Tensor     # (E,) int32 splat of each entry, sorted by (tile, depth)
    tile_id: torch.Tensor      # (E,) int32 tile of each entry
    tile_start: torch.Tensor   # (n_tiles,) int32
    tile_count: torch.Tensor   # (n_tiles,) int32
    n_dropped: torch.Tensor    # () int32 — entries lost to the per-splat cap
    n_overflow: torch.Tensor   # () int32 — always 0 (the entry list is exact)


def _tau(opacity: torch.Tensor) -> torch.Tensor:
    """The ellipse test's threshold on rho, 2·ln(opacity/ALPHA_EPS) + 0.05."""
    return 2.0 * torch.log(torch.clamp(opacity, min=1e-12) / ALPHA_EPS) + 0.05


def _ellipse_keep(prep: Preprocessed, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Exact tile-level contribution test for candidate (splat, tile) pairs.

    Keeps a candidate iff some point of the tile's pixel rect can reach
    alpha ≥ 1/255 through either path the kernel evaluates:

    - 2D low-pass: rho2d = FILTER_INV_SQUARE · d², minimized over the rect by
      clamping the center.
    - 3D ray-splat: rho3d = (p0² + p1²)/p2² with p_i affine in pixel coords,
      so {rho3d ≤ τ} is the quadratic q = p0² + p1² − τ·p2² ≤ 0, whose min
      over a rect is at a corner, an edge stationary point, or the interior
      stationary point (PD Hessian only).

    τ = 2·ln(opacity/ALPHA_EPS) + 0.05 (f32-rounding margin). The continuous
    rect contains the pixel lattice, so pruning is conservative and exact
    against the dense oracle. Returns a bool (P, cap) keep mask.
    """
    T = prep.T
    Tu0, Tu1, Tu2 = T[:, 0, 0], T[:, 0, 1], T[:, 0, 2]
    Tv0, Tv1, Tv2 = T[:, 1, 0], T[:, 1, 1], T[:, 1, 2]
    Tw0, Tw1, Tw2 = T[:, 2, 0], T[:, 2, 1], T[:, 2, 2]
    A0 = Tw2 * Tv1 - Tw1 * Tv2
    B0 = Tu2 * Tw1 - Tu1 * Tw2
    C0 = Tu1 * Tv2 - Tu2 * Tv1
    A1 = Tw0 * Tv2 - Tw2 * Tv0
    B1 = Tu0 * Tw2 - Tu2 * Tw0
    C1 = Tu2 * Tv0 - Tu0 * Tv2
    A2 = Tw1 * Tv0 - Tw0 * Tv1
    B2 = Tu1 * Tw0 - Tu0 * Tw1
    C2 = Tu0 * Tv1 - Tu1 * Tv0
    # Per-splat normalization keeps q's 4th-power-of-T terms in f32 range
    # (uniform scaling of all nine coefficients preserves q's sign).
    m = torch.clamp(torch.stack([A0, B0, C0, A1, B1, C1, A2, B2, C2], 1)
                    .abs().max(dim=1).values, min=1e-30)
    A0, B0, C0 = A0 / m, B0 / m, C0 / m
    A1, B1, C1 = A1 / m, B1 / m, C1 / m
    A2, B2, C2 = A2 / m, B2 / m, C2 / m

    t_ = _tau(prep.opacity)[:, None]

    Hxx = (A0 * A0 + A1 * A1)[:, None] - t_ * (A2 * A2)[:, None]
    Hxy = (A0 * B0 + A1 * B1)[:, None] - t_ * (A2 * B2)[:, None]
    Hyy = (B0 * B0 + B1 * B1)[:, None] - t_ * (B2 * B2)[:, None]
    Gx = (A0 * C0 + A1 * C1)[:, None] - t_ * (A2 * C2)[:, None]
    Gy = (B0 * C0 + B1 * C1)[:, None] - t_ * (B2 * C2)[:, None]
    K = (C0 * C0 + C1 * C1)[:, None] - t_ * (C2 * C2)[:, None]

    x0 = (tx * TILE).to(torch.float32)
    x1 = x0 + (TILE - 1)
    y0 = (ty * TILE).to(torch.float32)
    y1 = y0 + (TILE - 1)

    def q(x, y):
        return (Hxx * x * x + 2.0 * (Hxy * x * y + Gx * x + Gy * y)
                + Hyy * y * y + K)

    with annotate("g4s:sync.ellipse"):
        inf = torch.tensor(torch.inf, device=T.device)
    qmin = torch.minimum(torch.minimum(q(x0, y0), q(x0, y1)),
                         torch.minimum(q(x1, y0), q(x1, y1)))
    # Edge stationary points (when the 1D leading coefficient is ≤ 0 the edge
    # minimum sits at a corner already covered).
    sHyy = torch.where(Hyy > 0, Hyy, 1.0)
    for xe in (x0, x1):
        ye = torch.clamp(-(Hxy * xe + Gy) / sHyy, y0, y1)
        qmin = torch.minimum(qmin, torch.where(Hyy > 0, q(xe, ye), inf))
    sHxx = torch.where(Hxx > 0, Hxx, 1.0)
    for ye in (y0, y1):
        xe = torch.clamp(-(Hxy * ye + Gx) / sHxx, x0, x1)
        qmin = torch.minimum(qmin, torch.where(Hxx > 0, q(xe, ye), inf))
    det = Hxx * Hyy - Hxy * Hxy
    pd = (Hxx > 0) & (det > 0)
    sdet = torch.where(pd, det, 1.0)
    xi = torch.clamp((Hxy * Gy - Hyy * Gx) / sdet, x0, x1)
    yi = torch.clamp((Hxy * Gx - Hxx * Gy) / sdet, y0, y1)
    qmin = torch.minimum(qmin, torch.where(pd, q(xi, yi), inf))
    keep3d = qmin <= 0.0

    cx = prep.center[:, 0:1]
    cy = prep.center[:, 1:2]
    dx = torch.clamp(cx, x0, x1) - cx
    dy = torch.clamp(cy, y0, y1) - cy
    keep2d = FILTER_INV_SQUARE * (dx * dx + dy * dy) <= t_

    return (keep3d | keep2d) & (prep.opacity >= ALPHA_EPS)[:, None]


@annotated("g4s:render.binning")
def bin_splats(
    prep: Preprocessed,
    width: int,
    height: int,
    max_tiles_per_splat: int = MAX_TILES_PER_SPLAT,
    ellipse_prune: bool = True,
) -> Binning:
    """Duplicate each splat into its touched tiles and sort by (tile, depth).

    Candidate slots are the splat's rect tiles in row-major order
    (tx = rmin_x + slot % rw, ty = rmin_y + slot // rw), cut at
    `max_tiles_per_splat`; the cut slots are counted in `n_dropped`.

    On CUDA tensors the kernel chain of `csrc/binning.cu` runs; on CPU tensors
    `bin_splats_plain`. Both give the same binning, bit for bit.
    """
    if prep.depth.is_cuda:
        return _bin_splats_cuda(prep, width, height, max_tiles_per_splat, ellipse_prune)
    return bin_splats_plain(prep, width, height, max_tiles_per_splat, ellipse_prune)


def bin_splats_plain(
    prep: Preprocessed,
    width: int,
    height: int,
    max_tiles_per_splat: int = MAX_TILES_PER_SPLAT,
    ellipse_prune: bool = True,
) -> Binning:
    """`bin_splats` in plain PyTorch over the (P, cap) candidate slots, on any
    device: the version the kernel chain is held to."""
    prep = Preprocessed(**{k: v.detach() for k, v in prep.__dict__.items()})
    P = prep.depth.shape[0]
    dev = prep.depth.device
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    n_tiles = gx * gy
    cap = max_tiles_per_splat

    rmin_x, rmin_y, rmax_x, rmax_y = tile_rect(prep.center, prep.radius, gx, gy)
    rw = rmax_x - rmin_x
    rh = rmax_y - rmin_y
    counts = torch.where(prep.valid, rw * rh, 0)
    counts_cap = torch.clamp(counts, max=cap)

    slots = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    safe_rw = torch.clamp(rw, min=1)[:, None]
    tx = rmin_x[:, None] + slots % safe_rw
    ty = rmin_y[:, None] + slots // safe_rw
    tid = ty * gx + tx                                    # (P, cap)
    slot_valid = slots < counts_cap[:, None]
    if ellipse_prune:
        slot_valid = slot_valid & _ellipse_keep(prep, tx, ty)

    # Exact-depth keys: valid splats have depth ≥ 0.2 > 0, so the float's
    # bit pattern orders like the float itself.
    dbits = prep.depth.contiguous().view(torch.int32).to(torch.int64)
    keys = (tid.to(torch.int64) << 32) | dbits[:, None]
    with annotate("g4s:sync.binning"):
        flat = torch.nonzero(slot_valid.reshape(-1)).squeeze(1)   # row-major (splat, slot)
    count("render.binned_entries", flat.numel())
    count("render.binnings")
    keys_sorted, perm = torch.sort(keys.reshape(-1)[flat], stable=True)
    gid_sorted = (flat[perm] // cap).to(torch.int32)
    tile_sorted = (keys_sorted >> 32).to(torch.int32)

    tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tiles, right=False).to(torch.int32)
    tile_end = torch.searchsorted(tile_sorted, tiles, right=True).to(torch.int32)
    return Binning(
        gauss_id=gid_sorted,
        tile_id=tile_sorted,
        tile_start=tile_start,
        tile_count=tile_end - tile_start,
        n_dropped=(counts - counts_cap).sum().to(torch.int32),
        n_overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _lib():
    """The binning kernels' library, its ctypes signatures declared once."""
    from g4splat_torch.ops.cuda_build import load

    lib = load("binning")
    if not getattr(lib, "_g4_bound", False):
        splat_args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        lib.g4_bin_count.argtypes = splat_args + [ctypes.c_void_p] * 3
        lib.g4_bin_emit.argtypes = splat_args + [ctypes.c_void_p] * 4
        lib.g4_bin_ranges.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                      + [ctypes.c_void_p] * 5)
        for fn in (lib.g4_bin_count, lib.g4_bin_emit, lib.g4_bin_ranges):
            fn.restype = ctypes.c_int
        lib._g4_bound = True
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"binning {what} launch failed: CUDA error {err}")


def _bin_splats_cuda(prep: Preprocessed, width: int, height: int, cap: int,
                     ellipse_prune: bool) -> Binning:
    """The kernel chain: count, prefix sum, one read of the total, emit,
    stable sort, ranges (csrc/binning.cu)."""
    P = prep.depth.shape[0]
    dev = prep.depth.device
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    n_tiles = gx * gy
    for k in ("T", "center", "radius", "opacity", "depth"):
        if getattr(prep, k).dtype != torch.float32:
            raise ValueError(f"binning on the card takes float32 splats, got {k} "
                             f"{getattr(prep, k).dtype}")
    if prep.T.shape != (P, 3, 3):
        raise ValueError(f"T must be (P, 3, 3), got {tuple(prep.T.shape)}")
    if prep.valid.dtype != torch.bool:
        raise ValueError(f"binning on the card takes a bool valid mask, got {prep.valid.dtype}")
    # Tau by the plain version's own torch ops, so both tests compare with the
    # same value (the kernel's logf need not round as torch's log does).
    tau = _tau(prep.opacity.detach()) if ellipse_prune else prep.opacity   # else not read
    # T and depth are read through their strides (preprocess leaves both
    # strided); the rest as contiguous rows.
    T, depth = prep.T, prep.depth
    ins = [T] + [t.contiguous() for t in (prep.center, prep.radius, prep.opacity, tau)]
    ins += [depth, prep.valid.contiguous()]
    strides = (ctypes.c_int * 4)(*T.stride(), depth.stride(0))
    splat_args = ([t.data_ptr() for t in ins] + [ctypes.addressof(strides)]
                  + [P, gx, gy, cap, int(bool(ellipse_prune))])
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)    # n_dropped, n_overflow
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.g4_bin_count(*splat_args, counts.data_ptr(), flags.data_ptr(), stream),
               "count")
        incl = torch.cumsum(counts, 0)                       # int64
        with annotate("g4s:sync.binning"):
            E = int(incl[-1]) if P else 0
        keys = torch.empty(E, dtype=torch.int64, device=dev)
        ids = torch.empty(E, dtype=torch.int32, device=dev)
        _check(lib.g4_bin_emit(*splat_args, incl.data_ptr(), keys.data_ptr(), ids.data_ptr(),
                               stream), "emit")
        keys_sorted, perm = torch.sort(keys, stable=True)
        gauss_id = torch.empty(E, dtype=torch.int32, device=dev)
        tile_id = torch.empty(E, dtype=torch.int32, device=dev)
        tile_start = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        tile_count = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        _check(lib.g4_bin_ranges(keys_sorted.data_ptr(), perm.data_ptr(), ids.data_ptr(), E,
                                 n_tiles, gauss_id.data_ptr(), tile_id.data_ptr(),
                                 tile_start.data_ptr(), tile_count.data_ptr(), stream),
               "ranges")
    BINNING.count_launch()
    count("render.binned_entries", E)
    count("render.binnings")
    count("render.binnings_kernel")
    return Binning(gauss_id=gauss_id, tile_id=tile_id, tile_start=tile_start,
                   tile_count=tile_count, n_dropped=flags[0], n_overflow=flags[1])


def assemble_tiles(flat: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(n_tiles, TILE·TILE[, C]) per-tile maps → (H, W[, C]) image."""
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    ch = tuple(flat.shape[2:])
    img = flat.reshape((gy, gx, TILE, TILE) + ch).transpose(1, 2)
    return img.reshape((gy * TILE, gx * TILE) + ch)[:height, :width]


def disassemble_tiles(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(H, W[, C]) image → (n_tiles, TILE·TILE[, C]) per-tile maps, zeros on
    the pixels past the image edge (inverse of `assemble_tiles`)."""
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    ch = tuple(img.shape[2:])
    pad = img.new_zeros((gy * TILE, gx * TILE) + ch)
    pad[:height, :width] = img
    return pad.reshape((gy, TILE, gx, TILE) + ch).transpose(1, 2).reshape(
        (gy * gx, TILE * TILE) + ch)


def _render_tiles(prep: Preprocessed, binning: Binning, bg: torch.Tensor,
                  width: int, height: int, near: float, far: float,
                  tile_k: int, tile_batch: int):
    """Composite the front-most `tile_k` entries of every tile through the
    differentiable `composite`, `tile_batch` tiles at a time."""
    gx = (width + TILE - 1) // TILE
    n_tiles = gx * ((height + TILE - 1) // TILE)
    dev = prep.depth.device
    ly, lx = torch.meshgrid(torch.arange(TILE, dtype=torch.float32, device=dev),
                            torch.arange(TILE, dtype=torch.float32, device=dev),
                            indexing="ij")
    lx = lx.reshape(-1)
    ly = ly.reshape(-1)
    gauss_id = binning.gauss_id.long()
    if gauss_id.numel() == 0:
        gauss_id = torch.zeros(1, dtype=torch.long, device=dev)
    ks = torch.arange(tile_k, device=dev)

    def tile_batch_fn(t, T, center, opacity, valid, rgb, normal):
        start = binning.tile_start[t].long()
        count = torch.clamp(binning.tile_count[t], max=tile_k)
        in_range = ks[None, :] < count[:, None]                 # (B, K)
        gid = gauss_id[torch.clamp(start[:, None] + ks, max=gauss_id.numel() - 1)]
        px = lx + ((t % gx) * TILE)[:, None]                     # (B, 256)
        py = ly + ((t // gx) * TILE)[:, None]
        alpha, depth = alpha_depth(T[gid], center[gid], opacity[gid],
                                   valid[gid] & in_range, px, py, near)
        out = composite(alpha, depth, rgb[gid], normal[gid], bg, near=near, far=far)
        return (out.color, out.normal, out.depth_acc, out.alpha, out.median_depth,
                out.distortion, out.final_T, out.n_contrib, out.m1_tot, out.m2_tot)

    fields = (prep.T, prep.center, prep.opacity, prep.valid, prep.rgb, prep.normal)
    results = []
    for b0 in range(0, n_tiles, tile_batch):
        t = torch.arange(b0, min(b0 + tile_batch, n_tiles), device=dev)
        if torch.is_grad_enabled():
            # Recompute the (B, tile_k, 256) intermediates in the backward
            # pass instead of keeping every batch's alive at once.
            results.append(checkpoint(tile_batch_fn, t, *fields, use_reentrant=False))
        else:
            results.append(tile_batch_fn(t, *fields))
    maps = [assemble_tiles(torch.cat(parts), width, height)
            for parts in zip(*results)]
    (color, normal, depth_acc, alpha, med, dist, final_T, n_contrib,
     m1_tot, m2_tot) = maps
    return dict(color=color, normal=normal, depth_acc=depth_acc, alpha=alpha,
                median_depth=med, distortion=dist, final_T=final_T,
                n_contrib=n_contrib, m1_tot=m1_tot, m2_tot=m2_tot)


def render_tiled(camera, prep: Preprocessed, bg: torch.Tensor,
                 near: float = NEAR_N, far: float = FAR_N, tile_k: int = TILE_K,
                 tile_batch: int = 16,
                 max_tiles_per_splat: int = MAX_TILES_PER_SPLAT,
                 ellipse_prune: bool = True):
    """Bin and composite; returns (maps dict, binning)."""
    binning = bin_splats(prep, camera.width, camera.height,
                         max_tiles_per_splat=max_tiles_per_splat,
                         ellipse_prune=ellipse_prune)
    maps = _render_tiles(prep, binning, bg, camera.width, camera.height,
                         near, far, tile_k, tile_batch)
    return maps, binning
