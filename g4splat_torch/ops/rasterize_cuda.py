"""Forward surfel compositing over a tile-binned entry list: the CUDA kernel
`csrc/rasterize_fwd.cu` and its plain PyTorch version (counterpart of
`g4splat_tpu.ops.rasterize_pallas`).

Kernel B1 replaces `g4splat_tpu/ops/rasterize_pallas.py::_render_kernel`.
What bounds it on an H100: per (pixel, entry) pair walked it does
`OPS_PER_PAIR` fp32 operations, against 64 bytes per entry row a tile must
read and `OUT_BYTES_PER_PIXEL` per pixel written once. A tile needs only the
entries up to the point where its last pixel saturates, a few hundred in the
frames measured (PERF.md), so the arithmetic on the pairs walked binds, at
2.4M splats as at 200k. The design keeps every per-pair operand on chip:
per-entry terms and each entry's reach box are computed once per tile batch
into shared memory and read as broadcasts, a warp walks only the entries
whose box meets its pixels, each pixel stops at T < 1e-4, and a block-wide
vote ends the walk of a saturated tile.

`rasterize_entries` dispatches on the tensors' device: on CUDA tensors it
launches the kernel (or raises), on CPU tensors it runs the plain version.
There is no fallback from one to the other.

`rasterize_diff` is the differentiable composite: one `torch.autograd.Function`
that builds the splat table and runs B1 forward, and runs B2
(`rasterize_cuda_bwd`) backward (counterpart of `_render_pallas_diff`).

Both kernels read entry i of a tile's range as row `gauss_id[i]` of the
per-splat table (`splat_table`), `rasterize_common.ENTRY_F` (16) float32
columns per splat: 0-8 T (rows Tu, Tv, Tw), 9 opacity (0 for culled
splats), 10-12 rgb, 13-15 view-space normal. The low-pass centre is
recomputed from T. No per-entry rows are gathered: a caller that holds
per-entry rows passes them as the table with `gauss_id = arange(E)`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from g4splat_torch.ops.cuda_build import KernelInfo
from g4splat_torch.ops.rasterize_common import (
    ENTRY_F,
    FAR_N,
    NEAR_N,
    TILE,
    Preprocessed,
    alpha_depth,
    conic_center,
)
from g4splat_torch.ops.rasterize_cuda_bwd import COT_C, rasterize_backward
from g4splat_torch.ops.rasterize_dense import composite
from g4splat_torch.ops.rasterize_tiled import Binning, assemble_tiles

NPIX = TILE * TILE
# Output channels of the float map, in the kernel's order.
OUT_C = 13
CH_COLOR, CH_NORMAL = slice(0, 3), slice(3, 6)
CH_DEPTH, CH_ALPHA, CH_DIST, CH_MEDIAN, CH_FINAL_T, CH_M1, CH_M2 = range(6, 13)
# fp32 operations per (pixel, entry) pair walked: k and l (12), their cross
# product (9), the |p2| test (1), reciprocal (1), su/sv (2), rho3d (3), dx/dy
# (2), rho2d (4), min/select (2), z (4), exp argument and exp (2), alpha (2) —
# the cost of every pair walked, contributors or not; a contributor's
# composite update adds a further ~20.
OPS_PER_PAIR = 44
OUT_BYTES_PER_PIXEL = OUT_C * 4 + 4


RASTERIZE_FWD = KernelInfo(
    name="rasterize_fwd",
    source="g4splat_torch/csrc/rasterize_fwd.cu",
    replaces="g4splat_tpu/ops/rasterize_pallas.py:135",
)


def splat_table(prep: Preprocessed) -> torch.Tensor:
    """The (P, 16) per-splat table the kernels read through gauss_id (culled
    splats carry zero opacity)."""
    return _table(prep.T, prep.valid, prep.opacity, prep.rgb, prep.normal)


def _table(T, valid, opacity, rgb, normal):
    opa = torch.where(valid, opacity, 0.0)
    table = torch.cat([T.reshape(T.shape[0], 9), opa[:, None], rgb, normal], 1)
    return table.to(torch.float32).contiguous()


def _maps(out: torch.Tensor, n_contrib: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(
        color=out[..., CH_COLOR], normal=out[..., CH_NORMAL],
        depth_acc=out[..., CH_DEPTH], alpha=out[..., CH_ALPHA],
        distortion=out[..., CH_DIST], median_depth=out[..., CH_MEDIAN],
        final_T=out[..., CH_FINAL_T], m1_tot=out[..., CH_M1],
        m2_tot=out[..., CH_M2], n_contrib=n_contrib,
    )


def check_table(table: torch.Tensor, gauss_id: torch.Tensor):
    """Refuse a table that is not (P, 16) float32 or a gauss_id that is not
    (E,) int32 on the table's device. The ids are not read (that would take
    a host sync): the caller guarantees 0 <= gauss_id < P. The kernels read
    row gauss_id[i] unchecked, so an id out of range reads outside the
    table; the plain versions raise on it."""
    if table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] != ENTRY_F:
        raise ValueError(f"table must be (P, {ENTRY_F}) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if gauss_id.dtype != torch.int32 or gauss_id.ndim != 1:
        raise ValueError(f"gauss_id must be (E,) int32, got {tuple(gauss_id.shape)} "
                         f"{gauss_id.dtype}")
    if gauss_id.device != table.device:
        raise ValueError(f"gauss_id lies on {gauss_id.device}, the table on {table.device}")


def _check_inputs(table, gauss_id, tile_start, tile_count, bg, width, height):
    n_tiles = ((width + TILE - 1) // TILE) * ((height + TILE - 1) // TILE)
    check_table(table, gauss_id)
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.dtype != torch.int32 or t.shape != (n_tiles,):
            raise ValueError(f"{name} must be ({n_tiles},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if bg.shape != (3,):
        raise ValueError(f"bg must be (3,), got {tuple(bg.shape)}")
    devs = {t.device for t in (table, tile_start, tile_count, bg)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def rasterize_entries(table: torch.Tensor, gauss_id: torch.Tensor,
                      tile_start: torch.Tensor, tile_count: torch.Tensor,
                      bg: torch.Tensor, width: int, height: int, near: float = NEAR_N,
                      far: float = FAR_N, want_aux: bool = True, want_dist: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """Composite every tile's [start, start+count) entry range front to back,
    entry i being row gauss_id[i] of the (P, 16) splat table (0 <=
    gauss_id < P, not checked: see check_table).

    Returns (H, W[, C]) maps: color (bg added), normal, depth_acc, alpha,
    distortion, median_depth, final_T, n_contrib (int32), m1_tot, m2_tot.
    With want_aux=False, distortion, n_contrib and the moments are zeros;
    with want_dist=False, distortion and the moments are zeros.
    """
    _check_inputs(table, gauss_id, tile_start, tile_count, bg, width, height)
    if table.device.type == "cpu":
        maps = rasterize_entries_plain(table, gauss_id, tile_start, tile_count, bg, width,
                                       height, near, far, want_aux, want_dist)
        maps.pop("n_walked")
        return maps
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    return _rasterize_entries_cuda(table, gauss_id, tile_start, tile_count, bg, width,
                                   height, near, far, want_aux, want_dist)


def _lib():
    """The kernel's library, its ctypes signatures declared once per handle."""
    from g4splat_torch.ops.cuda_build import load

    lib = load("rasterize_fwd")
    if not getattr(lib, "_g4_bound", False):
        lib.g4_rasterize_fwd.argtypes = ([ctypes.c_void_p] * 5
                                         + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_int, ctypes.c_int]
                                         + [ctypes.c_void_p] * 3)
        lib.g4_rasterize_fwd.restype = ctypes.c_int
        lib.g4_rasterize_fwd_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.g4_rasterize_fwd_info.restype = ctypes.c_int
        lib._g4_bound = True
    return lib


def _rasterize_entries_cuda(table, gauss_id, tile_start, tile_count, bg, width, height,
                            near, far, want_aux, want_dist):
    dev = table.device
    ts = [t.contiguous() for t in (table, gauss_id, tile_start, tile_count,
                                   bg.to(torch.float32))]
    out = torch.empty((height, width, OUT_C), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().g4_rasterize_fwd(
            *(t.data_ptr() for t in ts), int(width), int(height), float(near), float(far),
            int(bool(want_aux)), int(bool(want_aux and want_dist)),
            out.data_ptr(), n_contrib.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd launch failed: CUDA error {err}")
    RASTERIZE_FWD.count_launch()
    return _maps(out, n_contrib)


def kernel_info(want_aux: bool, want_dist: bool) -> Dict[str, int]:
    """The mode's kernel: registers, spill bytes, static shared bytes and
    resident blocks per SM on the current card, and the card's SM count."""
    out = (ctypes.c_int * 5)()
    err = _lib().g4_rasterize_fwd_info(int(bool(want_aux)), int(bool(want_aux and want_dist)),
                                       ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"rasterize_fwd info failed: CUDA error {err}")
    keys = ("registers", "spill_bytes", "shared_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, out))


def rasterize_entries_plain(table: torch.Tensor, gauss_id: torch.Tensor,
                            tile_start: torch.Tensor, tile_count: torch.Tensor,
                            bg: torch.Tensor, width: int, height: int,
                            near: float = NEAR_N, far: float = FAR_N,
                            want_aux: bool = True, want_dist: bool = True,
                            chunk: int = 256, max_elems: int = 1 << 21
                            ) -> Dict[str, torch.Tensor]:
    """The kernel's function in plain PyTorch, with the same inputs and
    outputs, on any device.

    Tiles are walked in batches, densest first, so similar ranges share a
    batch; each batch walks its ranges in chunks of `chunk` entries through
    the dense oracle's `alpha_depth` and `composite`, carrying T and the
    moment sums between chunks. A (batch, chunk, 256) intermediate holds at
    most `max_elems` elements, so memory stays bounded however deep a tile
    is; a batch stops once all its pixels are saturated. Besides the
    kernel's maps it returns `n_walked`, the number of entries each pixel had
    to evaluate (up to and including the one that stops it), which counts
    the kernel's work. Each chunk reads its rows from the table through
    gauss_id, as the kernel does.
    """
    dev = table.device
    gx = (width + TILE - 1) // TILE
    n_tiles = gx * ((height + TILE - 1) // TILE)
    E = gauss_id.shape[0]
    gid = gauss_id.long()
    table = table.to(torch.float32)
    T_all = table[:, :9].reshape(table.shape[0], 3, 3)
    center_all, _, ok = conic_center(T_all)
    center_all = torch.where(ok[:, None], center_all, 0.0)   # as the kernel's
    no_bg = torch.zeros(3, device=dev)
    out = torch.zeros((n_tiles, NPIX, OUT_C), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((n_tiles, NPIX), dtype=torch.int32, device=dev)
    n_walked = torch.zeros((n_tiles, NPIX), dtype=torch.int32, device=dev)
    lin = torch.arange(NPIX, device=dev)
    lx = (lin % TILE).to(torch.float32)
    ly = (lin // TILE).to(torch.float32)
    ks = torch.arange(chunk, device=dev)
    order = torch.argsort(tile_count, descending=True, stable=True)
    tb = max(1, max_elems // (NPIX * chunk))

    for b0 in range(0, n_tiles, tb):
        t = order[b0:b0 + tb]
        nb = t.shape[0]
        cnt = tile_count[t].long()
        st = tile_start[t].long()
        px = ((t % gx) * TILE)[:, None] + lx                  # (nb, 256)
        py = ((t // gx) * TILE)[:, None] + ly
        done = (px >= width) | (py >= height)
        T = torch.ones((nb, NPIX), device=dev)
        color = torch.zeros((nb, NPIX, 3), device=dev)
        normal = torch.zeros((nb, NPIX, 3), device=dev)
        depth_acc, median, dist, M1, M2 = (torch.zeros((nb, NPIX), device=dev)
                                           for _ in range(5))
        last = torch.zeros((nb, NPIX), dtype=torch.long, device=dev)
        walked = torch.zeros((nb, NPIX), dtype=torch.long, device=dev)
        for c0 in range(0, int(cnt.max()) if nb else 0, chunk):
            if bool(done.all()):
                break
            n_in = torch.clamp(cnt - c0, 0, chunk)[:, None]      # (nb, 1)
            idx = gid[torch.clamp(st[:, None] + c0 + ks, max=E - 1)]  # (nb, chunk) rows
            g = table[idx]
            alpha, z = alpha_depth(T_all[idx], center_all[idx], g[..., 9],
                                   ks < n_in, px, py, near)       # (nb, chunk, 256)
            alpha = torch.where(done[:, None, :], 0.0, alpha)
            c = composite(alpha, z, g[..., 10:13], g[..., 13:16], no_bg, near=near,
                          far=far, carry=(T, M1, M2))
            walked += torch.where(done, 0, torch.minimum(c.stop_at + 1, n_in))
            color += c.color
            normal += c.normal
            depth_acc += c.depth_acc
            dist += c.distortion
            # A chunk holds a median candidate iff it has a contributor and
            # the T entering it (its first contributor's) is still > 0.5.
            median = torch.where((T > 0.5) & (c.n_contrib > 0), c.median_depth, median)
            last = torch.where(c.n_contrib > 0, c0 + c.n_contrib, last)
            T, M1, M2 = c.final_T, c.m1_tot, c.m2_tot
            done = done | (c.stop_at < chunk)

        dist_on = want_aux and want_dist
        res = out[t]
        res[..., CH_COLOR] = color + T[..., None] * bg.to(torch.float32)
        res[..., CH_NORMAL] = normal
        res[..., CH_DEPTH] = depth_acc
        res[..., CH_ALPHA] = 1.0 - T
        res[..., CH_DIST] = dist if dist_on else 0.0
        res[..., CH_MEDIAN] = median
        res[..., CH_FINAL_T] = T
        res[..., CH_M1] = M1 if dist_on else 0.0
        res[..., CH_M2] = M2 if dist_on else 0.0
        out[t] = res
        n_contrib[t] = last.to(torch.int32) if want_aux else 0
        n_walked[t] = walked.to(torch.int32)

    maps = _maps(assemble_tiles(out, width, height),
                 assemble_tiles(n_contrib, width, height))
    maps["n_walked"] = assemble_tiles(n_walked, width, height)
    return maps


MAP_KEYS = ("color", "normal", "depth_acc", "alpha", "distortion", "median_depth",
            "final_T", "n_contrib", "m1_tot", "m2_tot")


class _Rasterize(torch.autograd.Function):
    """B1 forward in mode want_aux=True, B2 backward (counterpart of
    `_render_pallas_fwd` / `_render_pallas_bwd`). Differentiable inputs: the
    preprocessed T, center, opacity, rgb and normal. The kernels recompute
    the centre from T; `center` is an input only so that d_center (the 2D
    low-pass branch's gradient) reaches it, and through `preprocess` the
    screen-space offset that densify reads. n_contrib and the moment totals
    get no gradient."""

    @staticmethod
    def forward(ctx, T, center, opacity, rgb, normal, valid, gauss_id, tile_start,
                tile_count, bg, width, height, near, far, want_dist):
        table = _table(T, valid, opacity, rgb, normal)
        maps = rasterize_entries(table, gauss_id, tile_start, tile_count, bg, width, height,
                                 near, far, want_aux=True, want_dist=want_dist)
        aux = torch.stack([maps["final_T"], maps["n_contrib"].to(torch.float32),
                           maps["m1_tot"], maps["m2_tot"]], -1)
        ctx.save_for_backward(table, gauss_id, tile_start, tile_count, aux, valid, bg)
        ctx.geom = (width, height, near, far, want_dist, T.shape[0])
        ctx.mark_non_differentiable(maps["n_contrib"], maps["m1_tot"], maps["m2_tot"])
        return tuple(maps[k] for k in MAP_KEYS)

    @staticmethod
    def backward(ctx, g_color, g_normal, g_depth, g_alpha, g_dist, g_med, g_final_T,
                 *_):
        table, gauss_id, tile_start, tile_count, aux, valid, bg = ctx.saved_tensors
        width, height, near, far, want_dist, P = ctx.geom
        # The final_T cotangent folds into the alpha channel with the opposite
        # sign (gT_end = bg·gC − gA + gFinT), as rasterize_pallas.py:689-704.
        cot = torch.cat([g_color, g_normal, g_depth[..., None],
                         (g_alpha - g_final_T)[..., None], g_dist[..., None],
                         g_med[..., None], g_color.new_zeros((height, width, COT_C - 10))],
                        -1).to(torch.float32)
        grad = rasterize_backward(table, gauss_id, tile_start, tile_count, aux, cot,
                                  bg, width, height, near, far, want_dist)
        # The table's opacity was where(valid, opacity, 0).
        d_opacity = grad[:, 11] * valid.to(grad.dtype)
        return (grad[:, 0:9].reshape(P, 3, 3), grad[:, 9:11], d_opacity,
                grad[:, 12:15], grad[:, 15:18]) + (None,) * 10


def rasterize_diff(prep: Preprocessed, binning: Binning, bg: torch.Tensor, width: int,
                   height: int, near: float = NEAR_N, far: float = FAR_N,
                   want_dist: bool = True) -> Dict[str, torch.Tensor]:
    """The (H, W[, C]) maps of `rasterize_entries` in mode want_aux=True,
    differentiable in prep's T, center, opacity, rgb and normal."""
    out = _Rasterize.apply(prep.T, prep.center, prep.opacity, prep.rgb, prep.normal,
                           prep.valid, binning.gauss_id, binning.tile_start,
                           binning.tile_count, bg.to(torch.float32), width, height,
                           near, far, want_dist)
    return dict(zip(MAP_KEYS, out))
