"""Backward surfel compositing over a tile-binned entry list: the CUDA kernel
`csrc/rasterize_bwd.cu` and its plain PyTorch version (counterpart of
`g4splat_tpu.ops.rasterize_pallas_bwd` and of the entry→splat reduction in
`g4splat_tpu.ops.rasterize_pallas._entry_to_splat`).

Kernel B2 replaces `g4splat_tpu/ops/rasterize_pallas_bwd.py::_bwd_kernel`.
What bounds it on an H100: every (pixel, entry) pair walked up to the
pixel's n_contrib costs `OPS_PER_PAIR_BWD` fp32 operations (the alpha
recompute), each contributor a further `OPS_PER_CONTRIB_BWD` (the
compositing calculus, the geometry VJP and its share of the per-entry
reduction over pixels; `OPS_PER_CONTRIB_DIST` more with distortion), against
the entry rows the tiles walk, the cotangent and aux maps read once and the
gradient rows read-modified-written. The arithmetic binds.

Design: one block per tile walks the tile back to front, one thread per
pixel. The blocks form a persistent grid that takes tiles longest walk first
(`tile_order_plain` is the plain version of that order), so the deepest
tiles start first and the short ones fill the end. A warp skips an entry
whose reach box (`reach_boxes`) misses its pixels. Per-pixel state stays in
registers, per-entry terms in shared memory, and each entry's 18 gradients
are summed over a warp in 20 shuffles and leave the block through one
atomicAdd each.

`rasterize_backward` dispatches on the tensors' device: on CUDA tensors it
launches the kernel (or raises), on CPU tensors it runs the plain version.

Inputs: the (P, 16) splat table (`rasterize_cuda.splat_table`) and gauss_id
(E,) int32 (entry i is table row gauss_id[i], and its gradients go to row
gauss_id[i] of the output), the tile ranges, the forward's saved aux
(H, W, 4) [final_T, n_contrib, M1 total, M2 total], the
cotangent image (H, W, 12) [gC(3), gN(3), g_depth_acc, g_alpha − g_final_T,
g_dist, g_median, 0, 0] and bg. Output: (P, 18) per-splat gradients
[dT(9) (rows Tu, Tv, Tw), d_center(2), d_opacity, d_rgb(3), d_normal(3)].
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from g4splat_torch.ops.cuda_build import KernelInfo
from g4splat_torch.ops.rasterize_common import (
    ALPHA_CLAMP,
    ALPHA_EPS,
    FAR_N,
    FILTER_INV_SQUARE,
    NEAR_N,
    TILE,
    conic_center,
    ray_splat,
)
from g4splat_torch.ops.rasterize_tiled import disassemble_tiles

NPIX = TILE * TILE
GRAD_F = 18
COT_C = 12
AUX_C = 4
# Walk lengths the kernel's tile order tells apart (csrc/rasterize_bwd.cu).
NBUCKET = 32
# fp32 operations per (pixel, entry) pair walked up to the pixel's n_contrib:
# the alpha recompute (k and l 12, their cross product 9, |p2| test 1,
# reciprocal 1, su/sv 2, rho3d 3, dx/dy 2, rho2d 4, select 2, z 4, exp argument
# and exp 2, alpha 2, tests 2).
OPS_PER_PAIR_BWD = 46
# ... and per contributor: unwinding T and w (3), u (14), dL/da and dL/dz (8),
# median test and suffix sum (4), the geometry VJP (57: alpha and rho chain 9,
# dp 8, dk and dl 18, dTw 15, opacity 1, rgb and normal 6), and the 18 values
# it adds into the entry's reduction over pixels (18).
OPS_PER_CONTRIB_BWD = 104
# ... plus, with distortion: m and its moments (8), the prefix moments (5),
# u's distortion term (10), dL/dm and dm/dz (12), four more suffix sums (5).
OPS_PER_CONTRIB_DIST = 40

RASTERIZE_BWD = KernelInfo(
    name="rasterize_bwd",
    source="g4splat_torch/csrc/rasterize_bwd.cu",
    replaces="g4splat_tpu/ops/rasterize_pallas_bwd.py:240",
)


def _check_inputs(table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height):
    from g4splat_torch.ops.rasterize_cuda import check_table

    n_tiles = ((width + TILE - 1) // TILE) * ((height + TILE - 1) // TILE)
    check_table(table, gauss_id)
    shapes = (("tile_start", tile_start, (n_tiles,), torch.int32),
              ("tile_count", tile_count, (n_tiles,), torch.int32),
              ("aux", aux, (height, width, AUX_C), torch.float32),
              ("cot", cot, (height, width, COT_C), torch.float32))
    for name, t, shape, dtype in shapes:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if bg.shape != (3,):
        raise ValueError(f"bg must be (3,), got {tuple(bg.shape)}")
    devs = {t.device for t in (table, tile_start, tile_count, aux, cot, bg)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def rasterize_backward(table: torch.Tensor, gauss_id: torch.Tensor,
                       tile_start: torch.Tensor, tile_count: torch.Tensor,
                       aux: torch.Tensor, cot: torch.Tensor, bg: torch.Tensor,
                       width: int, height: int, near: float = NEAR_N, far: float = FAR_N,
                       want_dist: bool = True) -> torch.Tensor:
    """Per-splat gradients (P, 18), one row per table row, of a forward
    composite, from its saved aux and the cotangent image. Entry i reads,
    and adds its gradient into, row gauss_id[i] (0 <= gauss_id < P, not
    checked: see rasterize_cuda.check_table). With
    want_dist=False the distortion cotangent is ignored (the forward ran
    without the moments)."""
    _check_inputs(table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height)
    if table.device.type == "cpu":
        return rasterize_backward_plain(table, gauss_id, tile_start, tile_count, aux,
                                        cot, bg, width, height, near, far, want_dist)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    grad = torch.zeros((table.shape[0], GRAD_F), dtype=torch.float32, device=table.device)
    launch_backward((table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height),
                    grad, near, far, want_dist)
    return grad


# --- the kernel ------------------------------------------------------------

def _lib():
    """The kernel's library, its ctypes signatures declared once per handle."""
    from g4splat_torch.ops.cuda_build import load

    lib = load("rasterize_bwd")
    if not getattr(lib, "_g4_bound", False):
        lib.g4_rasterize_bwd.argtypes = ([ctypes.c_void_p] * 7
                                         + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_int]
                                         + [ctypes.c_void_p] * 3)
        lib.g4_rasterize_bwd.restype = ctypes.c_int
        lib.g4_rasterize_bwd_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.g4_rasterize_bwd_info.restype = ctypes.c_int
        lib._g4_bound = True
    return lib


def launch_backward(args, grad: torch.Tensor, near: float = NEAR_N, far: float = FAR_N,
                    want_dist: bool = True) -> torch.Tensor:
    """Launch B2 on CUDA tensors `args` = (table, gauss_id, tile_start,
    tile_count, aux, cot, bg, width, height), adding into `grad`. Counts one
    launch. Returns the work list it built (`worklist` reads it)."""
    table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height = args
    ts = [t.contiguous() for t in (table, gauss_id, tile_start, tile_count, aux, cot,
                                   bg.to(torch.float32))]
    dev = table.device
    n_tiles = ((width + TILE - 1) // TILE) * ((height + TILE - 1) // TILE)
    work = torch.empty(2 * n_tiles + 2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().g4_rasterize_bwd(
            *(t.data_ptr() for t in ts), int(width), int(height), float(near), float(far),
            int(bool(want_dist)), work.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd launch failed: CUDA error {err}")
    RASTERIZE_BWD.count_launch()
    return work


def worklist(work: torch.Tensor, n_tiles: int) -> Dict[str, torch.Tensor]:
    """The kernel's work list from `launch_backward`'s scratch: "walk"
    (n_tiles,), the entries each tile walks, and "order", the tiles that walk
    any entry in the order the blocks took them."""
    n_items = int(work[2 * n_tiles + 1])
    return {"walk": work[:n_tiles], "order": work[n_tiles:n_tiles + n_items]}


def kernel_info(want_dist: bool) -> Dict[str, int]:
    """The walk kernel's registers, spill bytes, static shared bytes and
    resident blocks per SM on the current card, and the card's SM count."""
    out = (ctypes.c_int * 5)()
    err = _lib().g4_rasterize_bwd_info(int(bool(want_dist)), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"rasterize_bwd info failed: CUDA error {err}")
    keys = ("registers", "spill_bytes", "shared_bytes", "blocks_per_sm", "sms")
    return dict(zip(keys, out))


# --- the plain versions ------------------------------------------------------

def tile_walks(aux: torch.Tensor, tile_count: torch.Tensor, width: int,
               height: int) -> torch.Tensor:
    """Entries each tile walks: min(deepest n_contrib of its pixels, count)."""
    nc = disassemble_tiles(aux[..., 1].to(torch.float32), width, height).long()
    return torch.minimum(nc.amax(1), tile_count.long())


def walk_buckets(walk: torch.Tensor) -> torch.Tensor:
    """Each tile's bucket in the kernel's tile order, (walk − 1) · NBUCKET //
    longest walk (−1 for a tile that walks nothing)."""
    walk = walk.long()
    longest = max(int(walk.max()), 1) if walk.numel() else 1
    return torch.where(walk > 0, (walk - 1) * NBUCKET // longest, -1)


def tile_order_plain(walk: torch.Tensor) -> torch.Tensor:
    """The tiles that walk any entry, in the kernel's order: bucket by
    bucket, longest walk first, and by tile within a bucket (where the
    kernel's order varies from run to run)."""
    bucket = walk_buckets(walk)
    live = torch.nonzero(bucket >= 0).flatten()
    return live[torch.argsort(-bucket[live], stable=True)].to(torch.int32)


class _Batch:
    """Per-pixel inputs of a batch of tiles t, each (nb, 256)."""

    def __init__(self, t, gx, tile_start, last, aux_t, cot_t, bg):
        lin = torch.arange(NPIX, device=t.device)
        self.t, self.last = t, last
        self.st = tile_start[t].long()
        self.px = ((t % gx) * TILE)[:, None] + (lin % TILE).to(torch.float32)
        self.py = ((t // gx) * TILE)[:, None] + (lin // TILE).to(torch.float32)
        a, c = aux_t[t], cot_t[t]
        self.nc = a[..., 1].long()
        self.T_end, self.M1_tot, self.M2_tot = a[..., 0], a[..., 2], a[..., 3]
        self.gC, self.gN = c[..., 0:3], c[..., 3:6]
        self.gD, self.gdist, self.gmed = c[..., 6], c[..., 8], c[..., 9]
        self.t_end_term = ((bg * self.gC).sum(-1) - c[..., 7]) * self.T_end

    def initial_state(self) -> Dict[str, torch.Tensor]:
        """The state behind the tile's last entry: T = final_T, sums 0."""
        z = torch.zeros_like(self.T_end)
        return {"T": self.T_end.clone(), "S_wu": z, "S_w": z, "S_mw": z, "S_m2w": z,
                "S_wm2T": z, "med_done": torch.zeros_like(z, dtype=torch.bool)}


class _Entries:
    """The splat table's per-row terms, the entries' rows and the chunk
    geometry."""

    def __init__(self, table, gauss_id, near, far):
        self.E = gauss_id.shape[0]
        self.gid = gauss_id.long()
        self.g = table.to(torch.float32)
        self.T = self.g[:, :9].reshape(self.g.shape[0], 3, 3)
        center, _, ok = conic_center(self.T)
        self.center = torch.where(ok[:, None], center, 0.0)   # as the kernel's
        self.near, self.far = near, far
        self.m_scale = far / (far - near)

    def chunk(self, b: _Batch, lo: int, hi: int):
        """Entries lo..hi-1 of each tile of the batch against its pixels;
        `idx` holds their table rows."""
        pos = torch.arange(lo, hi, device=b.t.device)
        idx = self.gid[torch.clamp(b.st[:, None] + pos, max=self.E - 1)]  # (nb, K) rows
        g = self.g[idx]
        Tk = self.T[idx]
        r = ray_splat(Tk, self.center[idx], b.px, b.py)                  # (nb, K, 256)
        eterm = torch.exp(-0.5 * r.rho)
        a_raw = g[..., 9, None] * eterm
        alpha = torch.clamp(a_raw, max=ALPHA_CLAMP)
        contrib = ((torch.abs(r.pz) >= 1e-20) & (r.depth >= self.near)
                   & (alpha >= ALPHA_EPS) & (pos[None, :, None] < b.nc[:, None, :]))
        cg = (torch.einsum("bkc,bpc->bkp", g[..., 10:13], b.gC)
              + torch.einsum("bkc,bpc->bkp", g[..., 13:16], b.gN))
        m = self.m_scale * (1.0 - self.near / torch.clamp(r.depth, min=1e-8))
        return pos, idx, Tk, r, eterm, a_raw, contrib, torch.where(contrib, alpha, 0.0), cg, m


def _walk_chunk(ent: _Entries, b: _Batch, st: dict, lo: int, hi: int, grad: torch.Tensor,
                want_dist: bool, stats: Optional[dict], touched: list) -> int:
    """Walk entries hi-1 down to lo of the batch's tiles from state `st`
    (updated in place), adding each entry's gradients into `grad`. Returns
    the contributors met."""
    near, far = ent.near, ent.far
    pos, idx, Tk, r, eterm, a_raw, contrib, a_eff, cg, m = ent.chunk(b, lo, hi)
    T, S_wu, S_w, S_mw, S_m2w, S_wm2T, med_done = (
        st[k] for k in ("T", "S_wu", "S_w", "S_mw", "S_m2w", "S_wm2T", "med_done"))
    gD, gdist, gmed = b.gD, b.gdist, b.gmed
    dA, dZ, W = (torch.zeros_like(a_eff) for _ in range(3))
    for j in range(hi - lo - 1, -1, -1):
        cj, a, z = contrib[:, j], a_eff[:, j], r.depth[:, j]
        one_m = 1.0 - a
        T_k = T / one_m                  # exact for non-contributors (a = 0)
        w = a * T_k
        u = cg[:, j] + z * gD
        num = -S_wu - b.t_end_term
        dz = w * gD
        if want_dist:
            mj = m[:, j]
            mw, m2w = mj * w, mj * mj * w
            M1_k = b.M1_tot - (S_mw + mw)
            M2_k = b.M2_tot - (S_m2w + m2w)
            A_k = 1.0 - T_k
            u = u + gdist * (mj * mj * A_k + M2_k - 2.0 * mj * M1_k
                             + mj * mj * S_w - 2.0 * mj * S_mw)
            num = num + gdist * S_wm2T
            dL_dm = gdist * w * (2.0 * mj * A_k - 2.0 * M1_k
                                 + 2.0 * mj * S_w - 2.0 * S_mw)
            zc = torch.clamp(z, min=1e-8)
            dz = dz + dL_dm * (far * near / ((far - near) * zc * zc))
        da = T_k * u + num / torch.clamp(one_m, min=1e-3)
        med = cj & ~med_done & (T_k > 0.5)
        dz = dz + torch.where(med, gmed, 0.0)
        med_done = med_done | med
        dA[:, j] = torch.where(cj, da, 0.0)
        dZ[:, j] = torch.where(cj, dz, 0.0)
        W[:, j] = w
        S_wu = S_wu + torch.where(cj, w * u, 0.0)
        if want_dist:
            S_w = S_w + w
            S_mw = S_mw + torch.where(cj, mw, 0.0)
            S_m2w = S_m2w + torch.where(cj, m2w, 0.0)
            S_wm2T = S_wm2T + torch.where(cj, w * mj * mj * T_k, 0.0)
        T = T_k
    st.update(T=T, S_wu=S_wu, S_w=S_w, S_mw=S_mw, S_m2w=S_m2w, S_wm2T=S_wm2T,
              med_done=med_done)

    # Geometry VJP (_chunk_geom_bwd in the cross-product form of ray_splat):
    # p = k × l, k = x·Tw − Tu, l = y·Tw − Tv.
    dZ3 = torch.where(r.use3d, dZ, 0.0)
    gE = torch.where(a_raw <= ALPHA_CLAMP, dA, 0.0)
    d_rho = -0.5 * gE * a_raw
    d_rho3d = torch.where(r.use3d, d_rho, 0.0)
    d_rho2d = d_rho - d_rho3d
    Tw = Tk[:, :, None, 2, :]                                 # (nb, K, 1, 3)
    d_su = torch.where(torch.abs(r.su_raw) <= 3e4,
                       dZ3 * Tw[..., 0] + 2.0 * r.su * d_rho3d, 0.0)
    d_sv = torch.where(torch.abs(r.sv_raw) <= 3e4,
                       dZ3 * Tw[..., 1] + 2.0 * r.sv * d_rho3d, 0.0)
    d_pz = torch.where(torch.abs(r.pz) >= 1e-20,
                       -(d_su * r.su + d_sv * r.sv) / r.safe_pz, 0.0)
    d_p = torch.stack([d_su / r.safe_pz, d_sv / r.safe_pz, d_pz], -1)
    dk = torch.linalg.cross(r.l, d_p)
    dl = torch.linalg.cross(d_p, r.k)
    x = b.px[:, None, :, None]
    y = b.py[:, None, :, None]
    dTw = (x * dk + y * dl).sum(2) + torch.stack(
        [(dZ3 * r.su).sum(2), (dZ3 * r.sv).sum(2), dZ.sum(2)], -1)
    c2 = 2.0 * FILTER_INV_SQUARE * d_rho2d
    rows = torch.cat([
        -dk.sum(2), -dl.sum(2), dTw,
        (c2 * r.dx).sum(2)[..., None], (c2 * r.dy).sum(2)[..., None],
        (gE * eterm).sum(2)[..., None],
        torch.einsum("bkp,bpc->bkc", W, b.gC),
        torch.einsum("bkp,bpc->bkc", W, b.gN)], -1)             # (nb, K, 18)
    walked = pos[None, :] < b.last[:, None]
    gid = idx[walked]
    grad.index_add_(0, gid, rows[walked])
    if stats is not None:
        touched.append(gid[contrib.any(-1)[walked]])
    return int(contrib.sum()) if stats is not None else 0


def _plain_setup(table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height,
                 near, far):
    gx = (width + TILE - 1) // TILE
    aux_t = disassemble_tiles(aux.to(torch.float32), width, height)   # (n_tiles, 256, 4)
    cot_t = disassemble_tiles(cot.to(torch.float32), width, height)
    walk = tile_walks(aux, tile_count, width, height)
    ent = _Entries(table, gauss_id, near, far)
    order = torch.argsort(walk, descending=True, stable=True)
    return gx, aux_t, cot_t, walk, ent, order, bg.to(torch.float32)


def rasterize_backward_plain(table: torch.Tensor, gauss_id: torch.Tensor,
                             tile_start: torch.Tensor, tile_count: torch.Tensor,
                             aux: torch.Tensor, cot: torch.Tensor, bg: torch.Tensor,
                             width: int, height: int,
                             near: float = NEAR_N, far: float = FAR_N,
                             want_dist: bool = True, chunk: int = 64,
                             max_elems: int = 1 << 18,
                             stats: Optional[dict] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same inputs and
    outputs, on any device.

    An explicit back-to-front sweep: tiles are taken in batches, deepest
    walk first; each batch walks its ranges from the back in chunks of
    `chunk` entries. A chunk's intersections come from the forward plain
    version's own `ray_splat` (so both decide a contributor alike); the
    recurrence over T and the suffix sums then steps one entry at a time,
    unwinding T by division as the kernel does; the geometry VJP and the
    reductions over pixels run on the whole chunk, and per-splat sums are
    taken with `index_add_`. A (batch, chunk, 256) intermediate holds at most
    `max_elems` elements. If `stats` is a dict it receives the work the
    kernel does on these inputs: "pairs" (pairs walked up to each pixel's
    n_contrib), "contributors", "rows" (entries the tiles walk) and "splats"
    (distinct splats that receive a gradient).
    """
    gx, aux_t, cot_t, walk, ent, order, bg = _plain_setup(
        table, gauss_id, tile_start, tile_count, aux, cot, bg, width, height, near, far)
    grad = torch.zeros((table.shape[0], GRAD_F), dtype=torch.float32, device=table.device)
    n_contribs, touched = 0, []
    if stats is not None:
        stats.update(pairs=int(aux_t[..., 1].long().sum()), rows=int(walk.sum()))
    tb = max(1, max_elems // (NPIX * chunk))
    for b0 in range(0, order.numel(), tb):
        t = order[b0:b0 + tb]
        if ent.E == 0 or int(walk[t].max()) == 0:
            break                               # tiles are sorted deepest first
        b = _Batch(t, gx, tile_start, walk[t], aux_t, cot_t, bg)
        st = b.initial_state()
        for hi in range(int(b.last.max()), 0, -chunk):
            n_contribs += _walk_chunk(ent, b, st, max(hi - chunk, 0), hi, grad, want_dist,
                                      stats, touched)
    if stats is not None:
        stats.update(contributors=n_contribs,
                     splats=int(torch.unique(torch.cat(touched)).numel()) if touched else 0)
    return grad


def reach_boxes(table: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """(P, 4) screen boxes (x0, x1, y0, y1), in float64, one per table row,
    outside which the row's entries reach no pixel: the kernels' warps skip
    an entry whose box misses their pixels (its plain version, for the
    tests).

    alpha ≥ 1/255 needs rho = min(rho3d, rho2d) ≤ R = 2 ln(opa · 255).
    rho2d ≤ R within sqrt(R / 2) of the low-pass centre; rho3d ≤ R inside the
    image of the disk |(u, v)|² ≤ R, which its tangent lines bound (the dual
    conic M diag(R, R, −1) Mᵀ, as the reference's AABB) when the disk lies on
    one side of the camera plane, R (Tw0² + Tw1²) < Tw2²; else the box is
    unbounded. R is widened by 0.1 % + 1e-3 and the box by `margin` pixels,
    so that fp32 rounding in the kernel's rho stays inside."""
    g = table.to(torch.float64)
    Tu, Tv, Tw = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    center, _, ok = conic_center(table[:, :9].reshape(-1, 3, 3))
    center = torch.where(ok[:, None], center, 0.0).to(torch.float64)
    opa = table[:, 9]
    reach = opa >= ALPHA_EPS
    R = 2.0 * torch.log(torch.clamp(opa.to(torch.float64), min=ALPHA_EPS) / ALPHA_EPS)
    R = torch.clamp(R, min=0.0) * 1.001 + 1e-3
    d3 = torch.stack([R, R, -torch.ones_like(R)], 1)                  # diag(R, R, −1)
    a = R * (Tw[:, 0] ** 2 + Tw[:, 1] ** 2)
    dist = a - Tw[:, 2] ** 2
    bounded = dist < -1e-6 * (a + Tw[:, 2] ** 2)
    safe = torch.where(bounded, dist, -1.0)
    X = (d3 * Tu * Tw).sum(1) / safe
    Y = (d3 * Tv * Tw).sum(1) / safe
    hx = torch.sqrt(torch.clamp(X * X - (d3 * Tu * Tu).sum(1) / safe, min=0.0))
    hy = torch.sqrt(torch.clamp(Y * Y - (d3 * Tv * Tv).sum(1) / safe, min=0.0))
    r2 = torch.sqrt(R / FILTER_INV_SQUARE)
    inf = torch.full_like(R, float("inf"))
    x0 = torch.where(bounded, torch.minimum(center[:, 0] - r2, X - hx), -inf)
    x1 = torch.where(bounded, torch.maximum(center[:, 0] + r2, X + hx), inf)
    y0 = torch.where(bounded, torch.minimum(center[:, 1] - r2, Y - hy), -inf)
    y1 = torch.where(bounded, torch.maximum(center[:, 1] + r2, Y + hy), inf)
    box = torch.stack([x0 - margin, x1 + margin, y0 - margin, y1 + margin], 1)
    empty = torch.tensor([inf[0], -inf[0], inf[0], -inf[0]], dtype=torch.float64,
                         device=table.device) if table.shape[0] else box
    return torch.where(reach[:, None], box, empty)
