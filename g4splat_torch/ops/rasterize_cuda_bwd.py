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
gradient rows read-modified-written. The arithmetic binds. Per-pixel state
stays in registers, per-entry terms in shared memory, and each entry's 18
gradients leave the block through one atomicAdd each, so no per-entry
buffer and no sort-based reduction exist on this card.

`rasterize_backward` dispatches on the tensors' device: on CUDA tensors it
launches the kernel (or raises), on CPU tensors it runs the plain version.

Inputs: the (E, 16) entry table, gauss_id (E,) int32, the tile ranges, the
forward's saved aux (H, W, 4) [final_T, n_contrib, M1 total, M2 total], the
cotangent image (H, W, 12) [gC(3), gN(3), g_depth_acc, g_alpha − g_final_T,
g_dist, g_median, 0, 0] and bg. Output: (P, 18) per-splat gradients
[dT(9) (rows Tu, Tv, Tw), d_center(2), d_opacity, d_rgb(3), d_normal(3)].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from g4splat_torch.ops.cuda_build import KernelInfo
from g4splat_torch.ops.rasterize_common import (
    ALPHA_CLAMP,
    ALPHA_EPS,
    ENTRY_F,
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


def _check_inputs(entries, gauss_id, tile_start, tile_count, aux, cot, bg, width, height):
    n_tiles = ((width + TILE - 1) // TILE) * ((height + TILE - 1) // TILE)
    E = entries.shape[0]
    if entries.dtype != torch.float32 or entries.ndim != 2 or entries.shape[1] != ENTRY_F:
        raise ValueError(f"entries must be (E, {ENTRY_F}) float32, got "
                         f"{tuple(entries.shape)} {entries.dtype}")
    shapes = (("gauss_id", gauss_id, (E,), torch.int32),
              ("tile_start", tile_start, (n_tiles,), torch.int32),
              ("tile_count", tile_count, (n_tiles,), torch.int32),
              ("aux", aux, (height, width, AUX_C), torch.float32),
              ("cot", cot, (height, width, COT_C), torch.float32))
    for name, t, shape, dtype in shapes:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if bg.shape != (3,):
        raise ValueError(f"bg must be (3,), got {tuple(bg.shape)}")
    devs = {t.device for t in (entries, gauss_id, tile_start, tile_count, aux, cot, bg)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def rasterize_backward(entries: torch.Tensor, gauss_id: torch.Tensor,
                       tile_start: torch.Tensor, tile_count: torch.Tensor,
                       aux: torch.Tensor, cot: torch.Tensor, bg: torch.Tensor,
                       width: int, height: int, n_splats: int,
                       near: float = NEAR_N, far: float = FAR_N,
                       want_dist: bool = True) -> torch.Tensor:
    """Per-splat gradients (n_splats, 18) of a forward composite, from its
    saved aux and the cotangent image. With want_dist=False the distortion
    cotangent is ignored (the forward ran without the moments)."""
    _check_inputs(entries, gauss_id, tile_start, tile_count, aux, cot, bg, width, height)
    if entries.device.type == "cpu":
        return rasterize_backward_plain(entries, gauss_id, tile_start, tile_count, aux,
                                        cot, bg, width, height, n_splats, near, far,
                                        want_dist)
    if entries.device.type != "cuda":
        raise ValueError(f"unsupported device {entries.device}")
    return _rasterize_backward_cuda(entries, gauss_id, tile_start, tile_count, aux, cot,
                                    bg, width, height, n_splats, near, far, want_dist)


def _rasterize_backward_cuda(entries, gauss_id, tile_start, tile_count, aux, cot, bg,
                             width, height, n_splats, near, far, want_dist):
    from g4splat_torch.ops.cuda_build import load

    fn = load("rasterize_bwd").g4_rasterize_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = entries.device
    args = [t.contiguous() for t in (entries, gauss_id, tile_start, tile_count, aux, cot,
                                     bg.to(torch.float32))]
    grad = torch.zeros((n_splats, GRAD_F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in args), int(width), int(height), float(near),
                 float(far), int(bool(want_dist)), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd launch failed: CUDA error {err}")
    RASTERIZE_BWD.launches += 1
    return grad


def rasterize_backward_plain(entries: torch.Tensor, gauss_id: torch.Tensor,
                             tile_start: torch.Tensor, tile_count: torch.Tensor,
                             aux: torch.Tensor, cot: torch.Tensor, bg: torch.Tensor,
                             width: int, height: int, n_splats: int,
                             near: float = NEAR_N, far: float = FAR_N,
                             want_dist: bool = True, chunk: int = 64,
                             max_elems: int = 1 << 18,
                             stats: Optional[dict] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same inputs and
    outputs, on any device.

    An explicit back-to-front sweep: tiles are taken in batches, deepest
    n_contrib first; each batch walks its ranges from the back in chunks of
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
    dev = entries.device
    gx = (width + TILE - 1) // TILE
    n_tiles = gx * ((height + TILE - 1) // TILE)
    E = entries.shape[0]
    grad = torch.zeros((n_splats, GRAD_F), dtype=torch.float32, device=dev)
    aux_t = disassemble_tiles(aux.to(torch.float32), width, height)   # (n_tiles, 256, 4)
    cot_t = disassemble_tiles(cot.to(torch.float32), width, height)
    nc_all = aux_t[..., 1].long()
    tile_last = torch.minimum(nc_all.amax(1), tile_count.long())
    n_contribs, touched = 0, []
    if stats is not None:
        stats.update(pairs=int(nc_all.sum()), rows=int(tile_last.sum()))
    entries = entries.to(torch.float32)
    T_all = entries[:, :9].reshape(E, 3, 3)
    center_all, _, ok = conic_center(T_all)
    center_all = torch.where(ok[:, None], center_all, 0.0)   # as the kernel's
    bg = bg.to(torch.float32)
    m_scale = far / (far - near)
    lin = torch.arange(NPIX, device=dev)
    lx = (lin % TILE).to(torch.float32)
    ly = (lin // TILE).to(torch.float32)
    order = torch.argsort(tile_last, descending=True, stable=True)
    tb = max(1, max_elems // (NPIX * chunk))

    for b0 in range(0, n_tiles, tb):
        t = order[b0:b0 + tb]
        last = tile_last[t]
        if E == 0 or int(last.max()) == 0:
            break                               # tiles are sorted deepest first
        st = tile_start[t].long()
        px = ((t % gx) * TILE)[:, None] + lx                  # (nb, 256)
        py = ((t // gx) * TILE)[:, None] + ly
        a_t, c_t, nc = aux_t[t], cot_t[t], nc_all[t]
        T_end, M1_tot, M2_tot = a_t[..., 0], a_t[..., 2], a_t[..., 3]
        gC, gN = c_t[..., 0:3], c_t[..., 3:6]
        gD, gdist, gmed = c_t[..., 6], c_t[..., 8], c_t[..., 9]
        t_end_term = ((bg * gC).sum(-1) - c_t[..., 7]) * T_end
        T = T_end.clone()
        S_wu, S_w, S_mw, S_m2w, S_wm2T = (torch.zeros_like(T) for _ in range(5))
        med_done = torch.zeros_like(T, dtype=torch.bool)

        for hi in range(int(last.max()), 0, -chunk):
            lo = max(hi - chunk, 0)
            pos = torch.arange(lo, hi, device=dev)
            idx = torch.clamp(st[:, None] + pos, max=E - 1)             # (nb, K)
            g = entries[idx]
            Tk = T_all[idx]
            r = ray_splat(Tk, center_all[idx], px, py)                # (nb, K, 256)
            eterm = torch.exp(-0.5 * r.rho)
            a_raw = g[..., 9, None] * eterm
            alpha = torch.clamp(a_raw, max=ALPHA_CLAMP)
            contrib = ((torch.abs(r.pz) >= 1e-20) & (r.depth >= near)
                       & (alpha >= ALPHA_EPS) & (pos[None, :, None] < nc[:, None, :]))
            a_eff = torch.where(contrib, alpha, 0.0)
            cg = (torch.einsum("bkc,bpc->bkp", g[..., 10:13], gC)
                  + torch.einsum("bkc,bpc->bkp", g[..., 13:16], gN))
            m = m_scale * (1.0 - near / torch.clamp(r.depth, min=1e-8))
            dA, dZ, W = (torch.zeros_like(alpha) for _ in range(3))
            for j in range(hi - lo - 1, -1, -1):
                cj, a, z = contrib[:, j], a_eff[:, j], r.depth[:, j]
                one_m = 1.0 - a
                T_k = T / one_m                  # exact for non-contributors (a = 0)
                w = a * T_k
                u = cg[:, j] + z * gD
                num = -S_wu - t_end_term
                dz = w * gD
                if want_dist:
                    mj = m[:, j]
                    mw, m2w = mj * w, mj * mj * w
                    M1_k = M1_tot - (S_mw + mw)
                    M2_k = M2_tot - (S_m2w + m2w)
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

            # Geometry VJP (_chunk_geom_bwd in the cross-product form of
            # ray_splat): p = k × l, k = x·Tw − Tu, l = y·Tw − Tv.
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
            x = px[:, None, :, None]
            y = py[:, None, :, None]
            dTw = (x * dk + y * dl).sum(2) + torch.stack(
                [(dZ3 * r.su).sum(2), (dZ3 * r.sv).sum(2), dZ.sum(2)], -1)
            c2 = 2.0 * FILTER_INV_SQUARE * d_rho2d
            rows = torch.cat([
                -dk.sum(2), -dl.sum(2), dTw,
                (c2 * r.dx).sum(2)[..., None], (c2 * r.dy).sum(2)[..., None],
                (gE * eterm).sum(2)[..., None],
                torch.einsum("bkp,bpc->bkc", W, gC),
                torch.einsum("bkp,bpc->bkc", W, gN)], -1)             # (nb, K, 18)
            walked = pos[None, :] < last[:, None]
            gid = gauss_id[idx][walked].long()
            grad.index_add_(0, gid, rows[walked])
            if stats is not None:
                n_contribs += int(contrib.sum())
                touched.append(gid[contrib.any(-1)[walked]])

    if stats is not None:
        stats.update(contributors=n_contribs,
                     splats=int(torch.unique(torch.cat(touched)).numel()) if touched else 0)
    return grad
