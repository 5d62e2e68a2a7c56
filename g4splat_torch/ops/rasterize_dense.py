"""Dense (all-splats × all-pixels) differentiable surfel rasterizer — the
port's O(P·npix) oracle (counterpart of `g4splat_tpu.ops.rasterize_dense`).

It implements the reference compositing semantics (renderCUDA,
forward.cu:258-443) in closed form: the sequential front-to-back loop becomes
exclusive cumulative products/sums along the depth-sorted splat axis. The
early stop is exact because T is non-increasing: the first splat whose
inclusive T drops below 1e-4, and everything behind it, is a pure mask.
Differentiable by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from g4splat_torch.ops.rasterize_common import (
    FAR_N,
    NEAR_N,
    T_EPS,
    TILE,
    Preprocessed,
    splat_alpha_depth,
    tile_rect,
)


class CompositeOut(NamedTuple):
    color: torch.Tensor        # (..., npix, 3)
    depth_acc: torch.Tensor    # (..., npix) unnormalized expected depth Σ w·z
    alpha: torch.Tensor        # (..., npix)
    normal: torch.Tensor       # (..., npix, 3) view-space, unnormalized
    median_depth: torch.Tensor
    distortion: torch.Tensor
    final_T: torch.Tensor
    n_contrib: torch.Tensor    # (..., npix) int32 — 1-based index of last contributor
    m1_tot: torch.Tensor       # (..., npix) Σ w·m  — distortion moment totals
    m2_tot: torch.Tensor       # (..., npix) Σ w·m²
    stop_at: torch.Tensor      # (..., npix) index of the entry that ended the walk, K if none


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the entry axis (-2)."""
    cs = torch.cumsum(x, dim=-2)
    return torch.cat([torch.zeros_like(x[..., :1, :]), cs[..., :-1, :]], dim=-2)


def composite(
    alpha: torch.Tensor,    # (..., K, npix) in front-to-back order
    depth: torch.Tensor,    # (..., K, npix)
    rgb: torch.Tensor,      # (..., K, 3)
    normal: torch.Tensor,   # (..., K, 3)
    bg: torch.Tensor,       # (3,)
    near: float = NEAR_N,
    far: float = FAR_N,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> CompositeOut:
    """Composite K entries per pixel front to back.

    `carry` continues an earlier run of entries along the same pixels: it is
    that run's (final_T, m1_tot, m2_tot), each (..., npix). final_T and the
    moment totals returned then include it; color (with final_T·bg), normal,
    depth_acc and distortion sum these K entries only, and median_depth and
    n_contrib index them (0 where none).
    """
    K = alpha.shape[-2]
    if carry is None:
        T0, M1_0, M2_0 = torch.ones_like(alpha[..., :1, :]), 0.0, 0.0
    else:
        T0, M1_0, M2_0 = (c.unsqueeze(-2) for c in carry)
    # Early stop (forward.cu:384-389): a splat whose *inclusive*
    # transmittance falls below T_EPS is skipped, as is everything behind it.
    stop = T0 * torch.cumprod(1.0 - alpha, dim=-2) < T_EPS
    alpha_eff = torch.where(stop, 0.0, alpha)
    om = 1.0 - alpha_eff
    cp = T0 * torch.cumprod(om, dim=-2)
    T_excl = torch.cat([T0, cp[..., :-1, :]], dim=-2)
    w = alpha_eff * T_excl  # (..., K, npix)

    color = torch.einsum("...kp,...kc->...pc", w, rgb)
    nrm = torch.einsum("...kp,...kc->...pc", w, normal)
    depth_acc = torch.sum(w * depth, dim=-2)

    # Depth distortion (forward.cu:392-400): NDC-ish depth m, running moments.
    m = far / (far - near) * (1.0 - near / torch.clamp(depth, min=1e-8))
    mw = m * w
    m2w = m * m * w
    M1, M2 = M1_0 + _excl_cumsum(mw), M2_0 + _excl_cumsum(m2w)
    distortion = torch.sum((m * m * (1.0 - T_excl) + M2 - 2.0 * m * M1) * w, dim=-2)

    # Median depth: last contributor with incoming T > 0.5 (forward.cu:402-406).
    contrib = alpha_eff > 0.0
    med_mask = (T_excl > 0.5) & contrib
    kidx = torch.arange(K, device=alpha.device)[:, None]
    best = torch.where(med_mask, kidx, -1).max(dim=-2).values
    picked = torch.gather(depth, -2, best.clamp(min=0).unsqueeze(-2)).squeeze(-2)
    median_depth = torch.where(best >= 0, picked, 0.0)

    final_T = cp[..., -1, :]
    color = color + final_T[..., None] * bg
    last = torch.where(contrib, kidx + 1, 0).max(dim=-2).values
    return CompositeOut(
        color=color,
        depth_acc=depth_acc,
        alpha=1.0 - final_T,
        normal=nrm,
        median_depth=median_depth,
        distortion=distortion,
        final_T=final_T,
        n_contrib=last.to(torch.int32),
        m1_tot=(M1_0 + torch.sum(mw, dim=-2, keepdim=True)).squeeze(-2),
        m2_tot=(M2_0 + torch.sum(m2w, dim=-2, keepdim=True)).squeeze(-2),
        # T_incl only falls, so the entries before the stop are those not stopped.
        stop_at=torch.sum(~stop, dim=-2),
    )


def render_dense(camera, prep: Preprocessed, bg: torch.Tensor,
                 near: float = NEAR_N, far: float = FAR_N) -> CompositeOut:
    """Rasterize every splat against every pixel. Returns flat (H·W, …) maps."""
    H, W = camera.height, camera.width
    dev = prep.depth.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    px = xs.reshape(-1)
    py = ys.reshape(-1)

    # Depth sort (invalid splats to the back); stable, so ties keep splat order.
    order = torch.argsort(torch.where(prep.valid, prep.depth, torch.inf), stable=True)
    ps = prep.index(order)
    alpha, depth = splat_alpha_depth(ps, px, py, near=near)

    # Tile-rect culling, matching the binned backends (and the CUDA reference,
    # which composites a splat only in tiles its ±radius AABB touches).
    gxn = (W + TILE - 1) // TILE
    gyn = (H + TILE - 1) // TILE
    rmin_x, rmin_y, rmax_x, rmax_y = tile_rect(ps.center, ps.radius, gxn, gyn)
    tx = (px / TILE).to(torch.int32)[None, :]
    ty = (py / TILE).to(torch.int32)[None, :]
    in_rect = ((tx >= rmin_x[:, None]) & (tx < rmax_x[:, None])
               & (ty >= rmin_y[:, None]) & (ty < rmax_y[:, None]))
    alpha = torch.where(in_rect, alpha, 0.0)
    return composite(alpha, depth, ps.rgb, ps.normal, bg, near=near, far=far)
