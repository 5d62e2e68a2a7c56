"""Training losses for 2DGS with chart/plane priors (counterpart of
`g4splat_tpu.train.losses`).

Every loss term the reference trainer assembles
(2d-gaussian-splatting/train_with_refine_depth.py:382-490, utils/loss_utils.py,
matcha/dm_regularization/depth.py:142-223, matcha/dm_utils/rendering.py:392-407).
Images are (H, W, C) or (H, W). The depth-order loss takes its random shifts
as an argument (or draws them from a `torch.Generator`), so tests can hand
both packages the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from g4splat_torch.utils.profiling import annotate


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's subgradient at 0 (+1, where torch.abs gives 0), so the
    gradients agree where a difference is exactly 0 (masked or empty pixels)."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(pred - target))


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5,
                       device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM with an 11×11 σ=1.5 Gaussian window (loss_utils.py:29-77).

    Inputs (H, W, C) in [0, 1]. Separable depthwise convolution, zero "SAME"
    padding like the reference's F.conv2d(padding=window_size//2).
    """
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    k = _gaussian_kernel1d(window_size, device=img1.device)
    pad = window_size // 2

    def blur(x):
        x = x.permute(2, 0, 1)[:, None]                      # (C, 1, H, W)
        x = F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(pad, 0))
        x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, pad))
        return x[:, 0].permute(1, 2, 0)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def dssim_color_loss(pred, target, lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1-λ)·L1 + λ·(1-SSIM) — the reference's photometric loss (:382-384)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target))


def normal_consistency_loss(rend_normal, surf_normal) -> torch.Tensor:
    """2DGS normal consistency: mean(1 - n_rend·n_surf) (:395-397)."""
    return torch.mean(1.0 - torch.sum(rend_normal * surf_normal, dim=-1))


def distortion_loss(rend_dist) -> torch.Tensor:
    return torch.mean(rend_dist)


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → (H+2, W+2, C), replicating the border."""
    x = torch.cat([x[:1], x, x[-1:]], dim=0)
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def normal_to_curvature(normal: torch.Tensor, mask=None) -> torch.Tensor:
    """(H, W, 3) → (H, W) curvature: L1 norm of the sum of 4-neighbor normal
    differences, replicate padding (matcha normal2curv, rendering.py:392-407)."""
    if mask is None:
        mask = normal.new_ones(normal.shape[:2] + (1,))
    elif mask.ndim == 2:
        mask = mask[..., None]
    n = _pad_edge(normal)
    m = _pad_edge(mask.to(normal.dtype))
    n_c = n[1:-1, 1:-1] * m[1:-1, 1:-1]
    n_u = (n[:-2, 1:-1] - n_c) * m[:-2, 1:-1]
    n_l = (n[1:-1, :-2] - n_c) * m[1:-1, :-2]
    n_b = (n[2:, 1:-1] - n_c) * m[2:, 1:-1]
    n_r = (n[1:-1, 2:] - n_c) * m[1:-1, 2:]
    curv = (n_u + n_l + n_b + n_r) * m[1:-1, 1:-1]
    return torch.sum(_abs(curv), dim=-1)


def depth_prior_loss(surf_depth, prior_depth, scale_factor,
                     confidence_weighting: float = 0.5) -> torch.Tensor:
    """Log-compressed absolute depth prior (:425-428):
    mean(cw·log(1 + scale·|prior - surf|))."""
    return torch.mean(confidence_weighting
                      * torch.log1p(scale_factor * _abs(prior_depth - surf_depth)))


def depth_derivative_prior_loss(surf_normal, prior_normal) -> torch.Tensor:
    """mean(1 - n_surf·n_prior) (:429-432)."""
    return torch.mean(1.0 - torch.sum(surf_normal * prior_normal, dim=-1))


def normal_prior_loss(rend_normal, prior_normal) -> torch.Tensor:
    return torch.mean(1.0 - torch.sum(rend_normal * prior_normal, dim=-1))


def curvature_prior_loss(rend_normal, prior_curv) -> torch.Tensor:
    rend_curv = normal_to_curvature(rend_normal)
    return torch.mean(_abs(prior_curv - rend_curv))


def depth_order_max_shift(shape, max_pixel_shift_ratio: float = 0.05) -> int:
    return int(round(max_pixel_shift_ratio * max(shape)))


def draw_depth_order_shifts(shape, generator: Optional[torch.Generator] = None,
                            sample: str = "per_pixel", n_global_shifts: int = 4,
                            max_pixel_shift_ratio: float = 0.05,
                            device=None) -> torch.Tensor:
    """Uniform integer shifts in [−max_shift, max_shift]: (H, W, 2) per pixel,
    or (n_global_shifts, 2) image-wide for sample="global"."""
    s = depth_order_max_shift(shape, max_pixel_shift_ratio)
    size = tuple(shape) + (2,) if sample == "per_pixel" else (n_global_shifts, 2)
    return torch.randint(-s, s + 1, size, generator=generator, device=device)


def depth_order_loss(
    depth: torch.Tensor,
    prior_depth: torch.Tensor,
    shifts: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    scene_extent: float = 1.0,
    max_pixel_shift_ratio: float = 0.05,
    normalize: bool = True,
    log_space: bool = True,
    log_scale: float = 20.0,
    sample: str = "per_pixel",
    n_global_shifts: int = 4,
) -> torch.Tensor:
    """Pairwise relative-depth-order loss (matcha depth.py:142-223): each pixel
    is paired with a shifted neighbor (≤5% of image size); penalize sign
    disagreement of the depth differences vs the prior,
    -min(0, Δd·sign-ish(Δd_prior)), optionally log-compressed.

    `shifts` are (H, W, 2) per-pixel (dy, dx) for sample="per_pixel" (pairs
    clamped to the border, as the reference), or (n, 2) image-wide shifts for
    sample="global" (out-of-range pairs masked). Without `shifts` they are
    drawn from `generator`.
    """
    H, W = depth.shape
    if shifts is None:
        shifts = draw_depth_order_shifts((H, W), generator, sample, n_global_shifts,
                                         max_pixel_shift_ratio, depth.device)
    shifts = shifts.to(depth.device).long()

    def pair_loss(sd, spd, valid):
        diff = (depth - sd) / scene_extent
        prior_diff = (prior_depth - spd) / scene_extent
        if normalize:
            prior_diff = prior_diff / torch.clamp(torch.abs(prior_diff).detach(), min=1e-8)
        loss = -torch.clamp(diff * prior_diff, max=0.0)
        if log_space:
            loss = torch.log1p(log_scale * loss)
        if valid is None:
            return torch.mean(loss)
        return torch.sum(loss * valid) / torch.clamp(torch.sum(valid), min=1.0)

    rows = torch.arange(H, device=depth.device)[:, None]
    cols = torch.arange(W, device=depth.device)[None, :]
    if sample == "global":
        losses = []
        with annotate("g4s:sync.depth_order"):
            pairs = shifts.tolist()
        for dy, dx in pairs:
            sd = torch.roll(depth, (-dy, -dx), dims=(0, 1))
            spd = torch.roll(prior_depth, (-dy, -dx), dims=(0, 1))
            valid = ((rows + dy >= 0) & (rows + dy < H)
                     & (cols + dx >= 0) & (cols + dx < W)).to(depth.dtype)
            losses.append(pair_loss(sd, spd, valid))
        return torch.stack(losses).mean()

    sy = torch.clamp(rows + shifts[..., 0], 0, H - 1)
    sx = torch.clamp(cols + shifts[..., 1], 0, W - 1)
    return pair_loss(depth[sy, sx], prior_depth[sy, sx], None)


def anisotropy_loss(scaling: torch.Tensor, alive: torch.Tensor,
                    max_ratio: float = 5.0) -> torch.Tensor:
    """Penalize scale anisotropy beyond `max_ratio` (:484-490), masked mean
    over alive splats."""
    ratio = scaling.amax(dim=-1) / torch.clamp(scaling.amin(dim=-1), min=1e-12)
    pen = (torch.clamp(ratio, min=max_ratio) - max_ratio) * alive
    return torch.sum(pen) / torch.clamp(torch.sum(alive), min=1.0)


def schedule_regularization_factor(iteration: int, initial_factor: float = 0.5,
                                   time_interval: int = 1000,
                                   downscale_factor: float = 2.0,
                                   min_factor: float = 0.015) -> float:
    """Halve every 1000 iters, floored (matcha charts.py:108-113)."""
    n = iteration // time_interval
    return max(initial_factor / (downscale_factor ** n), min_factor)


def schedule_depth_order_lambda(iteration: int) -> float:
    """0 → 1 → .1 → .01 → .001 at 1.5k/3k/4.5k/6k (:450-478)."""
    for after, lam in ((6000, 0.001), (4500, 0.01), (3000, 0.1), (1500, 1.0)):
        if iteration > after:
            return lam
    return 0.0


def psnr(pred, target) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
