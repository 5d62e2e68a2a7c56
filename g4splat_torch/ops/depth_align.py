"""Closed-form affine alignment of monocular disparity / depth to metric depth
(counterpart of `g4splat_tpu.ops.depth_align`).

A weighted least-squares fit of ``target ≈ alpha + beta·source`` in
disparity space (DepthAnythingV2 outputs disparity up to an affine map) or in
depth space, with a RANSAC variant whose draws are the JAX package's
(`np.random.default_rng(seed)`):

    beta  = [Σw·t·s − Σw·t·Σw·s/Σw] / [Σw·s² − (Σw·s)²/Σw]
    alpha = Σw·(t − beta·s) / Σw
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from g4splat_torch.core.geometry import bilinear_sample


def affine_fit(source: torch.Tensor, target: torch.Tensor,
               weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted LS fit target ≈ alpha + beta·source; masked samples get w=0."""
    w = weights
    sw = torch.sum(w)
    sws = torch.sum(w * source)
    swt = torch.sum(w * target)
    swss = torch.sum(w * source * source)
    swts = torch.sum(w * target * source)
    beta_num = swts - swt * sws / sw
    beta_den = swss - sws * sws / sw
    beta = beta_num / torch.where(torch.abs(beta_den) < 1e-20, torch.ones_like(beta_den),
                                  beta_den)
    alpha = (swt - beta * sws) / sw
    return alpha, beta


def fit_disparity_to_depth(disp: torch.Tensor, ref_depth: torch.Tensor,
                           sample_disp: torch.Tensor, weights: torch.Tensor):
    """Fit 1/ref_depth ≈ alpha + beta·sample_disp, then depth =
    1/(alpha + beta·disp). Returns (aligned depth (H, W), alpha, beta)."""
    true_disp = 1.0 / torch.clamp(ref_depth, min=1e-8)
    alpha, beta = affine_fit(sample_disp, true_disp, weights)
    return 1.0 / torch.clamp(alpha + beta * disp, min=1e-8), alpha, beta


def depth_linear_align(disp: torch.Tensor, render_depth: torch.Tensor,
                       visible_mask: torch.Tensor):
    """Fit the disparity to a rendered depth map inside a visibility mask.
    Returns (aligned depth, alpha, beta)."""
    w = visible_mask.to(torch.float32).reshape(-1)
    t = 1.0 / torch.clamp(render_depth.reshape(-1), min=1e-8)
    alpha, beta = affine_fit(disp.reshape(-1), t, w)
    return 1.0 / torch.clamp(alpha + beta * disp, min=1e-8), alpha, beta


def depth_linear_align_depth_space(depth: torch.Tensor, render_depth: torch.Tensor,
                                   visible_mask: torch.Tensor):
    """The fit in depth space. Returns (aligned depth, alpha, beta)."""
    w = visible_mask.to(torch.float32).reshape(-1)
    alpha, beta = affine_fit(depth.reshape(-1), render_depth.reshape(-1), w)
    return alpha + beta * depth, alpha, beta


def _ransac(s: np.ndarray, t: np.ndarray, min_samples: int, residual_threshold: float,
            seed: int, n_trials: int = 100):
    """The best inlier mask of `n_trials` minimal line fits t ≈ a + b·s
    (first best on ties), and its count; (None, -1) if no fit succeeded."""
    n = len(s)
    rng = np.random.default_rng(seed)
    best_inliers, best_count = None, -1
    for _ in range(n_trials):
        idx = rng.choice(n, min_samples, replace=False)
        A = np.stack([np.ones(min_samples), s[idx]], axis=1)
        try:
            coef, *_ = np.linalg.lstsq(A, t[idx], rcond=None)
        except np.linalg.LinAlgError:
            continue
        inliers = np.abs(coef[0] + coef[1] * s - t) < residual_threshold
        c = int(inliers.sum())
        if c > best_count:
            best_count, best_inliers = c, inliers
    return best_inliers, best_count


def depth_linear_align_ransac(depth, render_depth, visible_mask, min_samples: int = 5,
                              residual_threshold: float = 0.02, seed: int = 42):
    """RANSAC affine fit in depth space on the host (a line fit: tiny).
    Returns (aligned depth, alpha, beta, inlier ratio)."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    depth, render_depth = host(depth), host(render_depth)
    vis = host(visible_mask).astype(bool)
    s, t = depth[vis].reshape(-1), render_depth[vis].reshape(-1)
    if len(s) < min_samples:
        return depth, 0.0, 1.0, 0.0
    best_inliers, best_count = _ransac(s, t, min_samples, residual_threshold, seed)
    if best_inliers is None or best_count < 2:
        return 0.0 + 1.0 * depth, 0.0, 1.0, 0.0
    A = np.stack([np.ones(best_count), s[best_inliers]], axis=1)
    coef, *_ = np.linalg.lstsq(A, t[best_inliers], rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])
    return alpha + beta * depth, alpha, beta, best_count / len(s)


def sample_disparity_at_points(disp: torch.Tensor, cam, pts_world: torch.Tensor):
    """Project world points into the view and sample the disparity
    bilinearly: (samples (N,), in-frustum mask (N,), view depth (N,))."""
    xy, z = cam.project(pts_world)
    H, W = disp.shape
    in_fov = ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) & (xy[:, 1] >= 0)
              & (xy[:, 1] <= H - 1) & (z > 0))
    return bilinear_sample(disp[..., None], xy)[..., 0], in_fov, z
