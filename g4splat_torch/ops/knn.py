"""Nearest-neighbor distance ops (counterpart of `g4splat_tpu.ops.knn`; the
reference uses the simple-knn CUDA extension once, to seed Gaussian scales).

- `mean_knn_sq_dist_exact`: blocked O(N²) brute force, the oracle.
- `mean_knn_sq_dist`: Morton-sorted sliding-window approximation for large N
  (each point compared with its `2·window` neighbours in Z-order).
"""

from __future__ import annotations

import torch

K_NEIGHBORS = 3


def _pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 3), (m, 3) → (n, m) squared distances, |a|²+|b|²−2a·b."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True).T
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def mean_knn_sq_dist_exact(points: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """(N, 3) → (N,) mean squared distance to the 3 nearest neighbors."""
    n = points.shape[0]
    out = []
    cols = torch.arange(n, device=points.device)[None, :]
    for i in range(0, n, block):
        a = points[i:i + block]
        d2 = _pairwise_sq_dist(a, points)
        rows = torch.arange(i, i + a.shape[0], device=points.device)[:, None]
        d2 = torch.where(cols == rows, torch.inf, d2)
        d2 = torch.where(torch.isnan(d2), torch.inf, d2)
        if n - 1 < K_NEIGHBORS:       # fewer neighbours than k: pad with inf
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], K_NEIGHBORS), torch.inf)], 1)
        near = torch.topk(d2, K_NEIGHBORS, dim=-1, largest=False).values
        out.append(near.mean(-1))
    return torch.cat(out) if out else points.new_zeros(0)


def _morton_codes(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """(N, 3) → (N,) interleaved-bit Z-order codes on a 2^bits grid."""
    lo = points.min(0).values
    hi = points.max(0).values
    q = ((points - lo) / torch.clamp(hi - lo, min=1e-12) * (2**bits - 1)).to(torch.int64)

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def mean_knn_sq_dist(points: torch.Tensor, window: int = 128) -> torch.Tensor:
    """Approximate (N,) mean-3NN squared distance via Morton-order windows
    (exact brute force for N ≤ 4096)."""
    n = points.shape[0]
    if n <= 4096:
        return mean_knn_sq_dist_exact(points, block=min(2048, max(8, n)))
    order = torch.argsort(_morton_codes(points), stable=True)
    sorted_pts = points[order]
    pad = sorted_pts.new_full((window, 3), torch.inf)
    padded = torch.cat([pad, sorted_pts, pad], dim=0)
    offs = torch.cat([torch.arange(0, window), torch.arange(window + 1, 2 * window + 1)])
    offs = offs.to(points.device)
    mean_sorted = torch.empty(n, dtype=points.dtype, device=points.device)
    step = 1 << 16                      # bounds the (step, 2·window, 3) gather
    for i in range(0, n, step):
        idx = torch.arange(i, min(i + step, n), device=points.device)[:, None] + offs
        diff = padded[idx] - sorted_pts[i:i + step, None, :]
        d2 = torch.sum(diff * diff, dim=-1)
        d2 = torch.where(torch.isfinite(d2), d2, torch.inf)
        mean_sorted[i:i + step] = torch.topk(d2, K_NEIGHBORS, dim=-1,
                                             largest=False).values.mean(-1)
    out = torch.empty_like(mean_sorted)
    out[order] = mean_sorted
    return out
