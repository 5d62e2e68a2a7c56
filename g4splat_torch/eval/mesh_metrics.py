"""Mesh reconstruction metrics (a copy of `g4splat_tpu.eval.mesh_metrics`).

The reference's MonoSDF-style evaluation (2d-gaussian-splatting/eval/
mesh_eval.py:11-77): voxel-downsampled vertex clouds → nearest-neighbour
distances both ways → Acc / Comp / Chamfer-L1 (×100, cm for metre-scale
scenes) / Prec / Recal / F-score at 5 cm, and normal consistency on 200k
area-weighted surface samples. Host numpy and scipy; the JAX package's C++
k-NN (`native.py`) is replaced by scipy's cKDTree on float32 points, its own
fallback.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def knn(points: np.ndarray, queries: np.ndarray, k: int
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(dists (M, k) float32, idx (M, k) int32): the exact k nearest of
    `points` to each query, both cast to float32 first (scipy's cKDTree, as
    the JAX package's `native.knn` falls back to when its C++ k-NN is not
    built)."""
    pts = np.ascontiguousarray(points, np.float32)
    qs = np.ascontiguousarray(queries, np.float32)
    d, i = cKDTree(pts).query(qs, k=k)
    if k == 1:
        d, i = d[:, None], i[:, None]
    return d.astype(np.float32), i.astype(np.int32)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points per occupied voxel (open3d voxel_down_sample semantics)."""
    if voxel <= 0 or len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, inv, points)
    return sums / counts[:, None]


def sample_mesh_surface(
    vertices: np.ndarray, faces: np.ndarray, n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling → (points (n,3), face normals (n,3))."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    areas = 0.5 * np.linalg.norm(cross, axis=1)
    normals = cross / (np.linalg.norm(cross, axis=1, keepdims=True) + 1e-12)
    rng = np.random.default_rng(seed)
    probs = areas / max(areas.sum(), 1e-12)
    fidx = rng.choice(len(faces), n, p=probs)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    a = 1 - r1
    b = r1 * (1 - r2)
    c = r1 * r2
    pts = (a[:, None] * v0[fidx] + b[:, None] * v1[fidx] + c[:, None] * v2[fidx])
    return pts.astype(np.float32), normals[fidx].astype(np.float32)


def evaluate_mesh(
    pred_vertices: np.ndarray,
    pred_faces: Optional[np.ndarray],
    gt_vertices: np.ndarray,
    gt_faces: Optional[np.ndarray],
    threshold: float = 0.05,
    down_sample: float = 0.02,
    n_normal_samples: int = 200_000,
    seed: int = 0,
) -> Dict[str, float]:
    vp = voxel_downsample(pred_vertices[:, :3].astype(np.float64), down_sample)
    vt = voxel_downsample(gt_vertices[:, :3].astype(np.float64), down_sample)

    # dist1: gt→pred distances ("completeness"); dist2: pred→gt ("accuracy").
    dist1 = knn(vp, vt, 1)[0][:, 0]
    dist2 = knn(vt, vp, 1)[0][:, 0]

    precision = float((dist2 < threshold).mean())
    recall = float((dist1 < threshold).mean())
    fscore = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0 else 0.0
    )

    metrics = {
        "Acc": float(dist2.mean()) * 100,
        "Comp": float(dist1.mean()) * 100,
        "Chamfer-L1": float((dist2.mean() + dist1.mean()) / 2) * 100,
        "Prec": precision * 100,
        "Recal": recall * 100,
        "F-score": fscore * 100,
    }

    if pred_faces is not None and gt_faces is not None and len(pred_faces) and len(gt_faces):
        pp, np_pred = sample_mesh_surface(pred_vertices, pred_faces,
                                          n_normal_samples, seed)
        pt, np_gt = sample_mesh_surface(gt_vertices, gt_faces,
                                        n_normal_samples, seed + 1)
        i1 = knn(pp, pt, 1)[1][:, 0]  # for each gt sample: nearest pred
        i2 = knn(pt, pp, 1)[1][:, 0]  # for each pred sample: nearest gt
        normal_acc = float(np.abs((np_pred * np_gt[i2]).sum(-1)).mean())
        normal_comp = float(np.abs((np_gt * np_pred[i1]).sum(-1)).mean())
        metrics.update({
            "Normal-Acc": normal_acc * 100,
            "Normal-Comp": normal_comp * 100,
            "Normal-Consistency": (normal_acc + normal_comp) * 50,
        })
    return metrics
