"""Plane priors: per-view plane segmentation, global plane merging and
plane-refined depth (counterpart of `g4splat_tpu.pipeline.planes`).

Where the work lies:
- the normal clustering (`ops.kmeans`: sklearn's seeding draw for draw on
  the host, the Lloyd iterations on the normals' device), the RANSAC
  inlier counts (every trial at once) and the plane depths run on the
  device of the maps;
- the connected components (`scipy.ndimage`), the per-view instance maps,
  the global merge over point ids and the 3-point and refit SVDs stay on the
  host, in numpy, as in the JAX package, so each decision (cluster order on
  equal counts, the RANSAC draws of `np.random.default_rng(seed)`, the SVD's
  normal) is numpy's own.

`merge_global_planes` takes a faster route when the per-view planes' point
ids are pairwise disjoint (the pipeline's pixel → point ids are unique per
pixel): the overlap with every global plane is one `bincount` of the ids'
owners, the same first-match merge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from g4splat_torch.core.cameras import camera_at
from g4splat_torch.ops.kmeans import kmeans


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------- normal cluster
def _sorted_topk(counts: np.ndarray, k: int) -> np.ndarray:
    topk = np.argpartition(counts, -k)[-k:]
    return topk[np.argsort(counts[topk])][::-1]


def merge_normal_clusters(pred: torch.Tensor, sorted_topk, centers, cos_thresh: float = 0.95):
    """Merge clusters whose unit centres agree within cos > 0.95."""
    new_pred = pred.clone()
    centers = _host(centers)
    centers = centers / np.maximum(np.linalg.norm(centers, axis=1, keepdims=True), 1e-12)
    num = len(sorted_topk)
    dead = np.zeros(num, bool)
    n_left = num
    for i in range(num):
        if dead[i]:
            continue
        for j in range(i + 1, num):
            if dead[j]:
                continue
            if np.dot(centers[sorted_topk[i]], centers[sorted_topk[j]]) > cos_thresh:
                new_pred[pred == int(sorted_topk[j])] = int(sorted_topk[i])
                dead[j] = True
                n_left -= 1
    if n_left != num:
        sorted_topk = _sorted_topk(torch.bincount(new_pred).cpu().numpy(), n_left)
    return new_pred, sorted_topk, n_left


def remove_small_components(mask: np.ndarray, min_size: float) -> np.ndarray:
    """Open with a 3×3 square, then drop connected components under min_size."""
    from scipy import ndimage

    cleaned = ndimage.binary_opening(mask, structure=np.ones((3, 3), bool))
    labels, n = ndimage.label(cleaned)
    if n == 0:
        return np.zeros_like(mask)
    sizes = np.bincount(labels.reshape(-1))
    keep = np.zeros(n + 1, bool)
    keep[1:] = sizes[1:] >= min_size
    return keep[labels]


def normals_cluster(normals, img_shape: Tuple[int, int], n_init_clusters: int = 8,
                    n_clusters: int = 6, min_size_ratio: float = 0.004,
                    seed: int = 0) -> List[np.ndarray]:
    """K-means over the pixel normals, near-parallel clusters merged, the
    largest `n_clusters` split into connected components: a list of (H, W)
    bool masks (host)."""
    from scipy import ndimage

    flat = torch.as_tensor(normals).reshape(-1, 3).to(torch.float32)
    pred, centers = kmeans(flat, n_init_clusters, seed=seed)
    all_sorted = np.argsort(torch.bincount(pred, minlength=n_init_clusters).cpu().numpy())[::-1]
    pred, sorted_topk, num = merge_normal_clusters(pred, all_sorted, centers)
    num = min(num, n_clusters)
    min_size = img_shape[0] * img_shape[1] * min_size_ratio
    pred = pred.cpu().numpy()
    masks = []
    for c in range(num):
        m = (pred == sorted_topk[c]).reshape(img_shape)
        m = m & remove_small_components(m, min_size)
        labels, n = ndimage.label(m)
        for k in range(1, n + 1):
            masks.append(labels == k)
    return masks


def normals_cluster_1d(valid_normals, n_init_clusters: int = 8, n_clusters: int = 6,
                       min_size_ratio: float = 0.004, seed: int = 0):
    """K-means over a point set's normals: (masks over the points, on their
    device; unit centres (host)) of the largest clusters."""
    valid_normals = torch.as_tensor(valid_normals).to(torch.float32)
    n = valid_normals.shape[0]
    if n < n_init_clusters:
        vn = _host(valid_normals)
        return [torch.ones(n, dtype=torch.bool, device=valid_normals.device)], (
            vn.mean(0, keepdims=True) / np.linalg.norm(vn.mean(0) + 1e-12))
    labels, centers = kmeans(valid_normals, n_init_clusters, seed=seed)
    counts = torch.bincount(labels, minlength=n_init_clusters).cpu().numpy()
    topk = np.argpartition(counts, -min(n_clusters, len(counts)))[-n_clusters:]
    sorted_topk = topk[np.argsort(counts[topk])][::-1]
    centers = _host(centers)
    masks, out_centers = [], []
    for cid in sorted_topk:
        if counts[cid] < n * min_size_ratio:
            continue
        masks.append(labels == int(cid))
        c = centers[cid]
        out_centers.append(c / max(np.linalg.norm(c), 1e-12))
    return masks, np.array(out_centers)


# --------------------------------------------------------------- plane masks
@dataclass
class PlaneExcavatorConfig:
    min_size_ratio: float = 0.004
    n_init_normal_clusters: int = 8
    n_normal_clusters: int = 6
    num_prompts: int = 256
    max_instances: int = 100


class PlaneExcavator:
    """Per-view plane instance segmentation: segmentation proposals
    (`mask_generator(image) → list of (H, W) bool masks`, or precomputed
    `seg_masks`) intersected with the normal clusters, smallest proposal
    first, then renumbered and area-filtered. With neither, the normal
    clusters alone are the proposals."""

    def __init__(self, config: PlaneExcavatorConfig = PlaneExcavatorConfig(),
                 mask_generator: Optional[Callable] = None):
        self.config = config
        self.mask_generator = mask_generator

    def __call__(self, image, normals, seg_masks=None):
        H, W = normals.shape[:2]
        cfg = self.config
        min_size = H * W * cfg.min_size_ratio
        normal_clusters = normals_cluster(normals, (H, W), cfg.n_init_normal_clusters,
                                          cfg.n_normal_clusters, cfg.min_size_ratio)
        if seg_masks is None and self.mask_generator is not None:
            seg_masks = self.mask_generator(image)
        if seg_masks is not None:
            seg_masks = sorted((_host(m) for m in seg_masks), key=lambda m: m.sum())
        else:
            seg_masks = [np.ones((H, W), bool)]

        seg = np.zeros((H, W), np.int32)
        count = 0
        for m in seg_masks:
            for nm in normal_clusters:
                inter = m & nm
                if inter.sum() < min_size:
                    continue
                count += 1
                seg[inter] = count

        nrm_h = _host(normals)
        out_seg = np.zeros_like(seg)
        avg_normals, areas = [], []
        new_count = 0
        for i in range(min(cfg.max_instances, count)):
            m = seg == i + 1
            area = int(m.sum())
            if area < min_size:
                continue
            new_count += 1
            out_seg[m] = new_count
            areas.append(area)
            nrm = nrm_h[m].mean(0)
            nn = np.linalg.norm(nrm)
            avg_normals.append(nrm / nn if nn > 1e-8 else np.array([0.0, 0.0, 1.0], nrm.dtype))
        return {"seg_mask": out_seg,
                "normal": np.array(avg_normals) if avg_normals else None,
                "areas": np.array(areas) if areas else None}


# ------------------------------------------------------- global plane merging
def covisibility_rate(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.intersect1d(a, b, assume_unique=True)
    if len(a) == 0 or len(b) == 0:
        return 0.0
    return max(len(inter) / len(a), len(inter) / len(b))


def _view_planes(pixel_point_ids, plane_masks):
    """Per view and plane id, the plane's unique non-zero point ids."""
    out = []
    for view_id, (pid_map, pmask) in enumerate(zip(pixel_point_ids, plane_masks)):
        pid_map, pmask = _host(pid_map), _host(pmask)
        for plane_id in np.unique(pmask):
            if plane_id == 0:
                continue
            ids = np.unique(pid_map[pmask == plane_id])
            ids = ids[ids != 0]
            if len(ids):
                out.append((view_id, int(plane_id), ids))
    return out


def merge_global_planes(pixel_point_ids: Sequence, plane_masks: Sequence,
                        covisible_ratio_thresh: float = 0.5
                        ) -> Tuple[List[np.ndarray], Dict[int, List[Tuple[int, int]]]]:
    """Greedy cross-view merge on shared point ids. Returns (per global plane
    its sorted point ids, {global id: [(view, plane id), …]})."""
    planes = _view_planes(pixel_point_ids, plane_masks)
    if not planes:
        return [], {}
    all_ids = np.concatenate([ids for _, _, ids in planes])
    if len(np.unique(all_ids)) == len(all_ids):
        # No point id in two per-view planes: no overlap, so nothing merges.
        return ([ids for _, _, ids in planes],
                {i: [(v, p)] for i, (v, p, _) in enumerate(planes)})

    plane_pts: List[np.ndarray] = []
    plane_dict: Dict[int, List[Tuple[int, int]]] = {}
    for view_id, plane_id, ids in planes:
        for gi in range(len(plane_pts)):
            if covisibility_rate(plane_pts[gi], ids) > covisible_ratio_thresh:
                plane_pts[gi] = np.union1d(plane_pts[gi], ids)
                plane_dict[gi].append((view_id, plane_id))
                break
        else:
            plane_dict[len(plane_pts)] = [(view_id, plane_id)]
            plane_pts.append(ids)

    out_pts: List[np.ndarray] = []
    out_dict: Dict[int, List[Tuple[int, int]]] = {}
    dead = [False] * len(plane_pts)
    for i in range(len(plane_pts)):
        if dead[i]:
            continue
        cur = plane_pts[i]
        ids = list(plane_dict[i])
        for j in range(i + 1, len(plane_pts)):
            if not dead[j] and covisibility_rate(cur, plane_pts[j]) > covisible_ratio_thresh:
                cur = np.union1d(cur, plane_pts[j])
                ids.extend(plane_dict[j])
                dead[j] = True
        out_dict[len(out_pts)] = ids
        out_pts.append(cur)
        dead[i] = True
    return out_pts, out_dict


# ------------------------------------------------------------ plane fitting
def fit_plane_svd(points: np.ndarray) -> Tuple[np.ndarray, float]:
    """Plane normal and offset by PCA (host numpy)."""
    centroid = points.mean(0)
    _, _, Vt = np.linalg.svd(points - centroid, full_matrices=False)
    normal = Vt[-1]
    return normal, -float(normal @ centroid)


def _fit_plane_prior(points: np.ndarray, prior_normal: np.ndarray,
                     alpha: float = 1.0) -> Tuple[np.ndarray, float]:
    """The SVD normal blended toward the prior, offset refit."""
    n_svd, _ = fit_plane_svd(points)
    if np.dot(n_svd, prior_normal) < 0:
        n_svd = -n_svd
    w = alpha / (1.0 + alpha)
    normal = (1 - w) * n_svd + w * prior_normal
    normal = normal / max(np.linalg.norm(normal), 1e-12)
    return normal, -float(normal @ points.mean(0))


def fit_plane_ransac(points: torch.Tensor, threshold: float = 0.01, min_samples: int = 3,
                     max_trials: int = 1000, alpha: float = 1.0, prior_normal=None,
                     seed: int = 42, trial_chunk: int = 50):
    """RANSAC plane fit → (normal, point on the plane, inlier mask (host)).
    The draws and each trial's 3-point SVD are the JAX package's, on the
    host; every trial's inlier count is taken on the points' device, the
    first best trial kept."""
    pts_h = _host(points)
    pts_d = torch.as_tensor(points)
    n = pts_h.shape[0]
    if prior_normal is not None:
        prior_normal = np.asarray(prior_normal, np.float64)
        pn = np.linalg.norm(prior_normal)
        prior_normal = prior_normal / pn if pn > 1e-12 else None

    rng = np.random.default_rng(seed)
    trials = []
    for _ in range(min(max_trials, 200)):
        idx = rng.choice(n, min(min_samples, n), replace=False)
        if len(idx) < 3:
            break
        try:
            trials.append(fit_plane_svd(pts_h[idx]))
        except np.linalg.LinAlgError:
            continue
    best_inliers, best_count = None, -1
    if trials:
        normals = np.stack([nm for nm, _ in trials]).astype(pts_h.dtype)
        offs = np.array([d for _, d in trials], pts_h.dtype)
        counts = []
        for s in range(0, len(trials), trial_chunk):
            N = torch.as_tensor(normals[s:s + trial_chunk], device=pts_d.device)
            D = torch.as_tensor(offs[s:s + trial_chunk], device=pts_d.device)
            dist = torch.abs(pts_d[:, 0:1] * N[:, 0] + pts_d[:, 1:2] * N[:, 1]
                             + pts_d[:, 2:3] * N[:, 2] + D)
            counts.append((dist < threshold).sum(0))
        counts = torch.cat(counts).cpu().numpy()
        best = int(np.argmax(counts))
        best_count = int(counts[best])
        best_inliers = np.abs(pts_h @ trials[best][0] + trials[best][1]) < threshold
        best_count = int(best_inliers.sum())
    if best_inliers is None or best_count < 3:
        best_inliers = np.ones(n, bool)

    inl = pts_h[best_inliers]
    if prior_normal is not None:
        normal, d = _fit_plane_prior(inl, prior_normal, alpha)
    else:
        normal, d = fit_plane_svd(inl)
    centroid = inl.mean(0)
    return normal, centroid - (normal @ centroid + d) * normal, best_inliers


def compute_plane_aligned_depth(plane_normal, plane_center, camera,
                                img_shape: Tuple[int, int]) -> torch.Tensor:
    """View-z depth of each pixel's ray-plane intersection (H, W) on the
    camera's device; rays that miss (t ≤ 0) get 0."""
    origin, dirs = camera.pixel_rays()
    n = torch.as_tensor(np.asarray(plane_normal, np.float32), device=dirs.device)
    p0 = torch.as_tensor(np.asarray(plane_center, np.float32), device=dirs.device)
    denom = dirs @ n
    denom = torch.where(torch.abs(denom) < 1e-8,
                        torch.sign(denom) * 1e-8 + (denom == 0) * 1e-8, denom)
    t = ((p0 - origin) @ n) / denom
    return torch.where(t > 0, t, torch.zeros_like(t))


# --------------------------------------------------------- plane refinement
@dataclass
class PlaneRefineConfig:
    ransac_threshold: float = 0.01
    normal_cluster_min_ratio: float = 0.3
    min_member_points: int = 50
    prior_alpha: float = 1.0


def refine_depths_with_planes(cameras, depths: torch.Tensor, plane_masks: Sequence,
                              global_plane_dict: Dict[int, List[Tuple[int, int]]],
                              points: torch.Tensor, global_plane_points: Sequence,
                              rend_normals: Optional[torch.Tensor] = None,
                              config: PlaneRefineConfig = PlaneRefineConfig()):
    """Per global plane: its member points, a RANSAC plane (the dominant
    cluster of the members' rendered normals as a prior), then the plane
    depth over every member pixel in every member view. Returns (refined
    depths on the depths' device, fitted plane list)."""
    dev = depths.device
    refined = depths.clone()
    planes = []
    masks = {}

    def member_mask(view_id, plane_id):
        if (view_id, plane_id) not in masks:
            masks[(view_id, plane_id)] = torch.as_tensor(
                _host(plane_masks[view_id]) == plane_id, device=dev)
        return masks[(view_id, plane_id)]

    for gid, members in global_plane_dict.items():
        ids = np.asarray(global_plane_points[gid])
        ids = ids[(ids > 0) & (ids < len(points))]
        if len(ids) < config.min_member_points:
            continue
        pts = points[torch.as_tensor(ids, device=points.device)]

        prior = None
        if rend_normals is not None:
            nrms = [rend_normals[view_id][member_mask(view_id, plane_id)]
                    for view_id, plane_id in members]
            nrms = [x for x in nrms if len(x)]
            if nrms:
                nrms = torch.cat(nrms, 0)
                cl_masks, cl_centers = normals_cluster_1d(nrms)
                if len(cl_masks):
                    sizes = [int(m.sum()) for m in cl_masks]
                    best = int(np.argmax(sizes))
                    if sizes[best] >= config.normal_cluster_min_ratio * len(nrms):
                        prior = cl_centers[best]

        normal, center, inliers = fit_plane_ransac(
            pts, threshold=config.ransac_threshold, prior_normal=prior,
            alpha=config.prior_alpha)
        planes.append({"id": gid, "normal": normal, "center": center,
                       "n_inliers": int(inliers.sum()), "n_points": len(pts)})
        for view_id, plane_id in members:
            plane_depth = compute_plane_aligned_depth(normal, center,
                                                      camera_at(cameras, view_id),
                                                      depths.shape[1:3])
            m = member_mask(view_id, plane_id) & (plane_depth > 0)
            refined[view_id][m] = plane_depth[m]
    return refined, planes
