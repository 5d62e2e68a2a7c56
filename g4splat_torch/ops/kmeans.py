"""K-means with sklearn's k-means++ seeding and Lloyd iterations, for the
normal clustering of the plane priors (the JAX package calls
`sklearn.cluster.KMeans(n_clusters, random_state=seed, n_init=1)`, and the
port does not depend on sklearn).

`kmeans` follows `sklearn.cluster.KMeans.fit` (sklearn 1.x, dense input,
``algorithm="lloyd"``, unit sample weights):
- the data are centred on their mean, and the tolerance is 1e-4 × the mean
  per-feature variance;
- greedy k-means++ on the host, draw for draw with
  ``np.random.RandomState(seed)``: the first centre by ``choice`` over the
  uniform weights, then per centre ``2 + int(log k)`` local trials drawn by
  ``searchsorted`` into the float32 cumulative potential, the candidate that
  lowers the potential most kept; squared distances are taken in float64
  and stored in float32, as sklearn's upcast path does;
- Lloyd iterations on the data's device (float64): assign each point to its
  nearest centre (first on ties), move each centre to its points' mean, stop
  when the labels repeat or the squared centre shift falls to the tolerance,
  at most `max_iter` times; without a repeat the labels are taken once more
  from the last centres. An empty cluster takes the point farthest from its
  centre (sklearn takes them in `argpartition` order; the port in
  descending distance).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _sq_dists_f32(C: np.ndarray, X: np.ndarray) -> np.ndarray:
    """(k, n) squared distances ||c||² − 2 c·x + ||x||² taken in float64,
    stored as float32 and clamped at 0 (sklearn's `_euclidean_distances`
    for float32 data)."""
    C64, X64 = C.astype(np.float64), X.astype(np.float64)
    d = -2 * (C64 @ X64.T)
    d += np.einsum("ij,ij->i", C64, C64)[:, None]
    d += np.einsum("ij,ij->i", X64, X64)[None, :]
    return np.maximum(d.astype(np.float32), 0)


def kmeans_plusplus(X: np.ndarray, n_clusters: int, random_state: np.random.RandomState
                    ) -> np.ndarray:
    """sklearn's greedy k-means++ on centred float32 data → (k, d) centres."""
    n = X.shape[0]
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    sample_weight = np.ones(n, dtype=X.dtype)
    center_id = random_state.choice(n, p=sample_weight / sample_weight.sum())
    centers[0] = X[center_id]
    closest_dist_sq = _sq_dists_f32(centers[0:1], X)
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        dist = _sq_dists_f32(X[candidate_ids], X)
        np.minimum(closest_dist_sq, dist, out=dist)
        candidates_pot = dist @ sample_weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = dist[best][None]
        centers[c] = X[candidate_ids[best]]
    return centers


def _assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest centre per point (first on ties), by ||c||² − 2 x·c."""
    return torch.argmin((centers * centers).sum(1)[None, :] - 2 * X @ centers.T, dim=1)


def _update(X: torch.Tensor, labels: torch.Tensor, centers_old: torch.Tensor):
    """New centres (means of their points; empty clusters relocated to the
    points farthest from their centres) and the per-centre shift."""
    k = centers_old.shape[0]
    sums = torch.zeros_like(centers_old).index_add_(0, labels, X)
    counts = torch.bincount(labels, minlength=k).to(X.dtype)
    empty = torch.nonzero(counts == 0).squeeze(1)
    if empty.numel():
        dist = ((X - centers_old[labels]) ** 2).sum(1)
        if float(dist.max()) > 0:
            far = torch.topk(dist, empty.numel()).indices
            for new_id, idx in zip(empty.tolist(), far.tolist()):
                old_id = int(labels[idx])
                sums[old_id] -= X[idx]
                sums[new_id] = X[idx]
                counts[new_id] = 1
                counts[old_id] -= 1
    centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1)[:, None], sums)
    return centers, torch.linalg.norm(centers - centers_old, dim=1)


def kmeans(X: torch.Tensor, n_clusters: int, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """`KMeans(n_clusters, random_state=seed, n_init=1).fit(X)` on an (n, d)
    float32 tensor → (labels (n,) int64, cluster centres (k, d) float32), both
    on X's device."""
    dev = X.device
    Xh = X.detach().to("cpu", torch.float32).numpy()
    tol = float(np.mean(np.var(Xh, axis=0))) * tol
    X_mean = Xh.mean(axis=0)
    Xc = Xh - X_mean
    init = kmeans_plusplus(Xc, n_clusters, np.random.RandomState(seed))

    Xd = torch.as_tensor(Xc, device=dev).to(torch.float64)
    centers = torch.as_tensor(init, device=dev).to(torch.float64)
    labels_old = torch.full((Xd.shape[0],), -1, dtype=torch.int64, device=dev)
    strict = False
    for _ in range(max_iter):
        labels = _assign(Xd, centers)
        centers, shift = _update(Xd, labels, centers)
        if torch.equal(labels, labels_old):
            strict = True
            break
        if float((shift ** 2).sum()) <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(Xd, centers)
    mean = torch.as_tensor(X_mean, device=dev).to(torch.float64)
    return labels, (centers + mean).to(torch.float32)
