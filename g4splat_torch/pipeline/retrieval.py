"""Training-free image retrieval for the scene graph (a copy of
`g4splat_tpu.pipeline.retrieval`, numpy only).

Global descriptors are generalized-mean-pooled, shrinkage-whitened MASt3R
encoder tokens; similarity is one cosine-similarity matmul; the graph keeps
each image's top-k neighbours (symmetrised), links its components through
their most similar cross pair and pairs `na` anchor images with every
other, as the reference's 'retrieval-{na}a-{k}' graph does. At or below
`exhaustive_threshold` images it returns the exhaustive graph.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def gem_pool(tokens: np.ndarray, p: float = 3.0) -> np.ndarray:
    """(N, C) token features → (C,) generalized-mean pooled descriptor."""
    t = np.maximum(np.asarray(tokens, np.float64), 1e-6)
    return (t ** p).mean(axis=0) ** (1.0 / p)


def whiten(descs: np.ndarray, shrinkage: float = 0.7, eps: float = 1e-6):
    """Shrinkage-whitening fit on the collection itself. The reference's
    whitening is trained on a large external corpus; fit on the query
    collection alone, full whitening would equalize away exactly the
    between-image variance that makes retrieval work, so the covariance is
    shrunk toward a scaled identity (`shrinkage` → 1 = no whitening).
    Returns (unit descriptors, (mean, W))."""
    X = np.asarray(descs, np.float64)
    mu = X.mean(axis=0)
    Xc = X - mu
    C = X.shape[1]
    cov = Xc.T @ Xc / max(len(X) - 1, 1)
    cov = (1 - shrinkage) * cov + shrinkage * (np.trace(cov) / C) * np.eye(C)
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, eps)
    W = vecs @ np.diag(vals ** -0.5) @ vecs.T
    Y = Xc @ W
    Y /= np.linalg.norm(Y, axis=1, keepdims=True) + 1e-12
    return Y.astype(np.float32), (mu, W)


def similarity_matrix(descs: np.ndarray) -> np.ndarray:
    """(V, V) cosine similarities of unit descriptors (self = -inf)."""
    S = descs @ descs.T
    np.fill_diagonal(S, -np.inf)
    return S


def retrieval_pairs(
    image_features: List[np.ndarray],    # per image (N_tokens, C)
    k: int = 10,
    na: int = 3,
    exhaustive_threshold: int = 20,
) -> List[Tuple[int, int]]:
    """Scene-graph pairs: top-k neighbors per image + an anchor chain keeping
    the graph connected (reference scene_graph='retrieval-{na}a-{k}')."""
    V = len(image_features)
    if V <= exhaustive_threshold:
        return [(i, j) for i in range(V) for j in range(i + 1, V)]

    descs = np.stack([gem_pool(f) for f in image_features])
    descs, _ = whiten(descs)
    S = similarity_matrix(descs)

    pairs = set()
    for i in range(V):
        for j in np.argsort(S[i])[::-1][:k]:
            pairs.add((min(i, int(j)), max(i, int(j))))

    # Connectivity: greedily link components through their most similar
    # cross pair (the reference's anchor images play the same role).
    parent = list(range(V))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in pairs:
        parent[find(i)] = find(j)
    comps = {}
    for v in range(V):
        comps.setdefault(find(v), []).append(v)
    comp_list = list(comps.values())
    while len(comp_list) > 1:
        a = comp_list[0]
        best = None
        for ci in range(1, len(comp_list)):
            sub = S[np.ix_(a, comp_list[ci])]
            idx = np.unravel_index(np.argmax(sub), sub.shape)
            val = sub[idx]
            if best is None or val > best[0]:
                best = (val, a[idx[0]], comp_list[ci][idx[1]], ci)
        _, i, j, ci = best
        pairs.add((min(i, j), max(i, j)))
        a.extend(comp_list.pop(ci))

    # Anchors: the na globally best-connected images pair with everything
    # (cheap insurance for loop closure).
    strength = np.where(np.isfinite(S), S, 0).sum(axis=1)
    anchors = np.argsort(strength)[::-1][:na]
    for a in anchors:
        for v in range(V):
            if v != a:
                pairs.add((min(int(a), v), max(int(a), v)))
    return sorted(pairs)
