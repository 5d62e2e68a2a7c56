"""Marching tetrahedra, Delaunay cells and cube-grid tets on the host (a
copy of `g4splat_tpu.ops.tetra`, which the port does not import).

Replaces the reference's torch marching-tetra (2d-gaussian-splatting/utils/
tetmesh.py:47-141, the standard kaolin 16-case table) and its CGAL Delaunay
extension (submodules/tetra-triangulation). Both are host work, vectorized
numpy and scipy's Qhull: triangulation is inherently sequential, and the
marching output's size depends on the data. Only the TSDF evaluation
(ops/tsdf.py) runs on the card.

`marching_tetrahedra` does not interpolate crossings: it returns each
crossing edge's endpoints and SDF values, so the mesh extractor can
binary-search the true TSDF along the edge (extract_mesh_adaptive_tsdf.py:
328-351). `delaunay_tetrahedralize` jitters with `default_rng(0)` and runs
Qhull with "QJ", so identical points give identical cells in both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

# 16-case tetrahedron triangulation (standard kaolin/NVIDIA table; edge ids
# index the 6 tet edges in `TET_EDGES` order).
TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], dtype=np.int64)
NUM_TRIANGLES = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], dtype=np.int64
)
TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3], dtype=np.int64)


class MarchingTetsOut(NamedTuple):
    edge_verts: np.ndarray   # (E, 2, 3) endpoints of each crossing edge
    edge_sdf: np.ndarray     # (E, 2) sdf at endpoints
    edge_scales: np.ndarray  # (E, 2) per-endpoint scales (for adaptive trunc)
    faces: np.ndarray        # (F, 3) int indices into the E crossing edges
    edges: np.ndarray        # (E, 2) endpoint vertex indices


def marching_tetrahedra(
    vertices: np.ndarray,   # (N, 3)
    tets: np.ndarray,       # (M, 4) int
    sdf: np.ndarray,        # (N,)
    scales: np.ndarray,     # (N,)
) -> MarchingTetsOut:
    vertices = np.asarray(vertices, np.float32)
    tets = np.asarray(tets, np.int64)
    sdf = np.asarray(sdf, np.float32)
    scales = np.asarray(scales, np.float32)

    occ = sdf > 0
    occ4 = occ[tets]                      # (M, 4)
    occ_sum = occ4.sum(-1)
    valid = (occ_sum > 0) & (occ_sum < 4)
    vt = tets[valid]                      # (Mv, 4)
    occ4 = occ4[valid]

    # All 6 edges of each valid tet, endpoint-sorted for dedup.
    all_edges = vt[:, TET_EDGES].reshape(-1, 2)
    all_edges = np.sort(all_edges, axis=1)
    unique_edges, idx_map = np.unique(all_edges, axis=0, return_inverse=True)

    crossing = occ[unique_edges].sum(-1) == 1
    mapping = np.full(len(unique_edges), -1, np.int64)
    mapping[crossing] = np.arange(crossing.sum())
    idx_map = mapping[idx_map].reshape(-1, 6)  # (Mv, 6) — -1 for non-crossing

    interp = unique_edges[crossing]            # (E, 2)
    edge_verts = vertices[interp]              # (E, 2, 3)
    edge_sdf = sdf[interp]                     # (E, 2)
    edge_scales = scales[interp]

    tetindex = (occ4 * (1 << np.arange(4))).sum(-1)
    ntri = NUM_TRIANGLES[tetindex]
    tri_rows = TRIANGLE_TABLE[tetindex]        # (Mv, 6)

    one = np.take_along_axis(tri_rows[ntri == 1], np.arange(3)[None], 1)
    faces1 = np.take_along_axis(idx_map[ntri == 1], one, 1)
    two = tri_rows[ntri == 2][:, :6]
    faces2 = np.take_along_axis(idx_map[ntri == 2], two, 1).reshape(-1, 3)
    faces = np.concatenate([faces1.reshape(-1, 3), faces2], axis=0)
    return MarchingTetsOut(edge_verts, edge_sdf, edge_scales, faces, interp)


def delaunay_tetrahedralize(points: np.ndarray) -> np.ndarray:
    """(N, 3) → (M, 4) Delaunay cells. Host-side, replacing the reference's
    CGAL binding (`tetranerf.utils.extension.cpp.triangulate`); scipy's Qhull
    is the native backend here."""
    from scipy.spatial import Delaunay

    points = np.asarray(points, np.float64)
    # Tiny jitter guards Qhull against exactly-degenerate cospherical input
    # (the 8-corners-of-a-box point pattern is pathological for it).
    rng = np.random.default_rng(0)
    extent = points.max(0) - points.min(0)
    jitter = rng.normal(0, 1e-6 * max(float(extent.max()), 1e-6), points.shape)
    tri = Delaunay(points + jitter, qhull_options="QJ")
    return tri.simplices.astype(np.int64)


def cube_grid_to_tets(res: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Regular grid → (grid_points_shape, tets): split every cell into 6 tets.

    Used by the multi-resolution voxel TSDF fusion path (replacing the
    reference's open3d ScalableTSDFVolume + marching cubes,
    utils/mesh_utils.py:140-184) so the same marching-tetra code serves both
    adaptive and uniform grids.
    """
    nx, ny, nz = res
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    c = idx[:-1, :-1, :-1].reshape(-1)
    dx, dy, dz = ny * nz, nz, 1
    v0 = c
    v1 = c + dx
    v2 = c + dy
    v3 = c + dz
    v4 = c + dx + dy
    v5 = c + dx + dz
    v6 = c + dy + dz
    v7 = c + dx + dy + dz
    # 6-tet decomposition of the cube (consistent diagonal v0-v7).
    tets = np.stack([
        np.stack([v0, v1, v4, v7], 1),
        np.stack([v0, v4, v2, v7], 1),
        np.stack([v0, v2, v6, v7], 1),
        np.stack([v0, v6, v3, v7], 1),
        np.stack([v0, v3, v5, v7], 1),
        np.stack([v0, v5, v1, v7], 1),
    ], axis=0).reshape(-1, 4)
    return idx.shape, tets.astype(np.int64)
