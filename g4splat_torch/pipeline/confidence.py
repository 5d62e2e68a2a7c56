"""Cross-view consistency ("confidence") maps for generated views
(counterpart of `g4splat_tpu.pipeline.confidence`).

After plane refinement each view's refined points are projected into every
view; a point is visible in a view when its projected depth agrees with that
view's refined depth within 10 % (relative). In See3D-generated views, pixels
whose point an input view already saw get confidence 0, and points no input
view saw take one colour (from the first view that sees them) in every
generated view that sees them. Input views are all ones.

Everything runs on the device of the depths: the (P, V) visibility as bool
and the (P, V, 2) pixel coordinates as int32 (rounded half to even,
window [-0.5, W-0.5], clamped, as the JAX package does). Where several
points land on one pixel, the last one writes, as numpy's assignment does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from g4splat_torch.core.cameras import camera_at
from g4splat_torch.core.geometry import pixel_index


class ConsistencyOut(NamedTuple):
    confident_maps: torch.Tensor      # (V, H, W) uint8 in {0, 1}
    harmonized_images: torch.Tensor   # (V, H, W, 3) with colours unified
    visibility: torch.Tensor          # (P, V) bool


def project_visibility(cameras, points: torch.Tensor, depths: torch.Tensor,
                       depth_threshold: float = 0.1):
    """(P, V) visibility and (P, V, 2) int32 pixel coordinates (u, v)."""
    V, H, W = depths.shape
    P = points.shape[0]
    vis = torch.empty((P, V), dtype=torch.bool, device=points.device)
    coords = torch.empty((P, V, 2), dtype=torch.int32, device=points.device)
    for v in range(V):
        xy, z = camera_at(cameras, v).project(points)
        u = pixel_index(torch.round(xy[:, 0]), W - 1)
        vv = pixel_index(torch.round(xy[:, 1]), H - 1)
        in_img = ((xy[:, 0] >= -0.5) & (xy[:, 0] <= W - 0.5) & (xy[:, 1] >= -0.5)
                  & (xy[:, 1] <= H - 0.5) & (z > 0))
        rel = torch.abs(z - depths[v][vv, u]) / (z + 1e-6)
        vis[:, v] = in_img & (rel < depth_threshold)
        coords[:, v, 0] = u.to(torch.int32)
        coords[:, v, 1] = vv.to(torch.int32)
    return vis, coords


def build_visibility_masks(cameras, depths: torch.Tensor, depth_threshold: float = 0.1,
                           least_num_views: int = 1):
    """Per pixel of each view, the number of OTHER views whose depth agrees
    with its point (< 10 % relative), and that count ≥ least_num_views.
    Returns (counts (V, H, W) float32, masks (V, H, W) bool)."""
    V, H, W = depths.shape
    counts = []
    for i in range(V):
        pts = camera_at(cameras, i).backproject(depths[i]).reshape(-1, 3)
        vis, _ = project_visibility(cameras, pts, depths, depth_threshold)
        counts.append((vis.sum(dim=1) - vis[:, i].to(torch.int64)).reshape(H, W)
                      .to(torch.float32))
    counts = torch.stack(counts)
    return counts, counts >= least_num_views


def _last_writer(lin: torch.Tensor) -> torch.Tensor:
    """Positions in `lin` (flat pixel indices) that write last to their pixel."""
    pos = torch.arange(lin.numel(), device=lin.device)
    last = torch.full((int(lin.max()) + 1,), -1, dtype=torch.int64, device=lin.device)
    last.scatter_reduce_(0, lin, pos, reduce="amax")
    return last[lin] == pos


def anchor_plane_color_harmonize(cameras, depths: torch.Tensor, images: torch.Tensor,
                                 plane_masks, global_plane_dict, anchor_view_ids,
                                 depth_threshold: float = 0.1) -> torch.Tensor:
    """Stage-3 anchor colours: for every global plane, the anchor view that
    sees most of its points; in each other member view, the plane pixels
    whose points project depth-consistently into that anchor take the
    anchor's colour. Views are recoloured in place in plane order, so a later
    plane reads an anchor already recoloured. Returns the recoloured stack."""
    images = images.clone()
    V, H, W = depths.shape
    dev = depths.device
    w2p = torch.stack([camera_at(cameras, v).world2pix for v in range(V)])

    def project(view, p):
        ph = p @ w2p[view, :, :3].T + w2p[view, :, 3]
        z = ph[:, 2]
        return ph[:, :2] / (z[:, None] + 1e-8), z

    def inside(xy, z):
        return (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H) & (z > 0)

    pts = [camera_at(cameras, v).backproject(depths[v]).reshape(-1, 3) for v in range(V)]
    masks = {}

    def member_mask(v, pid):
        if (v, pid) not in masks:
            masks[(v, pid)] = torch.as_tensor(plane_masks[v], device=dev).reshape(-1) == pid
        return masks[(v, pid)]

    for members in global_plane_dict.values():
        plane_pts = [pts[v][member_mask(v, pid)] for v, pid in members]
        if not plane_pts:
            continue
        pool = torch.cat([p for p in plane_pts if len(p)] or [pts[0][:0]])
        if len(pool) == 0:
            continue
        best, best_n = -1, 0
        for a in anchor_view_ids:
            n = int(inside(*project(a, pool)).sum())
            if n > best_n:
                best, best_n = a, n
        if best < 0:
            continue
        adepth, aimg = depths[best], images[best]
        for (v, pid), p in zip(members, plane_pts):
            if v == best or len(p) == 0:
                continue
            xy, z = project(best, p)
            u = pixel_index(torch.round(xy[:, 0]), W - 1)
            vv = pixel_index(torch.round(xy[:, 1]), H - 1)
            ok = inside(xy, z) & (torch.abs(z - adepth[vv, u]) / (z + 1e-6) < depth_threshold)
            pix = torch.nonzero(member_mask(v, pid)).squeeze(1)[ok]
            images[v].reshape(-1, 3)[pix] = aimg[vv[ok], u[ok]]
    return images


def compute_confidence_maps(cameras, points: torch.Tensor, depths: torch.Tensor,
                            images: torch.Tensor, input_view_num: int,
                            depth_threshold: float = 0.1) -> ConsistencyOut:
    V, H, W = depths.shape
    vis, coords = project_visibility(cameras, points.to(torch.float32), depths,
                                     depth_threshold)
    images = images.clone()
    seen_in_input = vis[:, :input_view_num].any(dim=1)

    # One colour per point no input view saw: from the first view that sees it.
    point_colors = torch.zeros((points.shape[0], 3), dtype=torch.float32, device=depths.device)
    unseen_idx = torch.nonzero(~seen_in_input & vis.any(dim=1)).squeeze(1)
    if unseen_idx.numel():
        first_view = torch.argmax(vis[unseen_idx].to(torch.uint8), dim=1)
        c = coords[unseen_idx, first_view].to(torch.int64)
        point_colors[unseen_idx] = images[first_view, c[:, 1], c[:, 0]]

    conf = torch.ones((V, H, W), dtype=torch.uint8, device=depths.device)
    for view in range(input_view_num, V):
        visible = torch.nonzero(vis[:, view]).squeeze(1)
        if visible.numel() == 0:
            continue
        c = coords[visible, view].to(torch.int64)
        lin = c[:, 1] * W + c[:, 0]
        in_input = seen_in_input[visible]
        conf[view].reshape(-1)[lin[in_input]] = 0
        new = ~in_input
        if bool(new.any()):
            lin_new, src = lin[new], visible[new]
            last = _last_writer(lin_new)
            images[view].reshape(-1, 3)[lin_new[last]] = point_colors[src[last]]
    return ConsistencyOut(conf, images, vis)
