"""Adaptive density control with static-capacity buffers (counterpart of
`g4splat_tpu.train.densify`).

The scene is a fixed-capacity buffer with an `alive` mask, and
clone/split/prune are masked scatters into free slots, kept slot for slot
with the JAX package (reference scene/gaussian_model.py:586-660):
- clone (:614-625): grad ≥ τ AND max scale ≤ percent_dense·extent → copy.
- split (:586-612): grad ≥ τ AND max scale > percent_dense·extent →
  2 children sampled N(0, scale) in the tangent plane, rotated, scales ÷ 1.6,
  parent pruned.
- prune (:627-647): opacity < min_opacity, non-finite parameters, or (after
  the first opacity reset) screen radius > max_screen or world scale >
  0.1·extent.
- Grad statistic: accumulated ‖∂L/∂(screen center)‖ per visible splat ÷ count
  (:649-651, add_densification_stats).

New splats land in free slots in slot order; candidates past the last free
slot are dropped and counted, so the trainer can grow capacity. The split
noise is an argument (or drawn from a `torch.Generator`), so tests can hand
both packages the same draws. Scatters whose target may be "dropped" write
into one extra sink row that is then cut off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from g4splat_torch.core.transforms import quat_to_rotmat
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.utils.profiling import annotate


@dataclass(frozen=True)
class DensifyState:
    grad_accum: torch.Tensor   # (N,) Σ‖screen-grad‖ over visible iters
    denom: torch.Tensor        # (N,) visible-iteration count
    max_radii2d: torch.Tensor  # (N,) max screen radius seen

    @staticmethod
    def zero(capacity: int, device=None) -> "DensifyState":
        return DensifyState(*(torch.zeros(capacity, device=device) for _ in range(3)))


def accumulate_stats(state: DensifyState, center_offset_grad: torch.Tensor,
                     radii: torch.Tensor, visible: torch.Tensor) -> DensifyState:
    g = torch.linalg.norm(center_offset_grad, dim=-1)
    vis = visible.to(g.dtype)
    return DensifyState(
        grad_accum=state.grad_accum + g * vis,
        denom=state.denom + vis,
        max_radii2d=torch.maximum(state.max_radii2d, radii * vis),
    )


class DensifyReport(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor   # candidates lost to capacity exhaustion


def _scatter(dst: torch.Tensor, target: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst with dst[target] = src, where target == len(dst) drops the row."""
    out = torch.cat([dst, dst[:1]])
    out[target] = src.to(dst.dtype)
    return out[:-1]


def densify_and_prune(
    scene: GaussianScene,
    state: DensifyState,
    scene_extent: float,
    grad_threshold: float = 2e-4,
    min_opacity: float = 0.05,
    max_screen_size: float = 0.0,   # 0 disables the screen-size prune
    percent_dense: float = 0.01,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianScene, DensifyState, torch.Tensor, DensifyReport]:
    """Returns (scene, fresh stats, changed_slots mask, report). `noise` is the
    (N, 2, 2) standard-normal split noise (child, tangent axis); without it
    the noise is drawn from `generator`."""
    N = scene.capacity
    dev = scene.device
    alive = scene.alive
    grads = torch.nan_to_num(state.grad_accum / torch.clamp(state.denom, min=1.0))

    # The mip filter is left out of densification decisions
    # (gaussian_model.py:628-630: flag temporarily disabled).
    scaling = torch.exp(scene.scaling_raw)
    max_scale = scaling.amax(dim=-1)
    base_opacity = torch.sigmoid(scene.opacity_raw[:, 0])

    hot = alive & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * scene_extent)
    split_mask = hot & (max_scale > percent_dense * scene_extent)

    prune_mask = alive & (base_opacity < min_opacity)
    # Non-finite splats are inert in the renderer (preprocess culls them) but
    # `NaN < eps` is False, so the reference rule alone never reclaims their
    # slots — prune them explicitly.
    finite = (torch.isfinite(scene.xyz).all(dim=-1)
              & torch.isfinite(scene.scaling_raw).all(dim=-1)
              & torch.isfinite(scene.opacity_raw[:, 0]))
    prune_mask = prune_mask | (alive & ~finite)
    if max_screen_size:
        prune_mask = prune_mask | (alive & (state.max_radii2d > max_screen_size))
        prune_mask = prune_mask | (alive & (max_scale > 0.1 * scene_extent))

    alive_after = alive & ~prune_mask & ~split_mask

    # ---- Candidate emission: slot i emits [clone_i, childA_i, childB_i]. ----
    # Split children: xyz = parent + R @ (ε ⊙ [s0, s1, 0]), scales /= 1.6.
    if noise is None:
        noise = torch.randn((N, 2, 2), generator=generator, device=dev)
    eps = noise.to(device=dev, dtype=torch.float32)
    tangent = quat_to_rotmat(scene.rotation_raw)[:, :, :2]             # (N, 3, 2)
    offsets = torch.einsum("nij,ncj->nci", tangent, eps * scaling[:, None, :])
    child_xyz = scene.xyz[:, None, :] + offsets                        # (N, 2, 3)
    child_scaling_raw = scene.scaling_raw - float(np.log(1.6))         # ÷ 0.8·N, N=2

    cand_valid = torch.stack([clone_mask, split_mask, split_mask], dim=1)   # (N, 3)
    cand_xyz = torch.stack([scene.xyz, child_xyz[:, 0], child_xyz[:, 1]], dim=1)
    cand_scaling = torch.stack(
        [scene.scaling_raw, child_scaling_raw, child_scaling_raw], dim=1)

    flat_valid = cand_valid.reshape(-1).long()                         # (3N,)
    # Rank among valid candidates → target free slot.
    rank = torch.cumsum(flat_valid, 0) - flat_valid                    # exclusive
    free = (~alive_after).long()
    free_rank = torch.cumsum(free, 0) - free                           # rank of each free slot
    n_free = free.sum()
    # free_slot_of_rank[r] = index of the r-th free slot.
    slots = torch.arange(N, device=dev)
    free_slot_of_rank = _scatter(torch.zeros(N, dtype=torch.long, device=dev),
                                 torch.where(free.bool(), free_rank, N), slots)
    take = flat_valid.bool() & (rank < n_free)
    target = torch.where(take, free_slot_of_rank[torch.clamp(rank, 0, N - 1)], N)

    def scatter(dst, src_vals):
        return _scatter(dst, target, src_vals)

    def rep3(x):
        return torch.repeat_interleave(x, 3, dim=0)

    new_scene = scene.replace(
        xyz=scatter(scene.xyz, cand_xyz.reshape(3 * N, 3)),
        f_dc=scatter(scene.f_dc, rep3(scene.f_dc)),
        f_rest=scatter(scene.f_rest, rep3(scene.f_rest)),
        opacity_raw=scatter(scene.opacity_raw, rep3(scene.opacity_raw)),
        scaling_raw=scatter(scene.scaling_raw, cand_scaling.reshape(3 * N, 2)),
        rotation_raw=scatter(scene.rotation_raw, rep3(scene.rotation_raw)),
        mip_filter=scatter(scene.mip_filter, rep3(scene.mip_filter)),
        alive=_scatter(alive_after, target, torch.ones(3 * N, dtype=torch.bool,
                                                       device=dev)),
    )

    changed = ((~alive_after) & new_scene.alive) | prune_mask | split_mask
    report = DensifyReport(
        n_cloned=clone_mask.sum(),
        n_split=split_mask.sum(),
        n_pruned=prune_mask.sum(),
        n_dropped=(flat_valid.bool() & ~take).sum(),
    )
    return new_scene, DensifyState.zero(N, device=dev), changed, report


def compact_and_grow(scene: GaussianScene, new_capacity: int) -> GaussianScene:
    """Pack alive splats to the front of a larger buffer (host-side in the
    JAX package; here a gather on the scene's device)."""
    with annotate("g4s:sync.compact"):
        idx = torch.nonzero(scene.alive).squeeze(1)
    n = idx.numel()
    if new_capacity < n:
        raise ValueError(f"new capacity {new_capacity} < {n} alive splats")
    out = GaussianScene.empty(new_capacity, scene.max_sh_degree, device=scene.device)

    def put(dst, src):
        dst = dst.clone()
        dst[:n] = src[idx]
        return dst

    alive = out.alive.clone()
    alive[:n] = True
    return out.replace(
        xyz=put(out.xyz, scene.xyz),
        f_dc=put(out.f_dc, scene.f_dc),
        f_rest=put(out.f_rest, scene.f_rest),
        opacity_raw=put(out.opacity_raw, scene.opacity_raw),
        scaling_raw=put(out.scaling_raw, scene.scaling_raw),
        rotation_raw=put(out.rotation_raw, scene.rotation_raw),
        mip_filter=put(out.mip_filter, scene.mip_filter),
        alive=alive,
        max_sh_degree=scene.max_sh_degree,
        active_sh_degree=scene.active_sh_degree,
        use_mip_filter=scene.use_mip_filter,
    )
