"""Splat-buffer sharding: depth slabs composed exactly (counterpart of
`g4splat_tpu.parallel.gaussian_shard`).

Each `model` entry holds a depth slab of the scene (an equal-count quantile
partition along the view ray), composites it with the ordinary renderer
(kernel B1 on the card), and the slabs combine with per-pixel algebra:

- every accumulated map is a Σ w_i·x_i form, and a slab's global weights are
  its local ones scaled by the product of the nearer slabs' final
  transmittances P_d = Π_{e<d} T_e: colour, normal, depth and moment maps
  compose as Σ_d P_d·X_d, alpha as 1 − Π_d T_d;
- the 2DGS distortion is the pairwise form Σ_{i<j} w_i w_j (m_i − m_j)², so it
  splits into within-slab terms P_d²·dist_d and cross-slab terms
  P_d P_e (W_d M2_e + W_e M2_d − 2 M1_d M1_e) built from each slab's moment
  totals (render()'s `dist_m1` / `dist_m2`);
- the median depth (the last entry with incoming T > 0.5) comes from the slab
  where the global transmittance crosses 0.5. It is exact where that slab is
  entered with T ≈ 1 (always for slab 0); a deeper slab resolves the crossing
  against its local transmittance, the one inexact channel.

The partition is by per-splat view depth, so slabs occupy disjoint depth
intervals along every ray and front-to-back slab order is globally right.
Slab renders take bg = 0; `compose_slabs` adds the caller's bg last.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from g4splat_torch.core.geometry import depth_to_normal
from g4splat_torch.device import fp32_math
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig
from g4splat_torch.parallel.mesh import DeviceMesh, fan_out

SCENE_ROWS = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw",
              "alive", "mip_filter")


def partition_by_view_depth(scene: GaussianScene, camera, n_slabs: int
                            ) -> List[GaussianScene]:
    """Equal-count quantile partition of the alive splats by view depth, on
    the host. Every slab has the same capacity, ⌈alive/n⌉ rounded up to a
    multiple of 8, its tail dead slots."""
    alive = scene.alive.cpu().numpy()
    idx = np.flatnonzero(alive)
    xyz = scene.xyz.detach().cpu().numpy()[idx]
    w2c = camera.w2c.detach().cpu().numpy()
    z = xyz @ w2c[2, :3] + w2c[2, 3]
    order = idx[np.argsort(z)]
    cap = max(8, int(-(-len(order) // n_slabs) + 7) // 8 * 8)
    slabs = []
    for d in range(n_slabs):
        sel = torch.as_tensor(order[d * len(order) // n_slabs:
                                    (d + 1) * len(order) // n_slabs],
                              device=scene.device)
        slab = GaussianScene.empty(cap, scene.max_sh_degree, device=scene.device)
        n = len(sel)
        rows = {}
        for k in SCENE_ROWS:
            dst = getattr(slab, k).clone()
            dst[:n] = getattr(scene, k).detach()[sel]
            rows[k] = dst
        rows["alive"][:n] = True
        slabs.append(slab.replace(**rows, active_sh_degree=scene.active_sh_degree,
                                  use_mip_filter=scene.use_mip_filter))
    return slabs


def slab_maps_from_render(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(H, W, 13) compose inputs from a render() dict (rendered with bg 0):
    rgb, normal, depth·alpha, alpha, distortion, median, final_T, M1, M2."""
    depth_acc = out["rend_depth"] * out["rend_alpha"]
    return torch.stack([
        out["render"][..., 0], out["render"][..., 1], out["render"][..., 2],
        out["rend_normal"][..., 0], out["rend_normal"][..., 1], out["rend_normal"][..., 2],
        depth_acc, out["rend_alpha"], out["rend_dist"], out["depth_median"],
        out["final_T"], out["dist_m1"], out["dist_m2"],
    ], dim=-1)


def compose_slabs(maps: torch.Tensor, bg) -> Dict[str, torch.Tensor]:
    """(n_slabs, H, W, 13) front-to-back slab maps → the composed maps."""
    n = maps.shape[0]
    T_d = maps[..., 10]
    P_d = torch.cat([torch.ones_like(T_d[:1]), torch.cumprod(T_d, dim=0)[:-1]])

    def lin(c):
        return torch.sum(P_d * maps[..., c], dim=0)

    color = torch.stack([lin(0), lin(1), lin(2)], dim=-1)
    normal = torch.stack([lin(3), lin(4), lin(5)], dim=-1)
    depth_acc = lin(6)
    T_fin = torch.prod(T_d, dim=0)
    alpha = 1.0 - T_fin

    # Distortion: within-slab terms scaled by P², cross-slab terms from the
    # moments, Σ_{d<e} Wg_d M2_e + Wg_e M2_d − 2 M1_d M1_e by prefix sums.
    W_d = maps[..., 7]
    M1_d = P_d * maps[..., 11]
    M2_d = P_d * maps[..., 12]
    Wg = P_d * W_d
    dist = torch.sum(P_d * P_d * maps[..., 8], dim=0)
    cumW = torch.cumsum(Wg, dim=0) - Wg
    cumM1 = torch.cumsum(M1_d, dim=0) - M1_d
    cumM2 = torch.cumsum(M2_d, dim=0) - M2_d
    # The cross-slab terms carry no gradient: B2 takes no cotangent for the
    # moment totals, and their W and P factors alone would give a large
    # spurious one (the expanded terms cancel only with the moments'
    # derivatives). ROADMAP C26.
    cross = torch.sum(cumW * M2_d + Wg * cumM2 - 2.0 * cumM1 * M1_d, dim=0)
    dist = dist + cross.detach()

    # Median: the slab whose span holds the global T = 0.5 crossing; where T
    # never crosses 0.5, the last contributor, i.e. the last slab with weight.
    T_after = torch.cumprod(T_d, dim=0)
    crossing = (P_d > 0.5) & (T_after <= 0.5)
    has_cross = crossing.any(dim=0)
    first = torch.argmax(crossing.to(torch.int8), dim=0)
    contrib = W_d > 0
    any_contrib = contrib.any(dim=0)
    last_c = (n - 1) - torch.argmax(contrib.flip(0).to(torch.int8), dim=0)
    pick = torch.where(has_cross, first, last_c)
    picked = torch.gather(maps[..., 9], 0, pick[None])[0]
    median = torch.where(has_cross | any_contrib, picked, torch.zeros_like(picked))

    depth_expected = torch.nan_to_num(depth_acc / torch.clamp(alpha, min=1e-10))
    bg = torch.as_tensor(bg, dtype=maps.dtype, device=maps.device)
    return {
        "render": color + T_fin[..., None] * bg[:3],
        "rend_alpha": alpha,
        "rend_normal": normal,
        "rend_depth": depth_expected,
        "rend_dist": dist,
        "depth_median": median,
        "final_T": T_fin,
    }


def view_depth_permutations(scene: GaussianScene, cameras) -> torch.Tensor:
    """(V, P) per-view depth orders for slab-sharded training: perm[v] sorts
    the splat ids front to back in view v's camera frame, dead slots last
    (stable on ties), so equal slices of perm[v] are depth-disjoint slabs
    along every ray of view v."""
    xyz = scene.xyz.detach()
    w2c = cameras.w2c.to(xyz.device)
    z = xyz @ w2c[:, 2, :3].T + w2c[:, 2, 3]                # (P, V)
    key = torch.where(scene.alive[:, None], z, torch.full_like(z, float("inf")))
    return torch.argsort(key.T, dim=1, stable=True)


def outputs_from_slab_maps(camera, maps: torch.Tensor, depth_ratio: float
                           ) -> Dict[str, torch.Tensor]:
    """compose_slabs and render()'s tail: the output dict the losses read.
    The slab renders give world normals; the camera-space ones are derived,
    and surf_normal stops the gradient through alpha, as render() does."""
    out = compose_slabs(maps, torch.zeros(3))
    R_c2w = camera.c2w[:3, :3]
    normal_world = out["rend_normal"]
    depth_expected = out["rend_depth"]
    depth_median = torch.nan_to_num(out["depth_median"])
    surf_depth = depth_expected * (1.0 - depth_ratio) + depth_ratio * depth_median
    surf_normal = depth_to_normal(camera, surf_depth) * out["rend_alpha"].detach()[..., None]
    return {
        "render": out["render"],
        "rend_alpha": out["rend_alpha"],
        "rend_normal": normal_world,
        "rend_normal_cam": normal_world @ R_c2w,
        "rend_dist": out["rend_dist"],
        "rend_depth": torch.nan_to_num(depth_expected),
        "depth_median": depth_median,
        "surf_depth": surf_depth,
        "surf_normal": surf_normal,
        "surf_normal_cam": surf_normal @ R_c2w,
        "final_T": out["final_T"],
    }


def render_slabs(mesh: DeviceMesh, slab_of, camera, config: RenderConfig, backend: str,
                 center_offset_of=None):
    """Render slab d = slab_of(d) on `model` entry d; return the (n, H, W, 13)
    maps and the per-slab render() dicts, maps gathered on the home device."""
    devs = mesh.model_devices

    def entry(d):
        dev = devs[d]
        offset = None if center_offset_of is None else center_offset_of(d).to(dev)
        out = render(camera.to(dev), slab_of(d).to(dev), config=config,
                     center_offset=offset, backend=backend)
        return slab_maps_from_render(out), out

    parts = fan_out(devs, entry)
    maps = torch.stack([m.to(mesh.home) for m, _ in parts])
    return maps, [o for _, o in parts]


def make_slab_sharded_train_step(mesh: DeviceMesh):
    """The splat-sharded 2DGS training step over the mesh's `model` axis:
    ``step(scene, optimizer, dstate, camera, view, iteration, cfg, perm,
    inv_perm, shifts=None, generator=None) -> (dstate, metrics)``, with
    `train.trainer.train_step`'s contract.

    One view per step, as the reference trains: entry d renders slab d, the
    splats perm[d·P/n:(d+1)·P/n] of view `perm` (the parameters indexed on
    the home device and moved to entry d), the slabs compose on the home
    device, and the losses and Adam run there. The index and the move are
    differentiable, so each splat's gradient and screen-space offset gradient
    come back from its own slab. The capacity must divide by n_model (the
    trainer pads it). Metrics carry `n_dropped` summed over the slabs and
    `n_overflow` (always 0 here: the entry list is sized exactly)."""
    from g4splat_torch.train.densify import accumulate_stats
    from g4splat_torch.train.trainer import adam_step, losses_from_render

    n = mesh.shape["model"]

    @fp32_math()
    def step(scene, optimizer, dstate, camera, view, iteration, cfg, perm, inv_perm,
             shifts=None, generator=None):
        N = scene.capacity
        if N % n:
            raise ValueError(f"capacity {N} does not divide over the model axis ({n})")
        per = N // n
        rcfg = RenderConfig(bg=(0.0, 0.0, 0.0), depth_ratio=cfg.depth_ratio,
                            compute_distortion=cfg.lambda_dist != 0.0,
                            max_tiles_per_splat=cfg.raster_max_tiles_per_splat)
        offset = torch.zeros((N, 2), device=scene.device, requires_grad=True)
        ids = [perm[d * per:(d + 1) * per] for d in range(n)]

        def slab_of(d):
            return scene.replace(**{k: getattr(scene, k)[ids[d]] for k in SCENE_ROWS})

        maps, outs = render_slabs(mesh, slab_of, camera, rcfg, cfg.backend,
                                  center_offset_of=lambda d: offset[ids[d]])
        out = outputs_from_slab_maps(camera, maps, cfg.depth_ratio)
        radii = torch.cat([o["radii"].detach().to(mesh.home) for o in outs])[inv_perm]
        out["radii"] = radii
        out["visibility_filter"] = radii > 0
        out["n_dropped"] = sum(o["n_dropped"].to(mesh.home) for o in outs)
        out["n_overflow"] = sum(o["n_overflow"].to(mesh.home) for o in outs)
        loss, aux = losses_from_render(scene, out, view, cfg, iteration, shifts, generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        adam_step(optimizer, cfg)
        if cfg.densify_from_iter <= iteration < cfg.densify_until_iter:
            dstate = accumulate_stats(dstate, offset.grad, aux["radii"], aux["visibility"])
        metrics = {
            "loss": loss.detach(),
            "l1": aux["l1"].detach(),
            "psnr": aux["psnr"].detach(),
            "n_alive": scene.num_alive,
            "n_dropped": aux["n_dropped"],
            "n_overflow": aux["n_overflow"],
        }
        return dstate, metrics

    return step


def render_gaussian_sharded(mesh: DeviceMesh, slab_scenes: Sequence[GaussianScene], camera,
                            backend: str = "cuda", bg=None) -> Dict[str, torch.Tensor]:
    """Render a splat-sharded scene: slab d on `model` entry d (bg 0, the
    distortion moments on), one gather of the (H, W, 13) maps, and the
    composition with `bg` on the home device."""
    n = len(slab_scenes)
    if mesh.shape["model"] != n:
        raise ValueError(f"{n} slabs need a model axis of size {n}, "
                         f"mesh has {mesh.shape['model']}")
    maps, _ = render_slabs(mesh, lambda d: slab_scenes[d], camera,
                           RenderConfig(bg=(0.0, 0.0, 0.0)), backend)
    return compose_slabs(maps, torch.zeros(3) if bg is None else bg)
