"""2DGS trainer, single-device path (counterpart of `g4splat_tpu.train.trainer`).

The reference training loop (2d-gaussian-splatting/train_with_refine_depth.py:
71-663): per iteration render one camera, assemble the photometric +
2DGS-regularization + chart-prior losses, take an Adam step with per-group
learning rates and the exponential xyz schedule, accumulate screen-space
gradient statistics, and periodically densify/prune, reset opacity, bump the
SH degree and recompute the mip filter.

`train_step` runs render → 8 losses → backward (through the cuda backend's
B1/B2 Function by default) → Adam → stat accumulation. The scene's six
parameter tensors are the optimizer's leaves; densify, opacity reset and
capacity growth write into them (or replace them, carrying the Adam moments
slot for slot). The JAX package's entry-buffer auto-tune is not part of this
path: the port's entry list is sized exactly, so `n_overflow` is always 0 and
the `raster_buf_*` fields are accepted and ignored.

`Trainer(mesh=…)` takes a `parallel.mesh.DeviceMesh` (a mesh of one entry is
no mesh):
- `model` > 1: slab mode (`parallel.gaussian_shard`), one view per step with
  the splat buffer in depth slabs over `model`, the single-device step's
  result up to the median's rounding;
- otherwise data-parallel (`make_dp_train_step`), `n_data` views per step,
  one per `data` entry, gradients averaged. Opt-in only: the JAX package
  measured it 11 dB below single-device training at equal view visits.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from g4splat_torch.core.cameras import Camera, camera_at
from g4splat_torch.device import fp32_math
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig
from g4splat_torch.train import losses as L
from g4splat_torch.train.densify import (
    DensifyState,
    accumulate_stats,
    compact_and_grow,
    densify_and_prune,
)
from g4splat_torch.utils.profiling import annotate, annotated

PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw")


@dataclass(frozen=True)
class TrainConfig:
    # Schedule (configs/free_gaussians_refinement/default.yaml + arguments/__init__.py:73-95)
    iterations: int = 7000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    # The reference never passes lr_delay_steps, so its warm-start delay is
    # inert by default (utils/general_utils.py:49-55); >0 enables it.
    position_lr_delay_steps: int = 0
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    # Losses
    lambda_dssim: float = 0.2
    lambda_normal: float = 0.05
    lambda_dist: float = 0.0
    normal_consistency_from: int = 3500
    distortion_from: int = 1500
    lambda_anisotropy: float = 0.1
    anisotropy_max_ratio: float = 5.0
    use_chart_priors: bool = True
    use_depth_order: bool = True
    # "per_pixel" = the reference's independent shifts; "global" = a few
    # image-wide shifts (losses.depth_order_loss).
    depth_order_sample: str = "per_pixel"
    initial_regularization_factor: float = 0.5
    confidence_weighting: float = 0.5
    depth_ratio: float = 0.5
    # Densification
    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 1000
    densify_from_iter: int = 500
    densify_until_iter: int = 3500
    densify_grad_threshold: float = 2e-4
    max_screen_size: float = 20.0
    min_opacity: float = 0.05
    use_mip_filter: bool = True
    # Misc
    spatial_lr_scale: float = 1.0
    backend: str = "cuda"
    # Accepted for config compatibility with the JAX package and ignored: the
    # port bins on exact depth into an exactly sized entry list.
    depth_rank_binning: bool = False
    raster_buf_factor: int = 4
    raster_buf_size: int = 0
    raster_buf_auto: bool = True
    raster_compact_width: int = 8
    raster_max_tiles_per_splat: int = 16
    sh_increase_interval: int = 1000
    # Capacity-growth ceiling when densification overflows the static buffer
    # (reference hard cap: train_with_refine_depth.py:147, 10M splats).
    max_capacity: int = 10_000_000

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


class ViewData(NamedTuple):
    """Per-view supervision (stacked over views for the whole dataset)."""
    image: torch.Tensor            # (V, H, W, 3)
    prior_depth: torch.Tensor      # (V, H, W)
    prior_normal: torch.Tensor     # (V, H, W, 3) world
    prior_curv: torch.Tensor       # (V, H, W)
    confidence: torch.Tensor       # (V, H, W)
    color_weight: torch.Tensor     # (V,) 1.0 input views, 0.01 generated views
    scale_factor: torch.Tensor     # () charts scale factor


def xyz_lr_schedule(cfg: TrainConfig):
    """Plenoxels log-linear decay with delayed warm start
    (utils/general_utils.py:30-66): when delay_steps > 0 the lr ramps from
    delay_mult·lr to lr over a half-sine; log-lerp init→final after."""
    init = cfg.position_lr_init * cfg.spatial_lr_scale
    final = cfg.position_lr_final * cfg.spatial_lr_scale

    def sched(step: int) -> float:
        t = min(max(step / cfg.position_lr_max_steps, 0.0), 1.0)
        lr = math.exp(math.log(init) * (1 - t) + math.log(final) * t)
        if cfg.position_lr_delay_steps > 0:
            u = min(max(step / cfg.position_lr_delay_steps, 0.0), 1.0)
            lr *= cfg.position_lr_delay_mult + (
                1 - cfg.position_lr_delay_mult) * math.sin(0.5 * math.pi * u)
        return lr

    return sched


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor]) -> torch.optim.Adam:
    """Adam with one param group per field (eps 1e-15; f_rest at feature_lr/20).
    The xyz group's lr is set before each step from `xyz_lr_schedule` at the
    number of updates taken so far (optax's scale_by_schedule count)."""
    lrs = {"xyz": xyz_lr_schedule(cfg)(0), "f_dc": cfg.feature_lr,
           "f_rest": cfg.feature_lr / 20.0, "opacity_raw": cfg.opacity_lr,
           "scaling_raw": cfg.scaling_lr, "rotation_raw": cfg.rotation_lr}
    groups = [{"params": [params[k]], "lr": lrs[k], "name": k, "updates": 0}
              for k in PARAM_FIELDS]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)


def scene_params(scene: GaussianScene) -> Dict[str, torch.Tensor]:
    return {k: getattr(scene, k) for k in PARAM_FIELDS}


def with_params(scene: GaussianScene, params: Dict[str, torch.Tensor]) -> GaussianScene:
    return scene.replace(**params)


def compute_losses(
    scene: GaussianScene,
    camera: Camera,
    view: Dict[str, torch.Tensor],
    cfg: TrainConfig,
    iteration: int,
    center_offset: torch.Tensor,
    shifts: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    out = render(
        camera,
        scene,
        # λ_dist = 0 is the reference's production default
        # (arguments/__init__.py:86): the kernels then skip the distortion
        # moments — rend_dist comes back as zeros and dist_loss is 0 either way.
        config=RenderConfig(bg=(0.0, 0.0, 0.0), depth_ratio=cfg.depth_ratio,
                            compute_distortion=cfg.lambda_dist != 0.0,
                            max_tiles_per_splat=cfg.raster_max_tiles_per_splat),
        center_offset=center_offset,
        backend=cfg.backend,
    )
    with annotate("g4s:train.losses"):
        return losses_from_render(scene, out, view, cfg, iteration, shifts, generator)


def losses_from_render(
    scene: GaussianScene,
    out: Dict[str, torch.Tensor],
    view: Dict[str, torch.Tensor],
    cfg: TrainConfig,
    iteration: int,
    shifts: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Loss assembly given a render() output dict. `shifts` (or `generator`)
    feeds the depth-order term's random pairing."""
    img = out["render"]
    gt = view["image"]

    color = L.dssim_color_loss(img, gt, cfg.lambda_dssim) * view["color_weight"]
    lam_n = cfg.lambda_normal if iteration > cfg.normal_consistency_from else 0.0
    lam_d = cfg.lambda_dist if iteration > cfg.distortion_from else 0.0
    normal_loss = lam_n * L.normal_consistency_loss(out["rend_normal"], out["surf_normal"])
    dist_loss = lam_d * L.distortion_loss(out["rend_dist"])

    total = color + normal_loss + dist_loss
    aux = {
        "l1": L.l1_loss(img, gt),
        "psnr": L.psnr(img, gt),
        "color": color,
        "normal": normal_loss,
        "dist": dist_loss,
        "radii": out["radii"],
        "visibility": out["visibility_filter"],
        "n_dropped": out["n_dropped"],
        "n_overflow": out["n_overflow"],
    }

    if cfg.use_chart_priors:
        rf = L.schedule_regularization_factor(iteration, cfg.initial_regularization_factor)
        surf_depth = out["surf_depth"]
        dp = rf * 0.75 * L.depth_prior_loss(surf_depth, view["prior_depth"],
                                             view["scale_factor"], cfg.confidence_weighting)
        dd = rf * 0.5 * L.depth_derivative_prior_loss(out["surf_normal"], view["prior_normal"])
        npl = rf * 0.5 * L.normal_prior_loss(out["rend_normal"], view["prior_normal"])
        cp = rf * 0.25 * L.curvature_prior_loss(out["rend_normal"], view["prior_curv"])
        prior_total = dp + dd + npl + cp
        if cfg.use_depth_order:
            lam_do = L.schedule_depth_order_lambda(iteration)
            prior_total = prior_total + lam_do * L.depth_order_loss(
                surf_depth, view["prior_depth"], shifts=shifts, generator=generator,
                scene_extent=cfg.spatial_lr_scale, sample=cfg.depth_order_sample)
        total = total + prior_total
        aux["priors"] = prior_total

    if cfg.lambda_anisotropy > 0:
        total = total + cfg.lambda_anisotropy * L.anisotropy_loss(
            scene.scaling(), scene.alive.to(torch.float32), cfg.anisotropy_max_ratio)
    return total, aux


def pad_capacity(scene: GaussianScene, multiple: int) -> GaussianScene:
    """`scene` with dead slots appended until its capacity divides by
    `multiple` (slab mode cuts the buffer into equal slabs)."""
    pad = (-scene.capacity) % multiple
    if not pad:
        return scene
    empty = GaussianScene.empty(pad, scene.max_sh_degree, device=scene.device)
    return scene.replace(**{k: torch.cat([getattr(scene, k), getattr(empty, k)])
                            for k in PARAM_FIELDS + ("alive", "mip_filter")})


@fp32_math()
def train_step(
    scene: GaussianScene,
    optimizer: torch.optim.Adam,
    dstate: DensifyState,
    camera: Camera,
    view: Dict[str, torch.Tensor],
    iteration: int,
    cfg: TrainConfig,
    shifts: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[DensifyState, Dict[str, torch.Tensor]]:
    """One step on `scene`, whose parameter fields are `optimizer`'s leaves:
    they are updated in place and keep this step's `.grad`. Returns the
    densify statistics (accumulated inside the densify window) and the
    step's metrics as 0-d tensors. Runs in fp32, TF32 off (the SSIM
    convolutions)."""
    offset = torch.zeros((scene.capacity, 2), device=scene.device, requires_grad=True)
    loss, aux = compute_losses(scene, camera, view, cfg, iteration, offset, shifts,
                               generator)
    with annotate("g4s:train.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with annotate("g4s:train.adam"):
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


def make_dp_train_step(mesh):
    """The data-parallel step over the mesh's `data` axis: ``step(scene,
    optimizer, dstate, cameras, views, view_ids, iteration, cfg, shifts=None,
    generator=None) -> (dstate, metrics)``.

    The views `view_ids` split over `data` in order (B = len / n_data per
    entry). Each entry renders its views on its device from its copy of the
    scene (one per distinct device, moved differentiably) and takes the mean
    of their losses; the step's loss is the mean over entries on the home
    device, so its gradient is the entries' gradients averaged. Each view's
    depth-order shifts are drawn in global view order from `generator`
    before the fan-out, so the result does not depend on the mesh size. The
    densify statistics are those of the views processed one by one: the
    screen-space gradient scaled back by the number of views and summed,
    `denom` summed, the radii's max. dstate may be None outside the densify
    window."""
    from g4splat_torch.parallel.mesh import fan_out

    n = mesh.shape["data"]
    devs = mesh.data_devices
    fields = ("image", "prior_depth", "prior_normal", "prior_curv", "confidence",
              "color_weight")

    @fp32_math()
    def step(scene, optimizer, dstate, cameras, views, view_ids, iteration, cfg,
             shifts=None, generator=None):
        V = len(view_ids)
        if V % n:
            raise ValueError(f"views ({V}) must divide over the data axis ({n})")
        B = V // n
        N = scene.capacity
        home = scene.device
        if shifts is None and cfg.use_chart_priors and cfg.use_depth_order:
            H, W = views.image.shape[1:3]
            shifts = [L.draw_depth_order_shifts((H, W), generator, cfg.depth_order_sample,
                                                device=home) for _ in range(V)]
        scenes = {dev: scene.to(dev) for dev in dict.fromkeys(devs)}
        offsets = [torch.zeros((N, 2), device=devs[g // B], requires_grad=True)
                   for g in range(V)]

        def entry(d):
            """Entry d's sums over its views (loss, visibility, l1, psnr,
            drops) and its radii's max, moved to the home device."""
            dev, sums, radii = devs[d], None, None
            for g in range(d * B, (d + 1) * B):
                v = view_ids[g]
                view = {k: getattr(views, k)[v].to(dev) for k in fields}
                view["scale_factor"] = views.scale_factor.to(dev)
                loss, aux = compute_losses(scenes[dev], camera_at(cameras, v).to(dev), view,
                                           cfg, iteration, offsets[g],
                                           None if shifts is None else shifts[g])
                vis = aux["visibility"].to(torch.float32)
                now = {"loss": loss, "vis": vis, "l1": aux["l1"], "psnr": aux["psnr"],
                       "n_dropped": aux["n_dropped"]}
                sums = now if sums is None else {k: sums[k] + now[k] for k in now}
                r = aux["radii"] * vis
                radii = r if radii is None else torch.maximum(radii, r)
            return {k: x.to(home) for k, x in sums.items()}, radii.to(home)

        parts = fan_out(devs, entry)

        def mean(k):                        # per entry over B views, then over entries
            return torch.stack([p[k] / B for p, _ in parts]).mean()

        loss = mean("loss")
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        adam_step(optimizer, cfg)
        if cfg.densify_from_iter <= iteration < cfg.densify_until_iter:
            d_grad = sum(torch.linalg.norm(o.grad, dim=-1).to(home) for o in offsets) * V
            dstate = DensifyState(
                grad_accum=dstate.grad_accum + d_grad,
                denom=dstate.denom + sum(p["vis"] for p, _ in parts),
                max_radii2d=torch.maximum(dstate.max_radii2d,
                                          torch.stack([r for _, r in parts]).amax(0)))
        metrics = {
            "loss": loss.detach(),
            "l1": mean("l1").detach(),
            "psnr": mean("psnr").detach(),
            "n_alive": scene.num_alive,
            "n_dropped": sum(p["n_dropped"] for p, _ in parts),
            "n_overflow": torch.zeros((), dtype=torch.int32, device=home),
        }
        return dstate, metrics

    return step


def adam_step(optimizer: torch.optim.Adam, cfg: TrainConfig):
    """Set the xyz lr from the schedule at the update count, then step."""
    for group in optimizer.param_groups:
        if group["name"] == "xyz":
            group["lr"] = xyz_lr_schedule(cfg)(group["updates"])
        group["updates"] += 1
    optimizer.step()


@torch.no_grad()
def zero_moments_at(optimizer: torch.optim.Adam, changed: torch.Tensor,
                    groups: Optional[Tuple[str, ...]] = None):
    """Zero Adam moments on changed slots, of every param group or of the
    named `groups` only (the reference resets optimizer state for replaced
    tensors, gaussian_model.py:500-560, and so for the opacity at its reset,
    :436-439)."""
    for group in optimizer.param_groups:
        if groups is not None and group["name"] not in groups:
            continue
        state = optimizer.state.get(group["params"][0], {})
        for key in ("exp_avg", "exp_avg_sq"):
            x = state.get(key)
            if x is not None and x.shape[0] == changed.shape[0]:
                x[changed] = 0.0


class Trainer:
    """Host-side loop around `train_step` and the maintenance ops."""

    def __init__(self, scene: GaussianScene, cameras: Camera, views: ViewData,
                 cfg: TrainConfig, seed: int = 0, mesh=None):
        self.cfg = cfg
        self.cameras = cameras
        self.views = views
        # Mesh modes (module docstring); the scene, the views and the
        # optimizer live on the mesh's home device.
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.slab_mode = self.mesh is not None and self.mesh.shape["model"] > 1
        self.views_per_step = 1
        if self.mesh is not None:
            if scene.device != self.mesh.home:
                raise ValueError(f"the scene lies on {scene.device}, the mesh's home "
                                 f"device is {self.mesh.home}")
        if self.slab_mode:
            from g4splat_torch.parallel.gaussian_shard import make_slab_sharded_train_step

            scene = pad_capacity(scene, self.mesh.shape["model"])
            self._slab_step = make_slab_sharded_train_step(self.mesh)
        elif self.mesh is not None:
            n_data, n_views = self.mesh.shape["data"], views.image.shape[0]
            if n_views % n_data:
                raise ValueError(f"views ({n_views}) must divide over the data axis "
                                 f"({n_data}) for data-parallel training")
            self.views_per_step = n_data
            self._dp_step = make_dp_train_step(self.mesh)
        self.params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
                       for k in PARAM_FIELDS}
        self.scene = with_params(scene, self.params)
        self.optimizer = make_optimizer(cfg, self.params)
        self.dstate = DensifyState.zero(scene.capacity, device=scene.device)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=scene.device).manual_seed(seed)
        self.scene_extent = cfg.spatial_lr_scale
        self.iteration = 0
        self._stack: list = []
        if self.slab_mode:
            self._refresh_partitions()
        if cfg.use_mip_filter:
            self.scene = self._mip(self.scene.replace(use_mip_filter=True))

    @torch.no_grad()
    def _refresh_partitions(self):
        """Per-view depth orders of the splats for slab mode, and their
        inverses: at init and after any op that moves or re-populates splats
        (densify, capacity growth, a restored checkpoint)."""
        from g4splat_torch.parallel.gaussian_shard import view_depth_permutations

        self._perms = view_depth_permutations(self.scene, self.cameras)
        self._invs = torch.argsort(self._perms, dim=1)

    @torch.no_grad()
    def _mip(self, scene: GaussianScene) -> GaussianScene:
        return scene.compute_mip_filter(self.cameras)

    @torch.no_grad()
    def _set_scene(self, scene: GaussianScene):
        """Write `scene`'s parameters into the optimizer's leaves."""
        for k, p in self.params.items():
            p.copy_(getattr(scene, k))
        self.scene = with_params(scene, self.params)

    def _next_view(self) -> int:
        if not self._stack:
            self._stack = list(self.rng.permutation(self.views.image.shape[0]))
        return int(self._stack.pop())

    def _dp_batch(self) -> list:
        """The next `views_per_step` views, one per `data` entry."""
        return [self._next_view() for _ in range(self.views_per_step)]

    def _view_slice(self, v: int):
        view = {k: getattr(self.views, k)[v]
                for k in ("image", "prior_depth", "prior_normal", "prior_curv",
                          "confidence", "color_weight")}
        view["scale_factor"] = self.views.scale_factor
        return camera_at(self.cameras, v), view

    @torch.no_grad()
    def _grow_capacity(self, new_capacity: int):
        """Overflow path: recompact alive splats into a larger buffer and
        carry the Adam moments over slot for slot (the static-capacity answer
        to the reference's tensor reallocation, gaussian_model.py:500-560)."""
        old = self.scene
        if self.slab_mode:
            new_capacity += (-new_capacity) % self.mesh.shape["model"]
        with annotate("g4s:sync.grow"):
            alive_idx = torch.nonzero(old.alive).squeeze(1)
        n = alive_idx.numel()
        print(f"[trainer] densify overflow: growing capacity {old.capacity} -> "
              f"{new_capacity} ({n} alive)", flush=True)
        grown = compact_and_grow(old.replace(**{k: p.detach() for k, p in
                                                self.params.items()}), new_capacity)
        old_opt = self.optimizer
        self.params = {k: getattr(grown, k).clone().requires_grad_(True)
                       for k in PARAM_FIELDS}
        self.scene = with_params(grown, self.params)
        self.optimizer = make_optimizer(self.cfg, self.params)
        for og, ng in zip(old_opt.param_groups, self.optimizer.param_groups):
            ng["updates"] = og["updates"]
            state = old_opt.state.get(og["params"][0])
            if not state:
                continue
            carried = {"step": state["step"].clone()}
            for key in ("exp_avg", "exp_avg_sq"):
                x = state[key]
                out = x.new_zeros((new_capacity,) + x.shape[1:])
                out[:n] = x[alive_idx]
                carried[key] = out
            self.optimizer.state[ng["params"][0]] = carried
        self.dstate = DensifyState.zero(new_capacity, device=grown.device)
        # The steps hold nothing capacity-shaped but slab mode's orders.
        if self.slab_mode:
            self._refresh_partitions()
        if self.cfg.use_mip_filter:
            self.scene = self._mip(self.scene)

    @annotated("g4s:train.step")
    def step(self, sync_metrics: bool = True) -> Dict[str, Any]:
        self.iteration += 1
        it = self.iteration
        cfg = self.cfg

        if it % cfg.sh_increase_interval == 0:
            self.scene = self.scene.one_up_sh_degree()

        if self.slab_mode:
            v = self._next_view()
            cam, view = self._view_slice(v)
            self.dstate, metrics = self._slab_step(
                self.scene, self.optimizer, self.dstate, cam, view, it, cfg, self._perms[v],
                self._invs[v], generator=self.generator)
        elif self.mesh is not None:
            self.dstate, metrics = self._dp_step(
                self.scene, self.optimizer, self.dstate, self.cameras, self.views,
                self._dp_batch(), it, cfg, generator=self.generator)
        else:
            cam, view = self._view_slice(self._next_view())
            self.dstate, metrics = train_step(self.scene, self.optimizer, self.dstate, cam,
                                              view, it, cfg, generator=self.generator)

        if cfg.densify_from_iter <= it < cfg.densify_until_iter:
            if it % cfg.densification_interval == 0:
                self.densify(it)
            if it % cfg.opacity_reset_interval == 0:
                with torch.no_grad():
                    self._set_scene(self.scene.reset_opacity())
                    every = torch.ones(self.scene.capacity, dtype=torch.bool,
                                       device=self.scene.device)
                    zero_moments_at(self.optimizer, every, groups=("opacity_raw",))

        if sync_metrics:
            with annotate("g4s:sync.metrics"):
                return {k: float(v) for k, v in metrics.items()}
        return metrics

    @annotated("g4s:train.densify")
    def densify(self, it: int):
        """Densify/prune at iteration `it`; grow the buffer when candidates
        were dropped, else refresh the mip filter."""
        cfg = self.cfg
        max_screen = cfg.max_screen_size if it > cfg.opacity_reset_interval else 0.0
        with torch.no_grad():
            scene, self.dstate, changed, report = densify_and_prune(
                self.scene, self.dstate, self.scene_extent, cfg.densify_grad_threshold,
                cfg.min_opacity, max_screen, cfg.percent_dense, generator=self.generator)
            self._set_scene(scene)
            zero_moments_at(self.optimizer, changed)
        if self.slab_mode:
            self._refresh_partitions()
        # Overflow → grow the static buffer (capacity doubles, bounded by
        # cfg.max_capacity; one host sync per densify interval).
        with annotate("g4s:sync.densify"):
            dropped = int(report.n_dropped) > 0
        if dropped and self.scene.capacity < cfg.max_capacity:
            self._grow_capacity(min(cfg.max_capacity,
                                    max(2 * self.scene.capacity, self.scene.capacity + 4096)))
        elif cfg.use_mip_filter:
            self.scene = self._mip(self.scene)
        return report

    def train(self, num_iters: Optional[int] = None, log_every: int = 0):
        """Run the loop; metrics are synced to the host only at log points."""
        num_iters = num_iters or self.cfg.iterations
        history = []
        for _ in range(num_iters):
            sync = bool(log_every) and (self.iteration + 1) % log_every == 0
            m = self.step(sync_metrics=sync)
            if sync:
                history.append({"iter": self.iteration, **m})
        return history
