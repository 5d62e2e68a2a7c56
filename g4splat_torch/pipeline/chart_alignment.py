"""Chart alignment: joint refinement of per-view depth maps (counterpart of
`g4splat_tpu.pipeline.chart_alignment`, the reference's matcha
ParallelAligner).

Each view ("chart") gets a learned deformation field: a multi-resolution 2D
code grid (4 resolutions × 8 channels) and a 1-D binned depth encoding feed
a small per-chart MLP (3×64) whose scalar output, scaled to a deformation
radius, moves each chart point along its camera ray. Adam minimises

- the confidence-weighted |deformed depth − SfM depth| with a learned
  per-pixel confidence c = 1 + exp(θ): c·|Δ| − 0.2·log c,
- normal consistency with the initial chart normals (weight 4),
- curvature consistency (weight 1),
- cross-chart 3D matching (weight 5): points matched across charts at init
  (depth agreement < extent/20) must keep agreeing.

The charts are one batch axis of tensors on the cameras' device (the card
by default); the code planes are upsampled with bilinear interpolation at
half-pixel centres, which is what the JAX package's `jax.image.resize`
computes when it enlarges, as two matmuls; depth maps are sampled through
`gather`, whose gradient is a `scatter_add`. The three parameter groups run an Adam of the
port's own (`sfm.Adam`) under piecewise-constant rates, as the JAX
package's `optax.multi_transform` does; the sampled losses stay on the
device until the loop ends. `init_params` draws from a `torch.Generator`:
the JAX package's `jax.random` stream is not reproduced, and parity tests
carry its params across (`convert.chart_params_from`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from g4splat_torch.core.cameras import Camera, camera_at
from g4splat_torch.core.geometry import bilinear_sample, depth_to_normal, pixel_index
from g4splat_torch.device import fp32_math
from g4splat_torch.pipeline.sfm import Adam, piecewise_constant
from g4splat_torch.train.losses import normal_to_curvature


@dataclass(frozen=True)
class ChartAlignConfig:
    # Architecture (parallel_aligner.py defaults)
    encoding_dim_per_res: int = 8
    resolutions: tuple = (0.05, 0.1, 0.2, 0.4)
    init_range: float = 1e-4
    depth_bins: int = 30
    mlp_layers: int = 3
    mlp_width: int = 64
    deformation_radius_factor: float = 1.0
    confidence_weighting: float = 0.2
    # Optimisation (charts_alignment.py defaults)
    n_iterations: int = 1000
    normal_loss_weight: float = 4.0
    curvature_loss_weight: float = 1.0
    matching_loss_weight: float = 5.0
    use_matching_loss: bool = True
    matching_thr_factor: float = 1.0 / 20.0
    encodings_lr: float = 1e-2
    mlp_lr: float = 1e-3
    confidence_lr: float = 1e-3
    lr_update_iters: tuple = (1000,)
    lr_update_factor: float = 0.1
    # The "strong" regularisations (configs/charts_alignment/strong.yaml)
    regularize_chart_encodings_norms: bool = False
    chart_encodings_norm_loss_weight: float = 2.0
    use_total_variation_on_depth_encodings: bool = False
    total_variation_on_depth_encodings_weight: float = 5.0
    weight_encodings_with_confidence: bool = False


# The most pixel splits of the per-chart products (forward_deformation).
_SPLIT = 64


def grid_sample_bilinear(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (h, w, C) at uv ∈ [-1, 1]² (align_corners=False, border pad);
    uv[..., 0] is x (the width axis)."""
    h, w = grid.shape[0], grid.shape[1]
    x = torch.clamp(((uv[..., 0] + 1.0) * w - 1.0) / 2.0, 0.0, w - 1.0)
    y = torch.clamp(((uv[..., 1] + 1.0) * h - 1.0) / 2.0, 0.0, h - 1.0)
    return bilinear_sample(grid, torch.stack([x, y], -1))


def init_params(n_charts: int, H: int, W: int, cfg: ChartAlignConfig,
                generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """The deformation fields' parameters, drawn as the JAX package draws
    them (uniform codes in ±init_range, kaiming-uniform per-chart MLP,
    zero confidence logits) from `generator`."""
    dev = generator.device if generator is not None else torch.device(device or "cpu")

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    enc = [cfg.init_range * uniform((n_charts, max(2, int(r * H)), max(2, int(r * W)),
                                     cfg.encoding_dim_per_res), -1.0, 1.0)
           for r in cfg.resolutions]
    D = cfg.encoding_dim_per_res * len(cfg.resolutions)
    denc = cfg.init_range * uniform((n_charts, cfg.depth_bins, D), -1.0, 1.0)
    dims = [D] + [cfg.mlp_width] * (cfg.mlp_layers - 1) + [1]
    mlp = []
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        mlp.append({"w": uniform((n_charts, dims[i], dims[i + 1]), -bound, bound),
                    "b": uniform((n_charts, dims[i + 1]), -bound, bound)})
    return {"enc": enc, "denc": denc, "mlp": mlp,
            "conf_raw": torch.zeros((n_charts, H, W), device=dev)}


class ChartAlignState(NamedTuple):
    verts0: torch.Tensor       # (V, H, W, 3) initial chart points (world)
    ray_dirs: torch.Tensor     # (V, H, W, 3) unit rays from the camera centres
    uv: torch.Tensor           # (V, H, W, 2) encoding coords in [-1, 1]
    depth_coord: torch.Tensor  # (V, H, W) normalised depth in [-1, 1]
    deformation_radius: float


def build_state(cameras: Camera, depths: torch.Tensor, extent: float,
                cfg: ChartAlignConfig) -> ChartAlignState:
    V, H, W = depths.shape
    pts, rays = [], []
    for v in range(V):
        cam = camera_at(cameras, v)
        p = cam.backproject(depths[v])
        r = p - cam.center
        pts.append(p)
        rays.append(r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True) + 1e-12))
    dev = depths.device
    xs = (torch.arange(W, device=dev) + 0.5) / W * 2.0 - 1.0
    ys = (torch.arange(H, device=dev) + 0.5) / H * 2.0 - 1.0
    uv = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1).expand(V, H, W, 2)
    dmin = depths.amin(dim=(1, 2), keepdim=True)
    dmax = depths.amax(dim=(1, 2), keepdim=True)
    dcoord = (depths - dmin) / torch.clamp(dmax - dmin, min=1e-8) * 2.0 - 1.0
    return ChartAlignState(torch.stack(pts), torch.stack(rays), uv, dcoord,
                           cfg.deformation_radius_factor * extent)


def _upsample_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of bilinear enlargement at half-pixel centres
    with the edges clamped: row i holds 1 − f and f at the two source
    texels about (i + 0.5)·n_in/n_out − 0.5."""
    src = torch.clamp((torch.arange(n_out, device=device, dtype=torch.float32) + 0.5)
                      * (n_in / n_out) - 0.5, 0.0, n_in - 1.0)
    i0 = torch.floor(src).long()
    f = src - i0
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    a = torch.zeros(n_out, n_in, device=device)
    rows = torch.arange(n_out, device=device)
    a.index_put_((rows, i0), 1.0 - f, accumulate=True)
    a.index_put_((rows, i1), f, accumulate=True)
    return a


def sample_encodings(params_enc, H: int, W: int) -> torch.Tensor:
    """The chart code planes at the half-pixel pixel lattice: each (V, h, w,
    C) plane enlarged to (V, H, W, C) bilinearly, edges clamped, as two
    matmuls (the separable form `jax.image.resize` takes; its transpose is
    two matmuls too)."""
    feats = []
    for g in params_enc:
        ay = _upsample_matrix(H, g.shape[1], g.device)
        ax = _upsample_matrix(W, g.shape[2], g.device)
        feats.append(torch.einsum("yh,vhxc->vyxc", ay, torch.einsum("xw,vhwc->vhxc", ax, g)))
    return torch.cat(feats, -1)


def _sample_map(depth: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """`core.geometry.bilinear_sample` of an (H, W) map, its four texels
    read by `gather` on the flattened map: the gradient then lands by
    `scatter_add`, where advanced indexing's backward sorts every index."""
    H, W = depth.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = pixel_index(torch.floor(x), W - 2)
    y0 = pixel_index(torch.floor(y), H - 2)
    wx, wy = x - x0, y - y0
    flat = depth.reshape(-1)
    i00 = y0 * W + x0

    def at(i):
        return flat.gather(0, i)

    return (at(i00) * (1 - wx) * (1 - wy) + at(i00 + 1) * wx * (1 - wy)
            + at(i00 + W) * (1 - wx) * wy + at(i00 + W + 1) * wx * wy)


def forward_deformation(params, state: ChartAlignState, cfg: ChartAlignConfig) -> torch.Tensor:
    """→ deformed verts (V, H, W, 3)."""
    _, Hh, Wh = state.depth_coord.shape
    enc = sample_encodings(params["enc"], Hh, Wh)
    if cfg.weight_encodings_with_confidence:
        cw = (1.0 + torch.exp(params["conf_raw"].detach())) - 1.0
        enc = enc * (1.0 - torch.exp(-0.5 * cw * cw))[..., None]
    # The depth encoding: linear interpolation into the per-chart bin table,
    # written as the hat-function basis.
    nb = params["denc"].shape[1]
    t = torch.clamp((state.depth_coord + 1.0) / 2.0 * (nb - 1), 0.0, nb - 1.0)
    hat = torch.clamp(1.0 - torch.abs(t[..., None] - torch.arange(nb, device=t.device,
                                                                   dtype=t.dtype)), min=0.0)
    V, Hh, Wh = t.shape
    # The per-chart products run on (V, split) batches of pixels, split the
    # largest divisor of H·W up to _SPLIT, the weights broadcast over the
    # split: each weight gradient is then `split` products of H·W/split
    # pixels summed, where one product over all H·W pixels (a reduction of
    # 196,608 at 512×384) leaves most of the card idle.
    split = max(d for d in range(1, _SPLIT + 1) if (Hh * Wh) % d == 0)

    def per_chart(a, w):        # (V, H, W, I) @ (V, I, O) → (V, H, W, O)
        out = torch.matmul(a.reshape(V, split, -1, a.shape[-1]), w[:, None])
        return out.reshape(V, Hh, Wh, w.shape[-1])

    x = enc + per_chart(hat, params["denc"])
    for li, layer in enumerate(params["mlp"]):
        x = per_chart(x, layer["w"]) + layer["b"][:, None, None]
        if li < len(params["mlp"]) - 1:
            x = F.relu(x)
    return state.verts0 + (x * state.deformation_radius) * state.ray_dirs


def view_depths(cameras: Camera, verts: torch.Tensor) -> torch.Tensor:
    """(V, H, W, 3) world verts → per-view z depths (V, H, W)."""
    R2, t2 = cameras.w2c[:, 2, :3], cameras.w2c[:, 2, 3]
    return torch.einsum("vhwc,vc->vhw", verts, R2) + t2[:, None, None]


def sample_depth_at_points(cam: Camera, depth: torch.Tensor, pts: torch.Tensor):
    """Project points into cam and bilinearly sample `depth` (zero outside
    the view); returns (sampled, in_fov, z)."""
    xy, z = cam.project(pts)
    H, W = depth.shape
    # Half-pixel slack: border pixel centres float-project to W-1±ε.
    in_fov = ((xy[:, 0] >= -0.5) & (xy[:, 0] <= W - 0.5)
              & (xy[:, 1] >= -0.5) & (xy[:, 1] <= H - 0.5) & (z > 1e-6))
    return torch.where(in_fov, _sample_map(depth, xy), 0.0), in_fov, z


def build_matches(cameras: Camera, reference_depths: torch.Tensor, matching_thr: float):
    """Cross-chart mutual 3D matches (Matcher3D.match). Returns (matches (V,
    V·H·W) bool, ref_pts (V·H·W, 3), true_depth (V, V·H·W))."""
    V = reference_depths.shape[0]
    ref_pts = torch.cat([camera_at(cameras, v).backproject(reference_depths[v]).reshape(-1, 3)
                         for v in range(V)])
    errs, zs = [], []
    for v in range(V):
        sampled, fov, z = sample_depth_at_points(camera_at(cameras, v), reference_depths[v],
                                                 ref_pts)
        errs.append(torch.where(fov, torch.abs(z - sampled), 1e8))
        zs.append(z)
    return torch.stack(errs) < matching_thr, ref_pts, torch.stack(zs)


class ChartAlignResult(NamedTuple):
    depths: torch.Tensor        # (V, H, W) refined depths
    prior_depths: torch.Tensor  # (V, H, W) input depths
    pts: torch.Tensor           # (V, H, W, 3) refined chart points
    confs: torch.Tensor         # (V, H, W) learned confidence
    losses: List[float]


def _leaves(params) -> List[torch.Tensor]:
    return [*params["enc"], params["denc"], *(t for l in params["mlp"] for t in l.values()),
            params["conf_raw"]]


def align_charts(
    cameras: Camera,                 # batched (V,)
    depths: torch.Tensor,            # (V, H, W) initial (DA2-aligned) depths
    reference_depths: torch.Tensor,  # (V, H, W) SfM reference depths
    reference_masks: Optional[torch.Tensor] = None,   # (V, H, W) valid reference px
    extent: float = 1.0,
    cfg: ChartAlignConfig = ChartAlignConfig(),
    seed: int = 0,
    stats: Optional[Dict[str, float]] = None,
) -> ChartAlignResult:
    """`cfg.n_iterations` Adam steps on the cameras' device. `stats`, when
    given, receives ``s_per_iter`` (steady state: the clock starts after
    step 0) and ``iters``."""
    dev = cameras.w2c.device
    depths = torch.as_tensor(depths, device=dev).float()
    reference_depths = torch.as_tensor(reference_depths, device=dev).float()
    V, H, W = depths.shape
    state = build_state(cameras, depths, extent, cfg)
    params = init_params(V, H, W, cfg, torch.Generator(device=dev).manual_seed(seed))
    masks = ((reference_depths > 0) if reference_masks is None
             else torch.as_tensor(reference_masks, device=dev)).float()
    cams = [camera_at(cameras, v) for v in range(V)]

    def normals_of(d):
        return torch.stack([depth_to_normal(cams[v], d[v]) for v in range(V)])

    normals0 = normals_of(depths)
    curv0 = torch.stack([normal_to_curvature(n) for n in normals0])
    if cfg.use_matching_loss:
        matches, ref_pts, _ = build_matches(cameras, reference_depths,
                                            cfg.matching_thr_factor * extent)

    def loss_fn(params):
        verts = forward_deformation(params, state, cfg)
        dd = view_depths(cameras, verts)
        conf = 1.0 + torch.exp(params["conf_raw"])
        diff = torch.abs(dd - reference_depths)
        depth_loss = torch.sum(masks * (conf * diff - cfg.confidence_weighting
                                        * torch.log(conf))) / torch.clamp(masks.sum(), min=1.0)
        dnormals = normals_of(dd)
        normal_loss = torch.mean(1.0 - torch.sum(normals0 * dnormals, -1))
        dcurv = torch.stack([normal_to_curvature(n) for n in dnormals])
        total = (depth_loss + cfg.normal_loss_weight * normal_loss
                 + cfg.curvature_loss_weight * torch.mean(torch.abs(curv0 - dcurv)))
        if cfg.use_matching_loss:
            errs, fovs = [], []
            for v in range(V):
                sampled, fov, z = sample_depth_at_points(cams[v], dd[v], ref_pts)
                errs.append(torch.abs(z - sampled))
                fovs.append(fov)
            m = matches & torch.stack(fovs)
            match_loss = (torch.sum(torch.where(m, torch.stack(errs), 0.0))
                          / torch.clamp(m.sum(), min=1).float())
            total = total + cfg.matching_loss_weight * match_loss
        if cfg.regularize_chart_encodings_norms:
            enc_norm = torch.linalg.vector_norm(sample_encodings(params["enc"], H, W),
                                                dim=-1).mean()
            total = total + cfg.chart_encodings_norm_loss_weight * enc_norm
        if cfg.use_total_variation_on_depth_encodings:
            tv = torch.abs(params["denc"][:, 1:] - params["denc"][:, :-1]).mean()
            total = total + cfg.total_variation_on_depth_encodings_weight * tv
        return total

    def sched(base):
        if not cfg.lr_update_iters:
            return lambda count: base
        return piecewise_constant(base, cfg.lr_update_iters, cfg.lr_update_factor)

    # One Adam per parameter group, keyed by the leaves' order.
    groups = ([cfg.encodings_lr] * (len(params["enc"]) + 1)
              + [cfg.mlp_lr] * (2 * len(params["mlp"])) + [cfg.confidence_lr])
    leaves = _leaves(params)
    flat = {str(i): t for i, t in enumerate(leaves)}
    opt = Adam(flat, {str(i): sched(lr) for i, lr in enumerate(groups)})
    for t in leaves:
        t.requires_grad_(True)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    log_every = max(1, cfg.n_iterations // 20)
    samples = []
    t_ss = None
    with fp32_math():
        for it in range(cfg.n_iterations):
            loss = loss_fn(params)
            grads = torch.autograd.grad(loss, leaves)
            opt.step(flat, {str(i): g for i, g in enumerate(grads)})
            if it % log_every == 0:
                samples.append(loss.detach())
            if it == 0 and stats is not None:
                sync()
                t_ss = time.perf_counter()
        if stats is not None and cfg.n_iterations > 1:
            sync()
            stats["s_per_iter"] = (time.perf_counter() - t_ss) / (cfg.n_iterations - 1)
            stats["iters"] = cfg.n_iterations
        with torch.no_grad():
            verts = forward_deformation(params, state, cfg)
            dd = view_depths(cameras, verts)
            conf = 1.0 + torch.exp(params["conf_raw"])
    losses = [float(x) for x in torch.stack(samples).cpu()] if samples else []
    return ChartAlignResult(depths=dd, prior_depths=depths, pts=verts, confs=conf, losses=losses)


def save_charts_data(path: str, result: ChartAlignResult, scale_factor: float):
    """charts_data.npz with the reference's schema."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    np.savez(path, prior_depths=host(result.prior_depths), depths=host(result.depths),
             pts=host(result.pts), confs=host(result.confs),
             scale_factor=np.float32(scale_factor))


def load_charts_data(path: str) -> Dict[str, np.ndarray]:
    return dict(np.load(path))
