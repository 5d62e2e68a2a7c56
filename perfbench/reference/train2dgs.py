"""Plain PyTorch reference of the 2DGS training step: the losses, their
gradients by autograd through `surfel.render`, and Adam.

Written from the reference trainer (2d-gaussian-splatting
train_with_refine_depth.py:71-663, utils/loss_utils.py, matcha's depth
losses) and the configuration's settings, which `follow` takes as a dict
(the `train` group of a configuration file). Imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import surfel
from perfbench.reference.precision import Ops

LEAVES = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw")


def _abs(x):
    """|x| with the subgradient +1 at 0."""
    return torch.where(x >= 0, x, -x)


def ssim(a, b, ops: Ops, size: int = 11, sigma: float = 1.5):
    """Mean SSIM of (H, W, C) images, separable Gaussian window, zero padding."""
    x = torch.arange(size, dtype=torch.float32, device=a.device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    pad = size // 2

    def blur(t):
        t = t.permute(2, 0, 1)[:, None]
        t = ops.conv2d(t, g.reshape(1, 1, -1, 1), padding=(pad, 0))
        t = ops.conv2d(t, g.reshape(1, 1, 1, -1), padding=(0, pad))
        return t[:, 0].permute(1, 2, 0)

    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def curvature(n):
    """L1 norm of the summed 4-neighbour differences, border replicated."""
    p = torch.cat([n[:1], n, n[-1:]], 0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], 1)
    c = p[1:-1, 1:-1]
    s = (p[:-2, 1:-1] - c) + (p[1:-1, :-2] - c) + (p[2:, 1:-1] - c) + (p[1:-1, 2:] - c)
    return _abs(s).sum(-1)


def depth_order(depth, prior, shifts, extent: float = 1.0, log_scale: float = 20.0):
    """Pairwise depth-order loss with per-pixel shifts (matcha depth.py:142-223)."""
    H, W = depth.shape
    rows = torch.arange(H, device=depth.device)[:, None]
    cols = torch.arange(W, device=depth.device)[None, :]
    sy = torch.clamp(rows + shifts[..., 0], 0, H - 1)
    sx = torch.clamp(cols + shifts[..., 1], 0, W - 1)
    diff = (depth - depth[sy, sx]) / extent
    pd = (prior - prior[sy, sx]) / extent
    pd = pd / torch.clamp(torch.abs(pd).detach(), min=1e-8)
    return torch.log1p(log_scale * -torch.clamp(diff * pd, max=0.0)).mean()


def regularization_factor(it: int, initial: float) -> float:
    return max(initial / 2.0 ** (it // 1000), 0.015)


def depth_order_lambda(it: int) -> float:
    for after, lam in ((6000, 0.001), (4500, 0.01), (3000, 0.1), (1500, 1.0)):
        if it > after:
            return lam
    return 0.0


def activated(p: Dict[str, torch.Tensor], alive, mip) -> Dict[str, torch.Tensor]:
    """Scales and opacity with the mip filter's compensation, dead slots at
    opacity 0 (gaussian_model.py:158-192)."""
    s2 = torch.exp(2.0 * p["scaling_raw"])
    det1 = torch.prod(s2, 1)
    det2 = torch.prod(s2 + mip * mip, 1)
    o = torch.sigmoid(p["opacity_raw"])[:, 0] * torch.sqrt(det1 / torch.clamp(det2, min=1e-30))
    return {"scaling": torch.sqrt(torch.exp(p["scaling_raw"]) ** 2 + mip * mip),
            "opacity": o * alive}


def mip_filter(xyz, cams: List[surfel.Cam], variance: float = 0.2) -> torch.Tensor:
    """(P, 1): min view depth over the cameras that see a splat (in front of
    0.2, within 15 % beyond the image) / the largest focal · √variance
    (gaussian_model.py:388-434); unseen splats take the seen maximum."""
    dists, seen = [], []
    for c in cams:
        pc = xyz @ c.w2c[:3, :3].T + c.w2c[:3, 3]
        z = torch.clamp(pc[:, 2], min=1e-3)
        x = pc[:, 0] / z * c.fx + c.width / 2.0
        y = pc[:, 1] / z * c.fy + c.height / 2.0
        ok = ((pc[:, 2] > 0.2) & (x >= -0.15 * c.width) & (x <= 1.15 * c.width)
              & (y >= -0.15 * c.height) & (y <= 1.15 * c.height))
        dists.append(torch.where(ok, z, torch.inf))
        seen.append(ok)
    d = torch.stack(dists).amin(0)
    s = torch.stack(seen).any(0)
    d = torch.where(s, d, torch.where(s, d, -torch.inf).max())
    fmax = torch.stack([c.fx for c in cams]).max()
    return (d / fmax * variance ** 0.5)[:, None]


def step_loss(p, alive, mip, cam, view, cfg: dict, it: int, sh_degree: int, shifts, ops: Ops,
              rows: slice = slice(None)):
    """The step's total loss (train_with_refine_depth.py:382-490). Its image
    terms are means over the pixels of `rows` (every row but in a fault
    reading)."""
    act = activated(p, alive, mip)
    scene = {"xyz": p["xyz"], "features": torch.cat([p["f_dc"], p["f_rest"]], 1),
             "opacity": act["opacity"], "scaling": act["scaling"],
             "rotation_raw": p["rotation_raw"]}
    out = surfel.render(cam, scene, sh_degree, ops, depth_ratio=cfg["depth_ratio"],
                        max_tiles=cfg["raster_max_tiles_per_splat"],
                        want_dist=cfg["lambda_dist"] != 0.0)
    out = {k: v[rows] if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in out.items()}
    view = {k: v[rows] if v.ndim >= 2 else v for k, v in view.items()}
    shifts = shifts[rows]
    img, gt = out["render"], view["image"]
    lam = cfg["lambda_dssim"]
    color = (((1 - lam) * _abs(img - gt).mean() + lam * (1 - ssim(img, gt, ops)))
             * view["color_weight"])
    total = color
    if it > cfg["normal_consistency_from"]:
        total = total + cfg["lambda_normal"] * (
            1 - (out["rend_normal"] * out["surf_normal"]).sum(-1)).mean()
    if it > cfg["distortion_from"]:
        total = total + cfg["lambda_dist"] * out["rend_dist"].mean()
    rf = regularization_factor(it, cfg["initial_regularization_factor"])
    sd = out["surf_depth"]
    pri = rf * 0.75 * (cfg["confidence_weighting"] * torch.log1p(
        view["scale_factor"] * _abs(view["prior_depth"] - sd))).mean()
    pri = pri + rf * 0.5 * (1 - (out["surf_normal"] * view["prior_normal"]).sum(-1)).mean()
    pri = pri + rf * 0.5 * (1 - (out["rend_normal"] * view["prior_normal"]).sum(-1)).mean()
    pri = pri + rf * 0.25 * _abs(view["prior_curv"] - curvature(out["rend_normal"])).mean()
    pri = pri + depth_order_lambda(it) * depth_order(sd, view["prior_depth"], shifts,
                                                     cfg["spatial_lr_scale"])
    total = total + pri
    s = act["scaling"]
    ratio = s.amax(-1) / torch.clamp(s.amin(-1), min=1e-12)
    a = alive.to(torch.float32)
    pen = (torch.clamp(ratio, min=cfg["anisotropy_max_ratio"]) - cfg["anisotropy_max_ratio"]) * a
    return total + cfg["lambda_anisotropy"] * pen.sum() / torch.clamp(a.sum(), min=1.0)


def learning_rates(cfg: dict, update: int) -> Dict[str, float]:
    """Per-leaf rates; xyz's log-linear decay at the count of updates taken."""
    init = cfg["position_lr_init"] * cfg["spatial_lr_scale"]
    final = cfg["position_lr_final"] * cfg["spatial_lr_scale"]
    t = min(max(update / cfg["position_lr_max_steps"], 0.0), 1.0)
    return {"xyz": math.exp(math.log(init) * (1 - t) + math.log(final) * t),
            "f_dc": cfg["feature_lr"], "f_rest": cfg["feature_lr"] / 20.0,
            "opacity_raw": cfg["opacity_lr"], "scaling_raw": cfg["scaling_lr"],
            "rotation_raw": cfg["rotation_lr"]}


def follow(init: Dict[str, torch.Tensor], alive, cams: List[surfel.Cam], views: dict,
           cfg: dict, first_iteration: int, trainer_seed: int, n_steps: int, sh_degree: int,
           ops: Ops, rows: slice = slice(None)):
    """`n_steps` training steps from `init` (the six leaves), iterations
    first_iteration + 1, ...: one view per step from a permutation drawn by
    numpy's default_rng(trainer_seed), taken from its end; the depth-order
    shifts from a torch.Generator seeded with trainer_seed on the leaves'
    device; Adam (0.9, 0.999, ε 1e-15). Returns each step's loss, the first
    gradient's norm per leaf and the norm per leaf of the change after the
    last step."""
    dev = init["xyz"].device
    p = {k: init[k].detach().clone().requires_grad_(True) for k in LEAVES}
    with torch.no_grad():
        mip = mip_filter(init["xyz"], cams)
    rng = np.random.default_rng(trainer_seed)
    gen = torch.Generator(device=dev).manual_seed(trainer_seed)
    n_views = views["image"].shape[0]
    stack: list = []
    m = {k: torch.zeros_like(p[k]) for k in LEAVES}
    v = {k: torch.zeros_like(p[k]) for k in LEAVES}
    b1, b2, eps = 0.9, 0.999, 1e-15
    H, W = views["image"].shape[1:3]
    shift = int(round(0.05 * max(H, W)))
    losses, grad_norms = [], {}
    for step in range(1, n_steps + 1):
        it = first_iteration + step
        if not stack:
            stack = list(rng.permutation(n_views))
        vi = int(stack.pop())
        view = {k: views[k][vi] for k in ("image", "prior_depth", "prior_normal",
                                          "prior_curv", "color_weight")}
        view["scale_factor"] = views["scale_factor"]
        shifts = torch.randint(-shift, shift + 1, (H, W, 2), generator=gen, device=dev)
        loss = step_loss(p, alive, mip, cams[vi], view, cfg, it, sh_degree, shifts, ops, rows)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES])
        losses.append(float(loss.detach()))
        lrs = learning_rates(cfg, step - 1)
        with torch.no_grad():
            for k, g in zip(LEAVES, grads):
                if step == 1:
                    grad_norms[k] = float(torch.linalg.norm(g))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** step)
                vh = v[k] / (1 - b2 ** step)
                p[k].sub_(lrs[k] * mh / (torch.sqrt(vh) + eps))
    with torch.no_grad():
        change = {k: float(torch.linalg.norm(p[k] - init[k])) for k in LEAVES}
    return {"loss": losses, "grad": grad_norms, "change": change}
