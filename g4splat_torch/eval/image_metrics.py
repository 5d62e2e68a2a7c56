"""Image metrics: PSNR, SSIM, LPIPS (counterpart of
`g4splat_tpu.eval.image_metrics`).

LPIPS is a VGG16 feature stack with the standard calibration heads, in NCHW
with `F.conv2d` / `F.max_pool2d`, in fp32 (TF32 off, `fp32_math`):
- input scaled to [-1, 1], then shift/scale normalized
  (lpipsPyTorch/modules/utils.py conventions);
- features tapped at conv{1_2, 2_2, 3_3, 4_3, 5_3}, unit-normalized over
  channels;
- squared differences → |linear head| weights → spatial mean → sum.

Pretrained weights are a deployment artifact: `load_torch_lpips_weights`
reads a torchvision VGG16 `features.*` state dict and the LPIPS
`lin*.model.1.weight` heads. Without them the params are a seeded He init
(torch's generator, so not the JAX package's numbers; `convert.
lpips_params_from` carries JAX params over), and `LPIPS.calibrated` is False.
PSNR and SSIM are the training losses' (`train/losses.py`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from g4splat_torch.device import DeviceLike, fp32_math, resolve_device
from g4splat_torch.train.losses import psnr, ssim

# VGG16 conv plan: (out_channels, pool_before)
VGG16_PLAN = [
    (64, False), (64, False),                  # conv1_1, conv1_2 → tap 0
    (128, True), (128, False),                 # conv2_*          → tap 1
    (256, True), (256, False), (256, False),   # conv3_*          → tap 2
    (512, True), (512, False), (512, False),   # conv4_*          → tap 3
    (512, True), (512, False), (512, False),   # conv5_*          → tap 4
]
TAP_LAYERS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)
# torchvision's indices of the convolutions in vgg16.features
TV_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Params = Dict[str, List]


def init_lpips_params(seed: int = 0, device: DeviceLike = None) -> Params:
    """Seeded He init of the VGG16 convolutions (O, I, 3, 3) and zero biases,
    and |N(0, 1)| · 0.1 heads."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: Params = {"conv": [], "lin": []}
    cin = 3
    for cout, _ in VGG16_PLAN:
        std = math.sqrt(2.0 / (9 * cin))
        params["conv"].append({"w": (std * torch.randn((cout, cin, 3, 3), generator=gen)).to(dev),
                               "b": torch.zeros(cout, device=dev)})
        cin = cout
    for ch in TAP_CHANNELS:
        params["lin"].append((torch.randn(ch, generator=gen).abs() * 0.1).to(dev))
    return params


def load_torch_lpips_weights(vgg_state: Dict, lpips_state: Dict,
                             device: DeviceLike = None) -> Params:
    """torchvision VGG16 `features.{idx}.weight/bias` + LPIPS
    `lin{i}.model.1.weight` state dicts (arrays or tensors) → params."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return {
        "conv": [{"w": f32(vgg_state[f"features.{i}.weight"]),
                  "b": f32(vgg_state[f"features.{i}.bias"])} for i in TV_CONV_IDX],
        "lin": [f32(lpips_state[f"lin{i}.model.1.weight"]).reshape(-1) for i in range(5)],
    }


def _vgg_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (H, W, 3) in [-1, 1] → the 5 tapped (C, h, w) feature maps."""
    shift = torch.tensor(_SHIFT, device=x.device)
    scale = torch.tensor(_SCALE, device=x.device)
    x = ((x - shift) / scale).permute(2, 0, 1)[None]            # NCHW
    feats = []
    for i, ((_, pool), conv) in enumerate(zip(VGG16_PLAN, params["conv"])):
        if pool:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(F.conv2d(x, conv["w"], conv["b"], padding=1))
        if i in TAP_LAYERS:
            feats.append(x[0])
    return feats


def lpips(params: Params, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """img1, img2: (H, W, 3) in [0, 1] → scalar LPIPS distance."""
    a = _vgg_features(params, img1 * 2.0 - 1.0)
    b = _vgg_features(params, img2 * 2.0 - 1.0)
    total = img1.new_zeros(())
    for fa, fb, w in zip(a, b, params["lin"]):
        fa = fa / (torch.linalg.norm(fa, dim=0, keepdim=True) + 1e-10)
        fb = fb / (torch.linalg.norm(fb, dim=0, keepdim=True) + 1e-10)
        d = (fa - fb) ** 2
        total = total + torch.mean(torch.sum(d * torch.abs(w)[:, None, None], dim=0))
    return total


class LPIPS:
    """LPIPS with its params on one device (the card unless device="cpu");
    calls run without autograd and with TF32 off, and return a float."""

    def __init__(self, params: Optional[Params] = None, seed: int = 0,
                 calibrated: Optional[bool] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else init_lpips_params(seed=seed, device=self.device))
        # Without converted VGG16 + LPIPS-head weights the metric is LPIPS
        # in architecture only; evaluate() reports the flag beside it.
        self.calibrated = (params is not None) if calibrated is None else bool(calibrated)

    def __call__(self, img1, img2) -> float:
        with torch.no_grad(), fp32_math():
            return float(lpips(self.params, _as_image(img1, self.device),
                               _as_image(img2, self.device)))


def _as_image(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def evaluate_images(renders, gts, lpips_model: Optional[LPIPS] = None) -> Dict[str, float]:
    """Per-set means of PSNR/SSIM (and LPIPS with a model) over (N, H, W, 3)
    images in [0, 1] (reference image_eval.py:16-42). PSNR and SSIM run on
    the renders' device (the CPU for arrays)."""
    dev = renders.device if torch.is_tensor(renders) else torch.device("cpu")
    ps, ss, lp = [], [], []
    with torch.no_grad(), fp32_math():
        for r, g in zip(renders, gts):
            r, g = _as_image(r, dev), _as_image(g, dev)
            ps.append(float(psnr(r, g)))
            ss.append(float(ssim(r, g)))
            if lpips_model is not None:
                lp.append(lpips_model(r, g))
    out = {"PSNR": float(np.mean(ps)), "SSIM": float(np.mean(ss))}
    if lp:
        out["LPIPS"] = float(np.mean(lp))
    return out
