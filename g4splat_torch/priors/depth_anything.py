"""DepthAnythingV2 monocular relative-depth model (counterpart of
`g4splat_tpu.priors.depth_anything`).

DINOv2 taps ([4, 11, 17, 23] for ViT-L) into a DPT head giving per-pixel
relative disparity (non-negative, affine-ambiguous: align it to metric depth
with `ops.depth_align`). The `DepthAnything` wrapper preprocesses as the
reference does: resize (`jax.image.resize`'s bilinear, antialiased when it
shrinks) so the short side is ≥ `input_size` with both sides multiples of
14, ImageNet normalization, and the disparity resized back to (H, W) with
`resize_bilinear_ac`. Batches run in slabs of `max_batch` views (the tail
slab padded by repeating its last view), in fp32 with TF32 off.

Module names follow the official torch checkpoint (`pretrained.*`,
`depth_head.projects.i`, `depth_head.resize_layers.i`,
`depth_head.scratch.*`), so its state dict loads with `load_state_dict`;
`convert.depth_anything_state_dict` carries the JAX package's flax params.
No weights ship with the repository: a seeded random init stands in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from g4splat_torch.core.geometry import depth_to_normal
from g4splat_torch.core.resize import resize_bilinear
from g4splat_torch.device import DeviceLike, fp32_math, resolve_device
from g4splat_torch.ops.depth_align import fit_disparity_to_depth
from g4splat_torch.priors.dinov2 import DINOv2, VIT_CONFIGS
from g4splat_torch.priors.dpt import DPTHead, resize_bilinear_ac

INTERMEDIATE_IDX = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
    "vitg": (9, 19, 29, 39),
}
DPT_FEATURES = {"vits": 64, "vitb": 128, "vitl": 256, "vitg": 384}
DPT_OUT_CHANNELS = {
    "vits": (48, 96, 192, 384),
    "vitb": (96, 192, 384, 768),
    "vitl": (256, 512, 1024, 1024),
    "vitg": (1536, 1536, 1536, 1536),
}

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class DepthAnythingV2(nn.Module):
    def __init__(self, encoder: str = "vitl"):
        super().__init__()
        self.encoder = encoder
        cfg = VIT_CONFIGS[encoder]
        self.pretrained = DINOv2(**cfg)
        self.depth_head = DPTHead(cfg["embed_dim"], DPT_FEATURES[encoder],
                                  DPT_OUT_CHANNELS[encoder])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) ImageNet-normalized, H and W multiples of 14 →
        (B, H, W) relative disparity."""
        taps, grid = self.pretrained(x, out_indices=INTERMEDIATE_IDX[self.encoder])
        return self.depth_head([t for t, _ in taps], grid)[:, 0]


class DepthAnything:
    """The model with the reference's preprocessing, on one device."""

    def __init__(self, encoder: str = "vitl", model: Optional[DepthAnythingV2] = None,
                 seed: int = 0, input_size: int = 518, device: DeviceLike = None):
        self.encoder = encoder
        self.input_size = input_size
        if model is None:
            dev = resolve_device(device)
            with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
                torch.manual_seed(seed)
                with torch.device(dev):
                    model = DepthAnythingV2(encoder)
        self.model = model.eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @staticmethod
    def _target_size(h: int, w: int, lower_bound: int) -> Tuple[int, int]:
        """Scale so the short side reaches lower_bound, each side rounded to a
        multiple of 14 and kept ≥ lower_bound."""
        scale = max(lower_bound / h, lower_bound / w)
        nh = max(int(round(h * scale / 14) * 14), lower_bound)
        nw = max(int(round(w * scale / 14) * 14), lower_bound)
        return nh, nw

    def _prepare(self, images) -> torch.Tensor:
        imgs = torch.as_tensor(images, device=self.device).to(torch.float32)
        if float(imgs.max()) > 1.5:
            imgs = imgs / 255.0
        return imgs

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(_STD, dtype=torch.float32, device=x.device)
        return (x - mean) / std

    @torch.no_grad()
    @fp32_math()
    def infer_image(self, image) -> torch.Tensor:
        """(H, W, 3) uint8 or float [0, 1] → (H, W) disparity."""
        return self.infer_images(self._prepare(image)[None], max_batch=1)[0]

    @torch.no_grad()
    @fp32_math()
    def infer_batch(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float [0, 1], H and W multiples of 14 → (B, H, W)."""
        return self.model(self._normalize(self._prepare(images)))

    @torch.no_grad()
    @fp32_math()
    def infer_images(self, images, max_batch: int = 16) -> torch.Tensor:
        """(V, H, W, 3) uint8 or float [0, 1] → (V, H, W) disparity on the
        model's device, one ViT forward per slab of `max_batch` views."""
        imgs = self._prepare(images)
        V, H, W = imgs.shape[:3]
        nh, nw = self._target_size(H, W, self.input_size)
        outs = []
        for i in range(0, V, max_batch):
            x = self._normalize(resize_bilinear(imgs[i:i + max_batch], (nh, nw)))
            disp = self.model(x)
            outs.append(resize_bilinear_ac(disp[:, None], (H, W))[:, 0])
        return torch.cat(outs)


def depth_and_normal_from_disparity(disp: torch.Tensor, camera, ref_depth_samples=None,
                                    sample_disp=None, weights=None):
    """Disparity → metric depth (an affine fit when reference samples are
    given, else 1/disparity) → world normals."""
    if ref_depth_samples is not None:
        depth, _, _ = fit_disparity_to_depth(
            disp, ref_depth_samples, sample_disp,
            weights if weights is not None else torch.ones_like(ref_depth_samples))
    else:
        depth = 1.0 / torch.clamp(disp, min=1e-6)
    return depth, depth_to_normal(camera, depth)
