"""DPT fusion heads as DepthAnythingV2 and MASt3R use them (counterpart of
`g4splat_tpu.priors.dpt`).

Per-tap 1×1 projections → resize pyramid (transposed conv ×4, transposed
conv ×2, identity, stride-2 conv) → 3×3 bias-free "scratch" convolutions →
four FeatureFusionBlocks (two ResidualConvUnits each, align-corners
upsampling) → a two-stage output convolution with a trailing ReLU
(disparity ≥ 0). Tensors are NCHW. Parameter names are the reference torch
module's (`projects.{i}`, `resize_layers.{0,1,3}`,
`scratch.layer{1..4}_rn`, `scratch.refinenet{1..4}.{resConfUnit1,
resConfUnit2,out_conv}`, `scratch.output_conv1`, `scratch.output_conv2.{0,2}`);
refinenet4's resConfUnit1 exists there and is unused, as here.
`DPTOutputAdapter` is the CroCo flavour that MASt3R's heads use, under
CroCo's names.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def resize_bilinear_ac(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) with align-corners sampling, written
    as the JAX package writes it: the top-left source texel is clamped to
    [0, max(H-2, 0)], so the last row and column interpolate with weight 1
    (not `F.interpolate(align_corners=True)` at the border)."""
    B, C, H, W = x.shape
    h, w = size
    dev = x.device
    ys = torch.linspace(0.0, H - 1.0, h, device=dev)
    xs = torch.linspace(0.0, W - 1.0, w, device=dev)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, max(H - 2, 0))
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, max(W - 2, 0))
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    r0, r1 = x[:, :, y0], x[:, :, y1]
    a, b = r0[..., x0], r0[..., x1]
    c, d = r1[..., x0], r1[..., x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(resize_bilinear_ac(x, size))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int], last_dim: int):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for r in range(1, 5):
            setattr(self, f"refinenet{r}", FeatureFusionBlock(features))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, last_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(last_dim, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14, last_dim: int = 32):
        super().__init__()
        self.patch_size = patch_size
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1) for c in out_channels)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, stride=4),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(features, out_channels, last_dim)

    def forward(self, taps, grid: Tuple[int, int]) -> torch.Tensor:
        """taps: 4 × (B, N, C) patch tokens (shallow → deep) on the (gh, gw)
        grid → (B, 1, gh·14, gw·14) disparity."""
        gh, gw = grid
        feats = []
        for i, t in enumerate(taps):
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
            feats.append(self.resize_layers[i](self.projects[i](x)))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        path4 = s.refinenet4(rn[3], size=rn[2].shape[2:])
        path3 = s.refinenet3(path4, rn[2], size=rn[1].shape[2:])
        path2 = s.refinenet2(path3, rn[1], size=rn[0].shape[2:])
        path1 = s.refinenet1(path2, rn[0])
        out = s.output_conv1(path1)
        out = resize_bilinear_ac(out, (gh * self.patch_size, gw * self.patch_size))
        return s.output_conv2(out)


class _CroCoScratch(nn.Module):
    def __init__(self, features: int, layer_dims: Sequence[int]):
        super().__init__()
        for i, c in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        # The reference lists the same four convolutions again under
        # `layer_rn`; its state dict carries both names.
        self.layer_rn = nn.ModuleList(getattr(self, f"layer{i + 1}_rn")
                                      for i in range(len(layer_dims)))
        for r in range(1, 5):
            setattr(self, f"refinenet{r}", FeatureFusionBlock(features))


class DPTOutputAdapter(nn.Module):
    """The CroCo/DUSt3R flavour of the DPT head (croco's dpt_block.py, as the
    JAX package's `DPTHead` with `final_relu=False` computes it): per-tap 1×1
    projection and resize in `act_postprocess.{i}`, the scratch convolutions
    and fusion blocks, then `head` = conv 3×3 → ×2 align-corners resize →
    conv 3×3 → ReLU → conv 1×1, with no trailing activation (signed xyz and
    a raw confidence). `dim_tokens` are the four taps' widths."""

    def __init__(self, dim_tokens: Sequence[int], features: int = 256,
                 layer_dims: Sequence[int] = (96, 192, 384, 768), patch_size: int = 16,
                 head_out: int = 4, last_dim: Optional[int] = None):
        super().__init__()
        self.patch_size = patch_size
        d = layer_dims
        resize = [nn.ConvTranspose2d(d[0], d[0], 4, stride=4),
                  nn.ConvTranspose2d(d[1], d[1], 2, stride=2), None,
                  nn.Conv2d(d[3], d[3], 3, stride=2, padding=1)]
        self.act_postprocess = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c_in, c, 1), *([r] if r is not None else []))
            for c_in, c, r in zip(dim_tokens, d, resize))
        self.scratch = _CroCoScratch(features, d)
        last_dim = last_dim or features // 2
        self.head = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(features // 2, last_dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(last_dim, head_out, 1))

    def forward(self, taps, grid: Tuple[int, int]) -> torch.Tensor:
        """taps: 4 × (B, N, C_i) tokens on the (gh, gw) grid → (B, head_out,
        gh·p, gw·p)."""
        gh, gw = grid
        feats = [post(t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw))
                 for post, t in zip(self.act_postprocess, taps)]
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        path4 = s.refinenet4(rn[3], size=rn[2].shape[2:])
        path3 = s.refinenet3(path4, rn[2], size=rn[1].shape[2:])
        path2 = s.refinenet2(path3, rn[1], size=rn[0].shape[2:])
        path1 = s.refinenet1(path2, rn[0])
        h = self.head
        out = resize_bilinear_ac(h[0](path1), (gh * self.patch_size, gw * self.patch_size))
        return h[4](F.relu(h[2](out)))
