"""Stable-Diffusion KL autoencoder for the See3D latent space (counterpart of
`g4splat_tpu.priors.vae`).

The diffusers ``AutoencoderKL``, NCHW, under diffusers' state-dict key names
(``encoder.down_blocks.0.resnets.0.conv1.weight``, …): GroupNorm(min(32, C),
ε = 1e-6)/SiLU ResNet blocks, 2 resnets per encoder down-block and 3 per
decoder up-block, stride-2 downsampling with asymmetric (0, 1) padding, a
single-head mid-block self-attention, 4-channel latents scaled by
`SD_SCALE`. The mid-block attention is plain matmul + softmax, as the JAX
package leaves it to XLA (its head width, C = 512 at full size, is outside
kernel B3's templates).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from g4splat_torch.utils.profiling import annotated

SD_SCALE = 0.18215


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head mid-block attention (diffusers ``Attention`` with Linear
    q/k/v projections)."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = _gn(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        att = torch.softmax(q @ k.transpose(1, 2) / C ** 0.5, dim=-1)
        h = self.to_out[0](att @ v)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    """``downsamplers.0`` / ``upsamplers.0``: holds the conv named ``conv``."""

    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=0 if stride == 2 else 1)


class _Block(nn.Module):
    """A down or up block: ``resnets`` and, but for the last, a sampler list
    under `key` (``downsamplers`` / ``upsamplers``)."""

    def __init__(self, resnets, key: Optional[str] = None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if key is not None:
            setattr(self, key, nn.ModuleList([sampler]))


class Encoder(nn.Module):
    def __init__(self, base_ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 z_ch: int = 4):
        super().__init__()
        self.conv_in = nn.Conv2d(3, base_ch, 3, padding=1)
        blocks, ch = [], base_ch
        for i, m in enumerate(ch_mult):
            out = base_ch * m
            last = i == len(ch_mult) - 1
            blocks.append(_Block([ResnetBlock(ch, out), ResnetBlock(out, out)],
                                 *(() if last else ("downsamplers", _Sampler(out, 2)))))
            ch = out
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(ch)
        self.conv_norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(ch, 2 * z_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                # diffusers Downsample2D: stride 2 after an asymmetric (0, 1) pad.
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, base_ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 z_ch: int = 4, out_ch: int = 3):
        super().__init__()
        rev = list(reversed(ch_mult))
        ch = base_ch * rev[0]
        self.conv_in = nn.Conv2d(z_ch, ch, 3, padding=1)
        self.mid_block = MidBlock(ch)
        blocks = []
        for i, m in enumerate(rev):
            out = base_ch * m
            last = i == len(rev) - 1
            blocks.append(_Block([ResnetBlock(ch if j == 0 else out, out) for j in range(3)],
                                 *(() if last else ("upsamplers", _Sampler(out, 1)))))
            ch = out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _gn(ch)
        self.conv_out = nn.Conv2d(ch, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, base_ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 z_ch: int = 4):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.encoder = Encoder(base_ch, ch_mult, z_ch)
        self.decoder = Decoder(base_ch, ch_mult, z_ch)
        self.quant_conv = nn.Conv2d(2 * z_ch, 2 * z_ch, 1)
        self.post_quant_conv = nn.Conv2d(z_ch, z_ch, 1)

    @property
    def factor(self) -> int:
        """Pixels per latent along each axis."""
        return 2 ** (len(self.ch_mult) - 1)

    @annotated("g4s:see3d.vae")
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] → the scaled latent mean (B, z, H/f, W/f),
        as the See3D stage encodes (deterministically)."""
        mean, _ = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean * SD_SCALE

    @annotated("g4s:see3d.vae")
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z / SD_SCALE))

    def forward(self, x):
        return self.decode(self.encode(x))
