"""Vision-Transformer building blocks (counterpart of the part of
`g4splat_tpu.priors.vit` that the CLIP towers and DINOv2 use).

Pre-LN blocks with fused-qkv attention and an exact-GELU MLP, optionally
with LayerScale (DINOv2); LayerNorms use ε = 1e-6, as the JAX package's flax
defaults do (ROADMAP C6; DINOv2's reference uses 1e-6 as well). Attention
here is dense softmax attention in plain PyTorch, as the JAX package leaves
it to ``jax.nn.dot_product_attention``. The patch embedding is a stride-p
convolution over (B, H, W, 3) images. RoPE, cross-attention and the CroCo
decoder block belong to the MASt3R slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from g4splat_torch.core.resize import resize_bilinear
from g4splat_torch.ops.attention import dot_product_attention_plain

LN_EPS = 1e-6


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Erf-based GELU (torch nn.GELU's default)."""
    return F.gelu(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads).unbind(2)
        return self.proj(dot_product_attention_plain(q, k, v).reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layerscale: Optional[float] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layerscale is not None:
            self.ls1 = LayerScale(dim, layerscale)
            self.ls2 = LayerScale(dim, layerscale)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        """x: (B, H, W, 3) → ((B, N, C) tokens, (gh, gw))."""
        x = self.proj(x.permute(0, 3, 1, 2))
        gh, gw = x.shape[2], x.shape[3]
        return x.flatten(2).transpose(1, 2), (gh, gw)


def interpolate_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Bilinear grid resize of learned position embeddings (N0, C), laid out
    on a square source grid, to (gh·gw, C)."""
    n0, c = pos.shape
    g0 = int(round(n0 ** 0.5))
    return resize_bilinear(pos.reshape(g0, g0, c), (gh, gw)).reshape(gh * gw, c)
