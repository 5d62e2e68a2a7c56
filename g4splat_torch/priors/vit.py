"""Vision-Transformer building blocks (counterpart of
`g4splat_tpu.priors.vit`, which the CLIP towers, DINOv2 and MASt3R use).

Pre-LN blocks with fused-qkv attention and an exact-GELU MLP, optionally
with LayerScale (DINOv2) or 2D RoPE on queries and keys (the CroCo blocks
of MASt3R); the CroCo decoder block adds cross-attention to the other
view's tokens. LayerNorms use ε = 1e-6, as the JAX package's flax defaults
do (ROADMAP C6; DINOv2's and CroCo's references use 1e-6 as well).
Attention here is dense softmax attention in plain PyTorch, in fp32, as the
JAX package leaves it to ``jax.nn.dot_product_attention``. The patch
embedding is a stride-p convolution over (B, H, W, 3) images.
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
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


def make_2d_rope_freqs(dim: int, base: float = 100.0, device=None) -> torch.Tensor:
    """Per-axis inverse frequencies of 2D RoPE for a head width `dim` (the
    CroCo curope semantics: half the head rotates with y, half with x)."""
    d4 = dim // 4
    return 1.0 / (base ** (torch.arange(0, d4, dtype=torch.float32, device=device) / d4))


def apply_rope_2d(x: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """x: (B, H, N, D) heads first; positions: (B, N, 2) integer (y, x).
    The first half of D rotates by the y angle, the second by the x angle,
    each half as two quarters (v1, v2) → (v1 cos − v2 sin, v2 cos + v1 sin)."""
    D = x.shape[-1]
    freqs = make_2d_rope_freqs(D, base, x.device)
    pos = positions.to(torch.float32)

    def rot(v, angles):                       # v (B, H, N, d); angles (B, N, d/2)
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
        v1, v2 = v.chunk(2, dim=-1)
        return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin], -1)

    xy, xx = x.chunk(2, dim=-1)
    return torch.cat([rot(xy, pos[..., 0, None] * freqs), rot(xx, pos[..., 1, None] * freqs)], -1)


def grid_positions(b: int, gh: int, gw: int, device=None) -> torch.Tensor:
    """(B, gh·gw, 2) integer (y, x) token positions for RoPE."""
    ys, xs = torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device),
                            indexing="ij")
    return torch.stack([ys, xs], -1).reshape(1, gh * gw, 2).expand(b, -1, -1)


def _attend(q, k, v, num_heads, rope_base, pos_q, pos_k):
    """(B, N, C) queries, (B, M, C) keys and values → (B, N, C), RoPE'd
    when positions are given."""
    B, N, C = q.shape
    q = q.reshape(B, N, num_heads, C // num_heads)
    k = k.reshape(B, k.shape[1], num_heads, C // num_heads)
    v = v.reshape(B, v.shape[1], num_heads, C // num_heads)
    if pos_q is not None:
        q = apply_rope_2d(q.transpose(1, 2), pos_q, rope_base).transpose(1, 2)
        k = apply_rope_2d(k.transpose(1, 2), pos_k, rope_base).transpose(1, 2)
    return dot_product_attention_plain(q, k, v).reshape(B, N, C)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_rope: bool = False, rope_base: float = 100.0):
        super().__init__()
        self.num_heads, self.use_rope, self.rope_base = num_heads, use_rope, rope_base
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, positions=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        pos = positions if self.use_rope else None
        return self.proj(_attend(q, k, v, self.num_heads, self.rope_base, pos, pos))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_rope: bool = False, rope_base: float = 100.0):
        super().__init__()
        self.num_heads, self.use_rope, self.rope_base = num_heads, use_rope, rope_base
        self.projq = nn.Linear(dim, dim, bias=qkv_bias)
        self.projk = nn.Linear(dim, dim, bias=qkv_bias)
        self.projv = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, context, positions=None, context_positions=None):
        rope = self.use_rope
        return self.proj(_attend(self.projq(x), self.projk(context), self.projv(context),
                                 self.num_heads, self.rope_base,
                                 positions if rope else None,
                                 context_positions if rope else None))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layerscale: Optional[float] = None,
                 use_rope: bool = False, rope_base: float = 100.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, use_rope, rope_base)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layerscale is not None:
            self.ls1 = LayerScale(dim, layerscale)
            self.ls2 = LayerScale(dim, layerscale)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x, positions=None):
        x = x + self.ls1(self.attn(self.norm1(x), positions))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DecoderBlock(nn.Module):
    """CroCo decoder block: self-attention, cross-attention to the other
    view's (normed) tokens, MLP; each pre-LN and residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, use_rope: bool = False, rope_base: float = 100.0,
                 norm_mem: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, use_rope, rope_base)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias, use_rope, rope_base)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm_y = nn.LayerNorm(dim, eps=LN_EPS) if norm_mem else nn.Identity()

    def forward(self, x, context, positions=None, context_positions=None):
        x = x + self.attn(self.norm1(x), positions)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(context), positions,
                                context_positions)
        return x + self.mlp(self.norm3(x))


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
