"""DINOv2 ViT encoder, the DepthAnythingV2 backbone (counterpart of
`g4splat_tpu.priors.dinov2`).

Patch-14 ViT with a class token, learned position embeddings (resized
bilinearly to the input grid), LayerScale blocks, and the final-normed
(patch tokens, class token) of the requested blocks. Parameter names are
the reference torch module's (`patch_embed.proj`, `cls_token`, `pos_embed`,
`mask_token`, `blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,mlp.fc1,
mlp.fc2,ls2.gamma}`, `norm`), so its state dict loads as it is;
`mask_token` is carried for that and unused at inference.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from g4splat_torch.priors.vit import LN_EPS, Block, PatchEmbed, interpolate_pos_embed

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24),
}


class DINOv2(nn.Module):
    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_size: int = 14, mlp_ratio: float = 4.0, layerscale: float = 1e-5,
                 pretrain_img_size: int = 518):
        super().__init__()
        self.embed_dim = embed_dim
        g0 = pretrain_img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.randn(1, g0 * g0 + 1, embed_dim) * 0.02)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=True, layerscale=layerscale)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, out_indices: Sequence[int] = (4, 11, 17, 23)):
        """x: (B, H, W, 3), H and W multiples of 14 → ([(patch tokens
        (B, N, C), cls (B, C)) per requested block], (gh, gw))."""
        B = x.shape[0]
        tokens, (gh, gw) = self.patch_embed(x)
        tokens = tokens + interpolate_pos_embed(self.pos_embed[0, 1:], gh, gw)[None]
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, 1, self.embed_dim)
        x = torch.cat([cls, tokens], dim=1)
        outs = []
        want = set(out_indices)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                outs.append(self.norm(x))
        return [(o[:, 1:], o[:, 0]) for o in outs], (gh, gw)
