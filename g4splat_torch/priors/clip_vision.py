"""CLIP vision tower, See3D's image conditioning (counterpart of
`g4splat_tpu.priors.clip_vision`).

CLIP ViT-H/14 as the reference loads it (mv_diffusion.py:35): width 1280,
32 layers, 16 heads, projection 1024 (the SD-2.1 text width, so the two
contexts sum). Conv patch embedding without bias, class token, learned
positions, pre-LN transformer, final LN, linear projection of the class
token. LayerNorms use ε = 1e-6 as the JAX package does (ROADMAP C6).
Parameter names follow the JAX module's (``blocks.{i}.attn.qkv.weight``, …);
`g4splat_torch.convert.flax_state_dict` carries its params across.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from g4splat_torch.core.resize import resize_bilinear
from g4splat_torch.priors.vit import LN_EPS, Block, interpolate_pos_embed

_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)
_INPUT_SIZE = 224   # the embedder's input, whatever the tower's image_size


class CLIPVision(nn.Module):
    def __init__(self, embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 patch_size: int = 14, image_size: int = 224, projection_dim: int = 1024):
        super().__init__()
        n0 = (image_size // patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(0.02 * torch.randn(embed_dim))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(n0, embed_dim))
        self.pre_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads) for _ in range(depth))
        self.post_ln = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.visual_projection = nn.Linear(embed_dim, projection_dim, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, 3, H, W) CLIP-normalised → (projected class token (B, P),
        tokens (B, 1+N, C))."""
        B = x.shape[0]
        h = self.patch_embed(x)
        gh, gw = h.shape[2], h.shape[3]
        h = h.flatten(2).transpose(1, 2)
        h = torch.cat([self.class_embedding.expand(B, 1, -1), h], dim=1)
        pos = self.pos_embed
        if h.shape[1] != pos.shape[0]:
            pos = torch.cat([pos[:1], interpolate_pos_embed(pos[1:], gh, gw)], dim=0)
        h = self.pre_ln(h + pos[None])
        for blk in self.blocks:
            h = blk(h)
        h = self.post_ln(h)
        return self.visual_projection(h[:, 0]), h


class CLIPImageEmbedder:
    """Priors.image_embedder: an (H, W, 3) image in [0, 1] (or 0-255) →
    (1, n_tokens, P) conditioning: `scale` × the projected class token, tiled
    over the 77 prompt positions (pipeline_mvd_warp_mix_classifier.py:463-464,
    681)."""

    def __init__(self, model: Optional[CLIPVision] = None, n_tokens: int = 77,
                 scale: float = 0.2):
        self.model = model if model is not None else CLIPVision()
        self.n_tokens = n_tokens
        self.scale = scale

    @torch.no_grad()
    def __call__(self, image) -> torch.Tensor:
        p = next(self.model.parameters())
        img = torch.as_tensor(np.asarray(image, np.float32) if not torch.is_tensor(image)
                              else image).to(device=p.device, dtype=torch.float32)
        if float(img.max()) > 1.5:
            img = img / 255.0
        x = resize_bilinear(img, (_INPUT_SIZE, _INPUT_SIZE))
        mean = torch.tensor(_MEAN, device=p.device)
        std = torch.tensor(_STD, device=p.device)
        x = ((x - mean) / std).permute(2, 0, 1)[None]
        proj, _ = self.model(x)
        return self.scale * proj[:, None, :].repeat(1, self.n_tokens, 1)
