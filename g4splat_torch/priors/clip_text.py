"""CLIP text tower, See3D's prompt conditioning (counterpart of
`g4splat_tpu.priors.clip_text`).

By default the SD-2.x OpenCLIP ViT-H text tower as SD-2.1 pipelines read
it: width 1024, the first 23 layers, 16 heads, causal attention, final
LayerNorm (ε = 1e-5 throughout, as the JAX module sets it), exact GELU.
`act="quick_gelu"` and a `max_positions` longer than `n_ctx` give the SD-1.x
CLIP ViT-L tower (x·σ(1.702x); the forward reads the first `n_ctx` rows of
the position table). In production the prompt is the empty string
(see3d_util.py:44), whose ids are [BOS, EOS, pad, …].
Parameter names follow the JAX module's; `g4splat_torch.convert
.flax_state_dict` carries its params across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BOS_ID = 49406
EOS_ID = 49407


class _CausalAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads).unbind(2)
        att = torch.einsum("bnhd,bmhd->bhnm", q, k) / np.sqrt(C // self.num_heads)
        mask = torch.ones((N, N), dtype=torch.bool, device=x.device).tril()
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
        return self.proj(torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(B, N, C))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _TextBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, act: str = "gelu"):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = quick_gelu if act == "quick_gelu" else F.gelu
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _CausalAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


class CLIPText(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 1024, depth: int = 23,
                 num_heads: int = 16, n_ctx: int = 77, max_positions: int = 0,
                 act: str = "gelu"):
        super().__init__()
        self.n_ctx = n_ctx
        self.token_embedding = nn.Parameter(0.02 * torch.randn(vocab_size, width))
        # The checkpoint's position table (0 → n_ctx rows).
        self.pos_embed = nn.Parameter(0.01 * torch.randn(max_positions or n_ctx, width))
        self.blocks = nn.ModuleList(_TextBlock(width, num_heads, act) for _ in range(depth))
        self.final_ln = nn.LayerNorm(width, eps=1e-5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids: (B, n_ctx) token ids → the last hidden state after the final
        LayerNorm, (B, n_ctx, width)."""
        x = self.token_embedding[ids.long()] + self.pos_embed[None, :ids.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        return self.final_ln(x)


def empty_prompt_ids(n_ctx: int = 77, pad_id: int = 0) -> np.ndarray:
    """Token ids of the empty prompt: [BOS, EOS, pad…]. SD2.x OpenCLIP
    checkpoints pad with 0; SD1.x CLIP pads with EOS (49407)."""
    ids = np.full((1, n_ctx), pad_id, np.int32)
    ids[0, 0] = BOS_ID
    ids[0, 1] = EOS_ID
    return ids


class CLIPTextEmbedder:
    """Priors.text_embedder: () or (ids) → (1, n_ctx, width) prompt
    embedding; with no argument, the cached empty-prompt embedding."""

    def __init__(self, model: Optional[CLIPText] = None, pad_id: int = 0):
        self.model = model if model is not None else CLIPText()
        self.pad_id = pad_id
        self._empty = None

    @torch.no_grad()
    def __call__(self, ids: Optional[np.ndarray] = None) -> torch.Tensor:
        dev = self.model.token_embedding.device
        if ids is None:
            if self._empty is None:
                self._empty = self.model(torch.as_tensor(
                    empty_prompt_ids(self.model.n_ctx, self.pad_id), device=dev))
            return self._empty
        return self.model(torch.as_tensor(np.asarray(ids), device=dev))
