"""Segment Anything (SAM), the plane-mask proposal generator (counterpart of
`g4splat_tpu.priors.sam`).

- `ImageEncoder`: a ViT with windowed attention (the grid padded to a
  multiple of the window after `norm1`), decomposed relative position
  biases added to fp32 logits, an absolute `pos_embed` and a convolution
  neck with channel LayerNorms (`LayerNorm2d`, eps 1e-6).
- `PromptEncoder`: random-Fourier point encoding plus learned per-label
  point embeddings (and not-a-point), the no-mask dense embedding.
  `mask_downscaling` is built so that an official state dict loads with
  `strict=True`, and never called: the pipeline prompts with points only.
- `MaskDecoder`: the two-way transformer, 4× upscaling by transposed
  convolutions (the official weights as they are), per-token hypernetwork
  MLPs and the IoU head.

`SAMConfig()` is `sam_vit_h`: ViT-H 1280 wide, 32 blocks, 16 heads, 14×14
windows, global attention in every 8th block, 1024 px input, a 256-wide
prompt encoder and decoder. Module names are the official checkpoint's
(`image_encoder.blocks.{i}.attn.qkv`, `mask_decoder.transformer.layers.{i}
.cross_attn_token_to_image.q_proj`, …). Images and embeddings are
channels-last, (B, H, W, C), as the JAX package keeps them.

Three choices follow the JAX package, not the public `segment_anything`
source (ROADMAP C20-C22): the two-way blocks' LayerNorms use eps 1e-6
(official 1e-5), their MLP uses exact GELU (official ReLU), and
`SAMPredictor` squashes each [0, 1] image to img_size × img_size by
bilinear resize (no longest-side resize, pixel mean / std or pad).

`SAMPredictor.generate_masks` is the reference's over-segmentation
(planes/mask_generator.py:30-43,193): `num_prompts` random point prompts
drawn on the host by numpy's `default_rng(seed)`, the smallest mask of each
prompt whose stability is at least the threshold, then greedy mask NMS,
largest first. Stability and areas are read back once per prompt batch;
`nms_masks` takes every candidate pair's intersection in one fp32 product
on the candidates' device (exact: the counts stay below 2^24) and runs the
greedy pass on the host over that matrix. `sam_mask_generator` adapts the
predictor to `PlaneExcavator(mask_generator=…)`; its `.batch` encodes a
view stack in slabs of two.

`convert_torch_sam` is the JAX package's converter (official state dict →
the zoo's params tree), numpy only; `g4splat_torch.convert.sam_state_dict`
inverts it.

Spans and counters of the image encoder (`utils.profiling`, live only while
a profiler records): `g4s:sam.encode` around each encoder call,
`g4s:sam.attn.window` and `g4s:sam.attn.global` around the attention core
of a windowed or a global block (logits, both rel-pos terms, softmax and the
product with v; not `qkv` or `proj`), `g4s:sam.mlp` around each block's MLP;
the counters `sam.images` (images through the encoder) and
`sam.attn_logit_bytes` (bytes of the N × N logit buffers the attention core
allocates, from their shapes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from g4splat_torch.core.resize import resize_bilinear
from g4splat_torch.device import DeviceLike, fp32_math, resolve_device
from g4splat_torch.parallel.mesh import Replicas, map_over_data
from g4splat_torch.priors.vit import gelu_exact
from g4splat_torch.utils.profiling import annotate, annotated, count

LN_EPS = 1e-6       # every LayerNorm, the two-way blocks' too (official: 1e-5 there)
DOWNSCALING = "prompt_encoder.mask_downscaling."


@dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280         # ViT-H
    encoder_depth: int = 32
    encoder_heads: int = 16
    window_size: int = 14
    global_attn_every: int = 8
    embed_dim: int = 256            # neck / prompt / decoder dim
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attn_downsample: int = 2        # cross-attention channel downsample
    num_mask_tokens: int = 4        # 1 primary + 3 multimask


TINY_SAM = SAMConfig(
    img_size=64, patch_size=8, encoder_dim=32, encoder_depth=2,
    encoder_heads=2, window_size=4, global_attn_every=2, embed_dim=32,
    decoder_depth=2, decoder_heads=2, decoder_mlp_dim=64, attn_downsample=2,
)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of (B, C, H, W)."""

    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(gelu_exact(self.lin1(x)))


def _rel_pos_bias(q_hw: Tuple[int, int], rel_h, rel_w, q, heads):
    """Decomposed relative position bias (segment_anything
    image_encoder.py::add_decomposed_rel_pos, q and k grids equal, no
    interpolation). q: (B*, heads, N, hd) with N = h*w; rel_h (2h-1, hd),
    rel_w (2w-1, hd). Returns the two terms, (B*, heads, h, w, h, 1) and
    (B*, heads, h, w, 1, w): their sum, viewed as (B*, heads, N, N), is the
    bias. They are added to the logits one after the other, so that the
    full bias (16 × 4096² per view in a global block) is never held."""
    h, w = q_hw
    idx_h = torch.arange(h, device=q.device)
    idx_w = torch.arange(w, device=q.device)
    Rh = rel_h[idx_h[:, None] - idx_h[None, :] + (h - 1)]     # (h, h, hd)
    Rw = rel_w[idx_w[:, None] - idx_w[None, :] + (w - 1)]     # (w, w, hd)
    B = q.shape[0]
    rq = q.reshape(B, heads, h, w, -1)
    bias_h = torch.einsum("bnhwc,hkc->bnhwk", rq, Rh)
    bias_w = torch.einsum("bnhwc,wkc->bnhwk", rq, Rw)
    return bias_h[..., :, None], bias_w[..., None, :]


class EncoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, grid: Tuple[int, int], span: str):
        """span: the name of the attention core's span."""
        super().__init__()
        self.heads, self.grid, self.span = heads, grid, span
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * grid[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * grid[1] - 1, hd))

    def forward(self, x):
        """x: (B*, N, C), N = h*w."""
        B, N, C = x.shape
        hd = C // self.heads
        h, w = self.grid
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        with annotate(self.span):
            # One (B*, heads, N, N) buffer: logits, bias, then the softmax in
            # place (exp(l - max) / sum, as torch.softmax computes it).
            logits = (q @ k.transpose(-1, -2)).div_(math.sqrt(hd))
            count("sam.attn_logit_bytes", logits.numel() * logits.element_size())
            bias_h, bias_w = _rel_pos_bias((h, w), self.rel_pos_h, self.rel_pos_w, q, self.heads)
            logits.view(B, self.heads, h, w, h, w).add_(bias_h).add_(bias_w)
            logits.sub_(logits.amax(-1, keepdim=True)).exp_()
            logits.div_(logits.sum(-1, keepdim=True))
            out = logits @ v
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class WindowBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int):
        """window 0: global attention over the grid × grid tokens."""
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = (EncoderAttention(dim, heads, (window, window), "g4s:sam.attn.window")
                     if window else
                     EncoderAttention(dim, heads, (grid, grid), "g4s:sam.attn.global"))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x):
        """x: (B, H, W, C) token grid."""
        B, H, W, C = x.shape
        h = self.norm1(x)
        w = self.window
        if w > 0:
            ph, pw = (-H) % w, (-W) % w
            h = nn.functional.pad(h, (0, 0, 0, pw, 0, ph))
            Hp, Wp = H + ph, W + pw
            h = h.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
            att = self.attn(h.reshape(-1, w * w, C))
            att = att.reshape(B, Hp // w, Wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
            att = att.reshape(B, Hp, Wp, C)[:, :H, :W]
        else:
            att = self.attn(h.reshape(B, H * W, C)).reshape(B, H, W, C)
        x = x + att
        h = self.norm2(x)
        with annotate("g4s:sam.mlp"):
            h = self.mlp(h)
        return x + h


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        g = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.encoder_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.encoder_dim))
        self.blocks = nn.ModuleList(
            WindowBlock(cfg.encoder_dim, cfg.encoder_heads,
                        0 if (i + 1) % cfg.global_attn_every == 0 else cfg.window_size, g)
            for i in range(cfg.encoder_depth))
        D = cfg.embed_dim
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.encoder_dim, D, 1, bias=False), LayerNorm2d(D),
            nn.Conv2d(D, D, 3, padding=1, bias=False), LayerNorm2d(D))

    @annotated("g4s:sam.encode")
    def forward(self, x):
        """x: (B, H, W, 3) → (B, H/p, W/p, embed_dim)."""
        count("sam.images", x.shape[0])
        h = self.patch_embed(x)
        pos = self.pos_embed
        if h.shape[1:3] != pos.shape[1:3]:
            pos = resize_bilinear(pos, h.shape[1:3])
        h = h + pos
        for blk in self.blocks:
            h = blk(h)
        return self.neck(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def forward(self, coords):
        """coords (..., 2) in [0, 1] → (..., 2·num_pos_feats)."""
        proj = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig, mask_in_chans: int = 16):
        super().__init__()
        D = cfg.embed_dim
        self.pe_layer = PositionEmbeddingRandom(D // 2)
        # [0] negative, [1] positive; [2], [3] box corners (unused by points).
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, D) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, D)
        self.no_mask_embed = nn.Embedding(1, D)
        c = mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, 2, stride=2), LayerNorm2d(c // 4), nn.GELU(),
            nn.Conv2d(c // 4, c, 2, stride=2), LayerNorm2d(c), nn.GELU(),
            nn.Conv2d(c, D, 1))

    def forward(self, points, labels, grid: Tuple[int, int]):
        """points: (B, P, 2) xy in [0, 1]; labels: (B, P) 1 fg, 0 bg, -1 pad.
        Returns (sparse (B, P+1, D), dense PE grid (gh, gw, D), no-mask
        embedding (D,)); a (0, 0) not-a-point entry is appended, as
        segment_anything does when no box prompt is given."""
        B = points.shape[0]
        points = torch.cat([points, points.new_zeros(B, 1, 2)], dim=1)
        labels = torch.cat([labels, labels.new_full((B, 1), -1.0)], dim=1)
        sparse = self.pe_layer(points)
        lab = labels[..., None]
        sparse = torch.where(lab == -1, self.not_a_point_embed.weight[0], sparse)
        sparse = torch.where(lab == 0, sparse + self.point_embeddings[0].weight[0], sparse)
        sparse = torch.where(lab == 1, sparse + self.point_embeddings[1].weight[0], sparse)
        gh, gw = grid
        ys = (torch.arange(gh, dtype=points.dtype, device=points.device) + 0.5) / gh
        xs = (torch.arange(gw, dtype=points.dtype, device=points.device) + 0.5) / gw
        gxy = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)
        return sparse, self.pe_layer(gxy), self.no_mask_embed.weight[0]


class DownsampledAttention(nn.Module):
    """Separate q/k/v/out projections with channel downsampling
    (segment_anything transformer.py::Attention); plain softmax attention."""

    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        self.heads = heads
        ci = dim // downsample
        self.q_proj = nn.Linear(dim, ci)
        self.k_proj = nn.Linear(dim, ci)
        self.v_proj = nn.Linear(dim, ci)
        self.out_proj = nn.Linear(ci, dim)

    def forward(self, q, k, v):
        B, N, _ = q.shape
        M = k.shape[1]
        ci = self.q_proj.out_features
        hd = ci // self.heads
        qq = self.q_proj(q).reshape(B, N, self.heads, hd).transpose(1, 2)
        kk = self.k_proj(k).reshape(B, M, self.heads, hd).transpose(1, 2)
        vv = self.v_proj(v).reshape(B, M, self.heads, hd).transpose(1, 2)
        att = torch.softmax((qq @ kk.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        return self.out_proj((att @ vv).transpose(1, 2).reshape(B, N, ci))


class TwoWayBlock(nn.Module):
    """segment_anything transformer.py::TwoWayAttentionBlock, with the JAX
    package's eps 1e-6 LayerNorms and exact-GELU MLP (ROADMAP C20, C22)."""

    def __init__(self, cfg: SAMConfig, skip_first_layer_pe: bool = False):
        super().__init__()
        D, H = cfg.embed_dim, cfg.decoder_heads
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampledAttention(D, H)
        self.norm1 = nn.LayerNorm(D, eps=LN_EPS)
        self.cross_attn_token_to_image = DownsampledAttention(D, H, cfg.attn_downsample)
        self.norm2 = nn.LayerNorm(D, eps=LN_EPS)
        self.mlp = MLPBlock(D, cfg.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(D, eps=LN_EPS)
        self.cross_attn_image_to_token = DownsampledAttention(D, H, cfg.attn_downsample)
        self.norm4 = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        D = cfg.embed_dim
        self.layers = nn.ModuleList(TwoWayBlock(cfg, skip_first_layer_pe=(i == 0))
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DownsampledAttention(D, cfg.decoder_heads,
                                                              cfg.attn_downsample)
        self.norm_final_attn = nn.LayerNorm(D, eps=LN_EPS)


class MLP(nn.Module):
    """`layers.{0,1,2}`, ReLU between them."""

    def __init__(self, din: int, hidden: int, dout: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(din, hidden), nn.Linear(hidden, hidden),
                                     nn.Linear(hidden, dout)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < 2:
                x = torch.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        D, M = cfg.embed_dim, cfg.num_mask_tokens
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, D)
        self.mask_tokens = nn.Embedding(M, D)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(D, D // 4, 2, stride=2), LayerNorm2d(D // 4), nn.GELU(),
            nn.ConvTranspose2d(D // 4, D // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(D, D, D // 8) for _ in range(M))
        self.iou_prediction_head = MLP(D, D, M)

    def forward(self, img_embed, img_pe, sparse_prompt, dense_embed):
        """img_embed: (B, gh, gw, D); img_pe: (gh, gw, D); sparse_prompt:
        (B, P, D); dense_embed: (D,), broadcast over the grid. Returns
        (masks (B, M, 4·gh, 4·gw), iou (B, M))."""
        B, gh, gw, D = img_embed.shape
        M = self.mask_tokens.num_embeddings
        tok = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([tok.expand(B, -1, -1), sparse_prompt], dim=1)
        keys = (img_embed + dense_embed).reshape(B, gh * gw, D)
        pe = img_pe.reshape(1, gh * gw, D).expand(B, -1, -1)
        queries = tokens
        t = self.transformer
        for layer in t.layers:
            queries, keys = layer(queries, keys, tokens, pe)
        q, k = queries + tokens, keys + pe
        queries = t.norm_final_attn(queries + t.final_attn_token_to_image(q, k, keys))
        iou_tok, mask_toks = queries[:, 0], queries[:, 1:1 + M]
        up = self.output_upscaling(keys.transpose(1, 2).reshape(B, D, gh, gw))
        hyper = torch.stack([mlp(mask_toks[:, m])
                             for m, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = (hyper @ up.flatten(2)).reshape(B, M, 4 * gh, 4 * gw)
        return masks, self.iou_prediction_head(iou_tok)


class SAM(nn.Module):
    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, img):
        return self.image_encoder(img)

    def decode(self, img_embed, points, labels):
        sparse, dense_pe, no_mask = self.prompt_encoder(points, labels, img_embed.shape[1:3])
        return self.mask_decoder(img_embed, dense_pe, sparse, no_mask)

    def forward(self, img, points, labels):
        return self.decode(self.encode_image(img), points, labels)


@torch.no_grad()
def init_weights(model: SAM, generator: torch.Generator) -> None:
    """Seeded weights drawn from `generator`: linear and convolution weights
    and biases uniform in ±1/√fan_in (PyTorch's default bound), norms 1 and
    0, embeddings and the Fourier matrix N(0, 1), `pos_embed` and the
    rel-pos tables N(0, 0.02²) (not zero, so that they take part)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, PositionEmbeddingRandom):
            mod.positional_encoding_gaussian_matrix.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, EncoderAttention):
            mod.rel_pos_h.normal_(0.0, 0.02, generator=generator)
            mod.rel_pos_w.normal_(0.0, 0.02, generator=generator)
    model.image_encoder.pos_embed.normal_(0.0, 0.02, generator=generator)


# ----------------------------------------------------------- weight loading
def _lin(state, prefix):
    return {"kernel": np.asarray(state[prefix + ".weight"]).T,
            "bias": np.asarray(state[prefix + ".bias"])}


def _ln(state, prefix):
    return {"scale": np.asarray(state[prefix + ".weight"]),
            "bias": np.asarray(state[prefix + ".bias"])}


def _conv(state, prefix, bias=True):
    out = {"kernel": np.asarray(state[prefix + ".weight"]).transpose(2, 3, 1, 0)}
    if bias:
        out["bias"] = np.asarray(state[prefix + ".bias"])
    return out


def _deconv(state, prefix):
    # torch ConvTranspose2d (in, out, kh, kw) → flax (kh, kw, in, out) with a
    # spatial flip (flax's ConvTranspose is a direct lhs-dilated conv).
    w = np.asarray(state[prefix + ".weight"])
    return {"kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1].copy(),
            "bias": np.asarray(state[prefix + ".bias"])}


def _attn_ds(state, prefix):
    return {n: _lin(state, f"{prefix}.{n}") for n in
            ("q_proj", "k_proj", "v_proj", "out_proj")}


def _twoway_block(state, pre):
    blk = {
        "self_attn": _attn_ds(state, pre + "self_attn"),
        "cross_attn_token_to_image": _attn_ds(state, pre + "cross_attn_token_to_image"),
        "cross_attn_image_to_token": _attn_ds(state, pre + "cross_attn_image_to_token"),
        "mlp_lin1": _lin(state, pre + "mlp.lin1"),
        "mlp_lin2": _lin(state, pre + "mlp.lin2"),
    }
    for n in ("norm1", "norm2", "norm3", "norm4"):
        blk[n] = _ln(state, pre + n)
    return blk


def convert_torch_sam(state: Dict, cfg: SAMConfig = SAMConfig()) -> Dict:
    """Official `sam_vit_h` state dict (numpy values) → the params tree of the
    JAX package's npz zoo (`sam.npz`), array for array as the JAX package's
    `convert_torch_sam` builds it. The mask-prompt downscaling convolutions
    (`prompt_encoder.mask_downscaling.*`) are dropped."""
    enc = {
        "patch_embed": _conv(state, "image_encoder.patch_embed.proj"),
        "pos_embed": np.asarray(state["image_encoder.pos_embed"]),
        "neck_conv1": _conv(state, "image_encoder.neck.0", bias=False),
        "neck_ln1": _ln(state, "image_encoder.neck.1"),
        "neck_conv2": _conv(state, "image_encoder.neck.2", bias=False),
        "neck_ln2": _ln(state, "image_encoder.neck.3"),
    }
    for i in range(cfg.encoder_depth):
        pre = f"image_encoder.blocks.{i}."
        enc[f"block_{i}"] = {
            "norm1": _ln(state, pre + "norm1"),
            "norm2": _ln(state, pre + "norm2"),
            "attn": {
                "qkv": _lin(state, pre + "attn.qkv"),
                "proj": _lin(state, pre + "attn.proj"),
                "rel_pos_h": np.asarray(state[pre + "attn.rel_pos_h"]),
                "rel_pos_w": np.asarray(state[pre + "attn.rel_pos_w"]),
            },
            "mlp_fc1": _lin(state, pre + "mlp.lin1"),
            "mlp_fc2": _lin(state, pre + "mlp.lin2"),
        }

    prompt = {
        "pe_gaussian": np.asarray(
            state["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]),
        "point_embeddings": np.stack([
            np.asarray(state[f"prompt_encoder.point_embeddings.{i}.weight"])[0]
            for i in range(4)]),
        "not_a_point_embed": np.asarray(state["prompt_encoder.not_a_point_embed.weight"])[0],
        "no_mask_embed": np.asarray(state["prompt_encoder.no_mask_embed.weight"])[0],
    }
    dec = {
        "iou_token": np.asarray(state["mask_decoder.iou_token.weight"]),
        "mask_tokens": np.asarray(state["mask_decoder.mask_tokens.weight"]),
        "final_attn_token_to_image": _attn_ds(
            state, "mask_decoder.transformer.final_attn_token_to_image"),
        "norm_final_attn": _ln(state, "mask_decoder.transformer.norm_final_attn"),
        "up1": _deconv(state, "mask_decoder.output_upscaling.0"),
        "up_ln": _ln(state, "mask_decoder.output_upscaling.1"),
        "up2": _deconv(state, "mask_decoder.output_upscaling.3"),
    }
    for i in range(cfg.decoder_depth):
        dec[f"block_{i}"] = _twoway_block(state, f"mask_decoder.transformer.layers.{i}.")
    for m in range(cfg.num_mask_tokens):
        pre = f"mask_decoder.output_hypernetworks_mlps.{m}.layers"
        for j in range(3):
            dec[f"hyper_{m}_fc{j + 1}"] = _lin(state, f"{pre}.{j}")
    for j in range(3):
        dec[f"iou_fc{j + 1}"] = _lin(state, f"mask_decoder.iou_prediction_head.layers.{j}")

    return {"params": {"image_encoder": enc, "prompt_encoder": prompt, "mask_decoder": dec}}


# ---------------------------------------------------------------- prompting
def stability_score(logits: torch.Tensor, offset: float = 1.0) -> np.ndarray:
    """IoU between the masks at thresholds ±offset (segment_anything's
    stability score), (..., h, w) → float64 (...) on the host."""
    counts = torch.stack([(logits > offset).sum((-2, -1)),
                          (logits > -offset).sum((-2, -1))]).cpu().numpy()
    return counts[0] / np.maximum(counts[1], 1)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return inter / max(union, 1)


def select_candidates(logits: torch.Tensor, iou: torch.Tensor, stability_thresh: float,
                      select_smallest: bool = True) -> Tuple[torch.Tensor, List[int]]:
    """One prompt batch's candidates: per prompt, the smallest mask with
    stability ≥ the threshold and a non-empty area (or, without
    `select_smallest`, the mask of highest predicted IoU if it passes both),
    in prompt order. logits (n, M, h, w); returns the (k, h, w) bool masks
    on the logits' device and their areas."""
    n, M = logits.shape[:2]
    stab = stability_score(logits)
    areas = (logits > 0).sum((-2, -1)).cpu().numpy()
    best = iou.argmax(-1).cpu().numpy() if not select_smallest else None
    picks = []
    for bi in range(n):
        if select_smallest:
            valid = [m for m in range(M) if stab[bi, m] >= stability_thresh and areas[bi, m] > 0]
            if not valid:
                continue
            m = min(valid, key=lambda m: areas[bi, m])
        else:
            m = int(best[bi])
            if stab[bi, m] < stability_thresh or areas[bi, m] == 0:
                continue
        picks.append((bi, m))
    rows = torch.as_tensor([p[0] for p in picks], dtype=torch.long, device=logits.device)
    cols = torch.as_tensor([p[1] for p in picks], dtype=torch.long, device=logits.device)
    return logits[rows, cols] > 0, [int(areas[b, m]) for b, m in picks]


def nms_masks(masks: torch.Tensor, areas: List[int], iou_thresh: float) -> List[int]:
    """Greedy mask NMS, largest area first (a stable sort: ties keep the
    candidates' order), a candidate kept if its IoU with every kept one is
    below the threshold. masks (C, h, w) bool; returns the kept indices in
    that order. Every pair's intersection comes from one fp32 product of the
    0/1 masks (exact: the counts stay below 2^24); the IoUs are then
    inter / max(union, 1) in float64, as `mask_iou` computes them."""
    order = sorted(range(len(areas)), key=lambda i: -areas[i])
    if not order:
        return []
    flat = masks.reshape(len(areas), -1).to(torch.float32)
    with fp32_math():
        inter = (flat @ flat.T).to(torch.int64).cpu().numpy()
    a = np.asarray(areas, np.int64)
    iou = inter / np.maximum(a[:, None] + a[None, :] - inter, 1)
    kept: List[int] = []
    for i in order:
        if not kept or bool((iou[i, kept] < iou_thresh).all()):
            kept.append(i)
    return kept


def resize_nearest(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w) → (..., H, W) by `jax.image.resize(..., "nearest")`:
    half-pixel centres (`F.interpolate`'s "nearest-exact"), source index
    floor((i + 0.5) · h / H) computed in float32 as JAX computes it."""
    h, w = masks.shape[-2:]
    H, W = size

    def index(n, m):
        return ((torch.arange(n, dtype=torch.float32, device=masks.device) + 0.5) * m
                / n).floor().long()

    return masks[..., index(H, h), :][..., index(W, w)]


class SAMPredictor:
    """SAM on one device (the card unless `device` says otherwise), with the
    JAX package's encode and prompt entry points. `state_dict` holds the
    official names; without one the weights are seeded (`init_weights`)."""

    def __init__(self, cfg: SAMConfig = SAMConfig(), state_dict: Optional[Dict] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device("meta"):
            model = SAM(cfg)
        model = model.to_empty(device=dev)
        if state_dict is None:
            init_weights(model, torch.Generator(device=dev).manual_seed(seed))
        else:
            downscaling = {k for k in model.state_dict() if k.startswith(DOWNSCALING)}
            missing = set(model.state_dict()) - set(state_dict)
            unexpected = set(state_dict) - set(model.state_dict())
            assert not unexpected and missing in (set(), downscaling), (
                f"SAM state dict: missing {sorted(missing - downscaling)[:5]}, "
                f"unexpected {sorted(unexpected)[:5]}")
            model.load_state_dict(state_dict, strict=False)
            with torch.no_grad():       # the zoo drops them; never called
                for name, t in model.state_dict().items():
                    if name in missing:
                        t.zero_()
        self.model = model.eval()
        self._replicas = Replicas(self.model)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    @fp32_math()
    def _encode(self, img: torch.Tensor, model: Optional[nn.Module] = None) -> torch.Tensor:
        return (model or self.model).encode_image(img)

    @torch.no_grad()
    @fp32_math()
    def _decode(self, emb, points, labels):
        return self.model.decode(emb, points, labels)

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, device=self.device).to(torch.float32)

    def encode_images(self, images, mesh=None, max_batch: int = 2) -> torch.Tensor:
        """(V, H, W, 3) views in [0, 1] → (V, gh, gw, D) embeddings, one
        encoder call per slab of `max_batch` views per device: each ViT-H
        global block at 1024 px holds 16 × 4096² fp32 logits per view
        (1.07 GB). With a `parallel.mesh.DeviceMesh` the views split over its
        `data` entries (padded by repeating the last view), each entry running
        the model's copy on its device; the embeddings come back on the
        model's device."""
        imgs = self._images(images)
        S = self.cfg.img_size
        if mesh is not None and mesh.shape["data"] > 1:
            return map_over_data(
                mesh, lambda dev, x: self._encode(resize_bilinear(x, (S, S)),
                                                  self._replicas.on(dev)),
                imgs, per_device=max_batch)
        return torch.cat([self._encode(resize_bilinear(imgs[i:i + max_batch], (S, S)))
                          for i in range(0, len(imgs), max_batch)])

    def generate_masks(self, image, num_prompts: int = 256, stability_thresh: float = 0.85,
                       nms_iou: float = 0.8, select_smallest: bool = True, seed: int = 0,
                       prompt_batch: int = 64, emb: Optional[torch.Tensor] = None
                       ) -> List[np.ndarray]:
        """The reference's prompting (mask_generator.py:30-43,193) on one
        (H, W, 3) image in [0, 1] (`emb`: its precomputed (1, …) embedding):
        a list of (H, W) bool masks, largest first."""
        img = self._images(image)
        H, W = img.shape[:2]
        if emb is None:
            S = self.cfg.img_size
            emb = self._encode(resize_bilinear(img, (S, S))[None])
        pts = np.random.default_rng(seed).random((num_prompts, 2)).astype(np.float32)
        masks, areas = [], []
        for s in range(0, num_prompts, prompt_batch):
            batch = torch.from_numpy(pts[s:s + prompt_batch]).to(self.device)[:, None, :]
            n = batch.shape[0]
            logits, iou = self._decode(emb.expand(n, -1, -1, -1), batch,
                                       torch.ones(n, 1, device=self.device))
            m, a = select_candidates(logits, iou, stability_thresh, select_smallest)
            masks.append(m)
            areas += a
            del logits, iou
        masks = torch.cat(masks)
        kept = nms_masks(masks, areas, nms_iou)
        if not kept:
            return []
        return list(resize_nearest(masks[kept], (H, W)).cpu().numpy())


def sam_mask_generator(predictor: SAMPredictor, **kw) -> Callable:
    """Adapter for PlaneExcavator(mask_generator=…): image → masks. The
    callable also carries ``.batch(images, mesh=None)``: the encoder runs
    over the whole view stack in slabs (its views split over the mesh's
    `data` entries when one is given), prompting and NMS per view; the
    orchestrator uses it when present."""
    def gen(image) -> List[np.ndarray]:
        return predictor.generate_masks(image, **kw)

    def gen_batch(images, mesh=None) -> List[List[np.ndarray]]:
        embs = predictor.encode_images(images, mesh=mesh)
        return [predictor.generate_masks(images[v], emb=embs[v:v + 1], **kw)
                for v in range(len(images))]

    gen.batch = gen_batch
    return gen
