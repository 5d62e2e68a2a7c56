"""Plain PyTorch reference of Segment Anything's image encoder.

Written from the published code as G4Splat runs it (facebookresearch/
segment-anything modeling/image_encoder.py, common.py, build_sam.py::
build_sam_vit_h; checkpoint `sam_vit_h_4b8939`):

- `PatchEmbed`: a 16-pixel strided convolution, channels last;
- an absolute `pos_embed` added to the token grid;
- `Block`: pre-LN (LayerNorm ε 1e-6, as `build_sam` sets it); in a
  windowed block `window_partition` pads the normed grid with zeros on the
  bottom and right to a multiple of the window (64 → 70 at 14) and the pad
  tokens take part as keys; `Attention` scales q by head_dim^-½, adds
  `add_decomposed_rel_pos` (the unscaled q against `rel_pos_h` and
  `rel_pos_w`, each gathered at q − k + size − 1) to the logits, softmax,
  product with v, `proj`; `window_unpartition` crops the pad; residual; an
  MLP of `lin1`, exact GELU, `lin2` on the unpadded grid; residual;
- global attention over the whole grid in the blocks of
  `global_attn_indexes` (7, 15, 23, 31 in ViT-H), windowed in the rest;
- the neck: 1×1 convolution, `LayerNorm2d` (ε 1e-6), 3×3 convolution,
  `LayerNorm2d`, no biases in the convolutions.

The network is a set of functions of a {name: tensor} dict under the
official checkpoint's key names; `shapes` lists every leaf of `sam_vit_h`
(the prompt encoder's and the mask decoder's too, so that the program loads
the whole checkpoint), which is how the benchmark lays out the seeded
weights it hands to both sides. Every product and convolution goes through
a `precision.Ops`. Global attention runs head by head, so that a view's
logits stay at one 4096² buffer. Imports nothing of the program.

Departures from the published code:
- the input is `squash`: each [0, 1] image resized to img_size × img_size
  by half-pixel-centre bilinear interpolation without antialiasing, which
  is the measured program's documented stand-in (ROADMAP C21) for
  `ResizeLongestSide`, the pixel mean and std and the bottom-right pad of
  `Sam.preprocess`; where both sides of the image grow, as at 512 × 384 to
  1024², the program's antialiased resize computes the same weights. The
  encoder's input is img_size², so its work is the published one;
- `get_rel_pos` is taken without its interpolation branch: q and k grids
  are equal and the tables have the published 2·size − 1 rows.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Ops

P = Dict[str, torch.Tensor]
LN_EPS = 1e-6
MASK_IN_CHANS = 16      # PromptEncoder's mask_in_chans in build_sam


# ------------------------------------------------------------- parameters
def _lin(out: OrderedDict, name: str, i: int, o: int, bias: bool = True):
    out[f"{name}.weight"] = (o, i)
    if bias:
        out[f"{name}.bias"] = (o,)


def _conv(out, name, i, o, k, bias=True):
    out[f"{name}.weight"] = (o, i, k, k)
    if bias:
        out[f"{name}.bias"] = (o,)


def _norm(out, name, c):
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


def _attn_ds(out, name, d, ci):
    for k in ("q_proj", "k_proj", "v_proj"):
        _lin(out, f"{name}.{k}", d, ci)
    _lin(out, f"{name}.out_proj", ci, d)


def _mlp3(out, name, i, h, o):
    for j, (a, b) in enumerate(((i, h), (h, h), (h, o))):
        _lin(out, f"{name}.layers.{j}", a, b)


def shapes(cfg: dict) -> OrderedDict:
    """Every leaf of `sam_vit_h` under its checkpoint key."""
    s: OrderedDict = OrderedDict()
    C, p, D = cfg["encoder_dim"], cfg["patch_size"], cfg["embed_dim"]
    g = cfg["img_size"] // p
    hd = C // cfg["encoder_heads"]
    e = "image_encoder"
    s[f"{e}.pos_embed"] = (1, g, g, C)
    _conv(s, f"{e}.patch_embed.proj", 3, C, p)
    for i in range(cfg["encoder_depth"]):
        b = f"{e}.blocks.{i}"
        size = g if i in cfg["global_attn_indexes"] else cfg["window_size"]
        _norm(s, f"{b}.norm1", C)
        s[f"{b}.attn.rel_pos_h"] = (2 * size - 1, hd)
        s[f"{b}.attn.rel_pos_w"] = (2 * size - 1, hd)
        _lin(s, f"{b}.attn.qkv", C, 3 * C)
        _lin(s, f"{b}.attn.proj", C, C)
        _norm(s, f"{b}.norm2", C)
        _lin(s, f"{b}.mlp.lin1", C, 4 * C)
        _lin(s, f"{b}.mlp.lin2", 4 * C, C)
    _conv(s, f"{e}.neck.0", C, D, 1, bias=False)
    _norm(s, f"{e}.neck.1", D)
    _conv(s, f"{e}.neck.2", D, D, 3, bias=False)
    _norm(s, f"{e}.neck.3", D)

    pe = "prompt_encoder"
    s[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = (2, D // 2)
    for i in range(4):
        s[f"{pe}.point_embeddings.{i}.weight"] = (1, D)
    s[f"{pe}.not_a_point_embed.weight"] = (1, D)
    s[f"{pe}.no_mask_embed.weight"] = (1, D)
    c = MASK_IN_CHANS
    _conv(s, f"{pe}.mask_downscaling.0", 1, c // 4, 2)
    _norm(s, f"{pe}.mask_downscaling.1", c // 4)
    _conv(s, f"{pe}.mask_downscaling.3", c // 4, c, 2)
    _norm(s, f"{pe}.mask_downscaling.4", c)
    _conv(s, f"{pe}.mask_downscaling.6", c, D, 1)

    md = "mask_decoder"
    ci = D // cfg["attn_downsample"]
    for i in range(cfg["decoder_depth"]):
        L = f"{md}.transformer.layers.{i}"
        _attn_ds(s, f"{L}.self_attn", D, D)
        _norm(s, f"{L}.norm1", D)
        _attn_ds(s, f"{L}.cross_attn_token_to_image", D, ci)
        _norm(s, f"{L}.norm2", D)
        _lin(s, f"{L}.mlp.lin1", D, cfg["decoder_mlp_dim"])
        _lin(s, f"{L}.mlp.lin2", cfg["decoder_mlp_dim"], D)
        _norm(s, f"{L}.norm3", D)
        _attn_ds(s, f"{L}.cross_attn_image_to_token", D, ci)
        _norm(s, f"{L}.norm4", D)
    _attn_ds(s, f"{md}.transformer.final_attn_token_to_image", D, ci)
    _norm(s, f"{md}.transformer.norm_final_attn", D)
    M = cfg["num_mask_tokens"]
    s[f"{md}.iou_token.weight"] = (1, D)
    s[f"{md}.mask_tokens.weight"] = (M, D)
    # ConvTranspose2d weights are (in, out, k, k).
    s[f"{md}.output_upscaling.0.weight"] = (D, D // 4, 2, 2)
    s[f"{md}.output_upscaling.0.bias"] = (D // 4,)
    _norm(s, f"{md}.output_upscaling.1", D // 4)
    s[f"{md}.output_upscaling.3.weight"] = (D // 4, D // 8, 2, 2)
    s[f"{md}.output_upscaling.3.bias"] = (D // 8,)
    for m in range(M):
        _mlp3(s, f"{md}.output_hypernetworks_mlps.{m}", D, D, D // 8)
    # iou_head_hidden_dim: 256 in build_sam, which is embed_dim there.
    _mlp3(s, f"{md}.iou_prediction_head", D, D, M)
    return s


# ---------------------------------------------------------------- network
def squash(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] → (B, 3, size, size): half-pixel-centre
    bilinear, no antialiasing."""
    return F.interpolate(images.permute(0, 3, 1, 2).float(), size=(size, size),
                         mode="bilinear", align_corners=False)


def layer_norm(x: torch.Tensor, w: P, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def layer_norm_2d(x: torch.Tensor, w: P, name: str) -> torch.Tensor:
    """common.py::LayerNorm2d over the channels of (B, C, H, W)."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + LN_EPS)
    return w[f"{name}.weight"][:, None, None] * x + w[f"{name}.bias"][:, None, None]


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) → (B·nw, ws, ws, C) windows of the grid padded with
    zeros to (Hp, Wp), a multiple of ws."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous() if Hp > H or Wp > W else x


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(size, size, hd): the table's row q − k + size − 1 for each (q, k)."""
    coords = torch.arange(size, device=rel_pos.device)
    return rel_pos[(coords[:, None] - coords[None, :] + (size - 1)).long()]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, hw: Tuple[int, int], ops: Ops) -> torch.Tensor:
    """attn (B, h·w, h·w) plus the terms of q (B, h·w, hd) against the
    height and width tables."""
    h, w = hw
    Rh, Rw = get_rel_pos(h, rel_pos_h), get_rel_pos(w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, h, w, dim)
    rel_h = ops.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = ops.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.view(B, h, w, h, w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.view(B, h * w, h * w)


def _attend(q, k, v, rel_h, rel_w, hw, ops: Ops) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    attn = ops.matmul(q * scale, k.transpose(-2, -1))
    attn = add_decomposed_rel_pos(attn, q, rel_h, rel_w, hw, ops)
    return ops.matmul(attn.softmax(dim=-1), v)


def attention(x: torch.Tensor, w: P, name: str, heads: int, ops: Ops,
              per_head: bool) -> torch.Tensor:
    """image_encoder.py::Attention on (B, H, W, C); `per_head` computes one
    head's logits at a time."""
    B, H, W, C = x.shape
    qkv = ops.linear(x, w[f"{name}.qkv.weight"], w[f"{name}.qkv.bias"])
    qkv = qkv.reshape(B, H * W, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
    rel_h, rel_w = w[f"{name}.rel_pos_h"], w[f"{name}.rel_pos_w"]
    if per_head:
        out = torch.cat([_attend(q[i:i + 1], k[i:i + 1], v[i:i + 1], rel_h, rel_w, (H, W), ops)
                         for i in range(B * heads)])
    else:
        out = _attend(q, k, v, rel_h, rel_w, (H, W), ops)
    out = out.view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
    return ops.linear(out, w[f"{name}.proj.weight"], w[f"{name}.proj.bias"])


def block(x: torch.Tensor, w: P, name: str, cfg: dict, windowed: bool, ops: Ops) -> torch.Tensor:
    shortcut = x
    x = layer_norm(x, w, f"{name}.norm1")
    ws = cfg["window_size"]
    if windowed:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, ws)
    x = attention(x, w, f"{name}.attn", cfg["encoder_heads"], ops, per_head=not windowed)
    if windowed:
        x = window_unpartition(x, ws, pad_hw, (H, W))
    x = shortcut + x
    h = layer_norm(x, w, f"{name}.norm2")
    h = ops.linear(F.gelu(ops.linear(h, w[f"{name}.mlp.lin1.weight"], w[f"{name}.mlp.lin1.bias"])),
                   w[f"{name}.mlp.lin2.weight"], w[f"{name}.mlp.lin2.bias"])
    return x + h


def image_encoder(w: P, images: torch.Tensor, cfg: dict, ops: Ops,
                  keep: Sequence[int] = ()) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """(B, H, W, 3) images in [0, 1] → the neck's (B, embed_dim, g, g) and
    the tokens (B, g, g, C) after each block of `keep`, one view at a time."""
    e = "image_encoder"
    necks, kept = [], {i: [] for i in keep}
    for b in range(images.shape[0]):
        x = squash(images[b:b + 1], cfg["img_size"])
        x = ops.conv2d(x, w[f"{e}.patch_embed.proj.weight"], w[f"{e}.patch_embed.proj.bias"],
                       stride=cfg["patch_size"]).permute(0, 2, 3, 1)
        x = x + w[f"{e}.pos_embed"]
        for i in range(cfg["encoder_depth"]):
            x = block(x, w, f"{e}.blocks.{i}", cfg, i not in cfg["global_attn_indexes"], ops)
            if i in kept:
                kept[i].append(x)
        x = ops.conv2d(x.permute(0, 3, 1, 2), w[f"{e}.neck.0.weight"])
        x = layer_norm_2d(x, w, f"{e}.neck.1")
        x = ops.conv2d(x, w[f"{e}.neck.2.weight"], padding=1)
        necks.append(layer_norm_2d(x, w, f"{e}.neck.3"))
    return torch.cat(necks), {i: torch.cat(v) for i, v in kept.items()}

