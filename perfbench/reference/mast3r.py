"""Plain PyTorch reference of MASt3R's pair inference and of the dense
mutual matching that MASt3R-SfM runs on its descriptors.

Written from the published code as G4Splat runs it (naver/croco
models/croco.py, blocks.py, pos_embed.py, dpt_block.py; naver/dust3r
model.py, heads/dpt_head.py, heads/postprocess.py; naver/mast3r model.py,
catmlp_dpt_head.py; MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric):

- a 16-pixel patch embedding (a strided convolution), then pre-LN blocks
  (LayerNorm ε 1e-6) of self-attention with 2D RoPE on queries and keys
  (RoPE2D: the first half of a head rotates by the token's row, the second
  by its column, each half as `rotate_half`, inverse frequencies
  base^(−2j/d)) and an exact-GELU MLP; the encoder's last LayerNorm;
- `decoder_embed`, then per block and per view: self-attention, cross-
  attention to the other view's tokens (of the previous block, normed by
  `norm_y`), MLP, each pre-LN and residual; the last block's output normed
  by `dec_norm`;
- per view a head: DPT (`DPTOutputAdapter_fix`) over the encoder's tokens
  and the decoder's blocks 6, 9 and 12 (`hooks_idx` [0, l/2, 3l/4, l] of
  [encoder] + blocks), and the local-feature MLP over [encoder ‖ last
  block] tokens with its pixel shuffle;
- the post-processing: points direction × expm1(norm), confidence 1 + exp,
  descriptors divided by their norm, descriptor confidence exp;
- matching: each query of image 1's `subsample`-pixel grid takes its
  nearest neighbour in image 2 (the largest dot product; the first on a
  tie), that neighbour takes its own in image 1, and the pair is a match
  when that is the query.

The network is a set of functions of a {name: tensor} dict under the
official checkpoint's key names; `shapes` lists every leaf, which is how
the benchmark lays out the seeded weights it hands to both sides. Every
product and convolution goes through a `precision.Ops`. Imports nothing of
the program.

Departures from the published code:
- the confidence and the descriptor confidence clamp their logit at 15
  before `exp`, as the measured program does; with the benchmark's seeded
  weights the logits stay far below it;
- MASt3R's `fast_reciprocal_NNs` starts from the grid and iterates the
  nearest-neighbour map until the queries converge, keeping the matches of
  converged points wherever they moved; here, as the measured program's
  `extract_correspondences` states, a grid query matches only when it is
  its own target's nearest neighbour (one round, grid points only);
- the align-corners resizes of the fusion blocks and of the head are
  `F.interpolate`; the decoder's cropping of refinenet4's output is kept
  and is a no-op when the token grid's sides are even.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Ops

P = Dict[str, torch.Tensor]
LN_EPS = 1e-6
CONF_LOGIT_MAX = 15.0
# Queries a block of the matching holds against all of the other image.
MATCH_BLOCK = 2048


# ------------------------------------------------------------- parameters
def _lin(out: OrderedDict, name: str, i: int, o: int):
    out[f"{name}.weight"] = (o, i)
    out[f"{name}.bias"] = (o,)


def _conv(out, name, i, o, k, bias=True):
    out[f"{name}.weight"] = (o, i, k, k)
    if bias:
        out[f"{name}.bias"] = (o,)


def _norm(out, name, c):
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


def _block(out, name, c, cross: bool):
    _norm(out, f"{name}.norm1", c)
    _lin(out, f"{name}.attn.qkv", c, 3 * c)
    _lin(out, f"{name}.attn.proj", c, c)
    if cross:
        for k in ("projq", "projk", "projv", "proj"):
            _lin(out, f"{name}.cross_attn.{k}", c, c)
    _norm(out, f"{name}.norm2", c)
    if cross:
        _norm(out, f"{name}.norm3", c)
    _lin(out, f"{name}.mlp.fc1", c, 4 * c)
    _lin(out, f"{name}.mlp.fc2", 4 * c, c)
    if cross:
        _norm(out, f"{name}.norm_y", c)


def _head(out, name, cfg: dict):
    enc, dec, f = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["dpt_features"]
    dims = cfg["dpt_layer_dims"]
    p = cfg["patch_size"]
    d = f"{name}.dpt"
    for i, c in enumerate(dims):
        _conv(out, f"{d}.scratch.layer{i + 1}_rn", c, f, 3, bias=False)
    for r in range(1, 5):
        _conv(out, f"{d}.scratch.refinenet{r}.out_conv", f, f, 1)
        for u in (1, 2):
            for k in (1, 2):
                _conv(out, f"{d}.scratch.refinenet{r}.resConfUnit{u}.conv{k}", f, f, 3)
    _conv(out, f"{d}.head.0", f, f // 2, 3)
    _conv(out, f"{d}.head.2", f // 2, f // 2, 3)
    _conv(out, f"{d}.head.4", f // 2, 4, 1)
    for i, (c_in, c) in enumerate(zip((enc, dec, dec, dec), dims)):
        _conv(out, f"{d}.act_postprocess.{i}.0", c_in, c, 1)
    # ConvTranspose2d weights are (in, out, k, k).
    out[f"{d}.act_postprocess.0.1.weight"] = (dims[0], dims[0], 4, 4)
    out[f"{d}.act_postprocess.0.1.bias"] = (dims[0],)
    out[f"{d}.act_postprocess.1.1.weight"] = (dims[1], dims[1], 2, 2)
    out[f"{d}.act_postprocess.1.1.bias"] = (dims[1],)
    _conv(out, f"{d}.act_postprocess.3.1", dims[3], dims[3], 3)
    cat = enc + dec
    _lin(out, f"{name}.head_local_features.fc1", cat, 4 * cat)
    _lin(out, f"{name}.head_local_features.fc2", 4 * cat,
         (cfg["local_feat_dim"] + int(cfg["two_confs"])) * p * p)


def shapes(cfg: dict) -> OrderedDict:
    """Every distinct leaf of AsymmetricMASt3R under its checkpoint key.
    The checkpoint also lists each head's `scratch.layer_rn.{i}.weight`,
    the same tensors as `scratch.layer{i+1}_rn.weight` (`aliases`)."""
    s: OrderedDict = OrderedDict()
    enc, dec, p = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["patch_size"]
    s["mask_token"] = (1, 1, dec)
    _conv(s, "patch_embed.proj", 3, enc, p)
    for i in range(cfg["enc_depth"]):
        _block(s, f"enc_blocks.{i}", enc, cross=False)
    _norm(s, "enc_norm", enc)
    _lin(s, "decoder_embed", enc, dec)
    for blocks in ("dec_blocks", "dec_blocks2"):
        for i in range(cfg["dec_depth"]):
            _block(s, f"{blocks}.{i}", dec, cross=True)
    _norm(s, "dec_norm", dec)
    for h in (1, 2):
        _head(s, f"downstream_head{h}", cfg)
    return s


def aliases(cfg: dict) -> Dict[str, str]:
    """Checkpoint keys that name the same tensor as another key."""
    return {f"downstream_head{h}.dpt.scratch.layer_rn.{i}.weight":
            f"downstream_head{h}.dpt.scratch.layer{i + 1}_rn.weight"
            for h in (1, 2) for i in range(len(cfg["dpt_layer_dims"]))}


def state_dict(w: P, cfg: dict) -> P:
    """The checkpoint's full key set: `w` with the aliases added."""
    out = dict(w)
    out.update({a: w[k] for a, k in aliases(cfg).items()})
    return out


# --------------------------------------------------------------- networks
def _sub(p: P, prefix: str) -> P:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def linear(p: P, name: str, x, ops: Ops):
    return ops.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def layer_norm(p: P, name: str, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def conv(p: P, name: str, x, ops: Ops, stride: int = 1, padding=None):
    w = p[f"{name}.weight"]
    return ops.conv2d(x, w, p.get(f"{name}.bias"), stride=stride,
                      padding=w.shape[-1] // 2 if padding is None else padding)


def conv_transpose(p: P, name: str, x, ops: Ops, stride: int):
    return F.conv_transpose2d(ops.r(x), ops.r(p[f"{name}.weight"]), p[f"{name}.bias"],
                              stride=stride)


def positions(b: int, gh: int, gw: int, device) -> torch.Tensor:
    """(B, gh·gw, 2) integer (row, column) of each token."""
    ys = torch.arange(gh, device=device).repeat_interleave(gw)
    xs = torch.arange(gw, device=device).repeat(gh)
    return torch.stack([ys, xs], -1)[None].expand(b, -1, -1)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def rope2d(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """RoPE2D of croco's pos_embed.py on (B, H, N, Dh) heads: the first half
    of a head by the rows, the second by the columns."""
    D = x.shape[-1] // 2
    inv = 1.0 / (base ** (torch.arange(0, D, 2, device=x.device).float() / D))
    t = torch.arange(int(pos.max()) + 1, device=x.device, dtype=torch.float32)
    freqs = torch.outer(t, inv)
    freqs = torch.cat((freqs, freqs), dim=-1)
    cos, sin = freqs.cos(), freqs.sin()

    def one(tok, p1):
        c = F.embedding(p1, cos)[:, None]
        s = F.embedding(p1, sin)[:, None]
        return tok * c + _rotate_half(tok) * s

    y, xx = x.chunk(2, dim=-1)
    return torch.cat((one(y, pos[:, :, 0]), one(xx, pos[:, :, 1])), dim=-1)


def attention(q, k, v, heads: int, pos_q, pos_k, base: float, ops: Ops):
    """(B, N, C) queries, (B, M, C) keys and values → (B, N, C): softmax
    attention per head with RoPE2D on queries and keys."""
    B, N, C = q.shape
    M = k.shape[1]
    dh = C // heads
    q = rope2d(q.reshape(B, N, heads, dh).transpose(1, 2), pos_q, base)
    k = rope2d(k.reshape(B, M, heads, dh).transpose(1, 2), pos_k, base)
    v = v.reshape(B, M, heads, dh).transpose(1, 2)
    a = torch.softmax(ops.matmul(q, k.transpose(-2, -1)) * dh ** -0.5, dim=-1)
    return ops.matmul(a, v).transpose(1, 2).reshape(B, N, C)


def mlp(p: P, name: str, x, ops: Ops):
    return linear(p, f"{name}.fc2", F.gelu(linear(p, f"{name}.fc1", x, ops)), ops)


def encoder_block(p: P, x, pos, heads: int, base: float, ops: Ops):
    h = layer_norm(p, "norm1", x)
    q, k, v = linear(p, "attn.qkv", h, ops).chunk(3, dim=-1)
    x = x + linear(p, "attn.proj", attention(q, k, v, heads, pos, pos, base, ops), ops)
    return x + mlp(p, "mlp", layer_norm(p, "norm2", x), ops)


def decoder_block(p: P, x, y, pos_x, pos_y, heads: int, base: float, ops: Ops):
    h = layer_norm(p, "norm1", x)
    q, k, v = linear(p, "attn.qkv", h, ops).chunk(3, dim=-1)
    x = x + linear(p, "attn.proj", attention(q, k, v, heads, pos_x, pos_x, base, ops), ops)
    y_ = layer_norm(p, "norm_y", y)
    q = linear(p, "cross_attn.projq", layer_norm(p, "norm2", x), ops)
    k = linear(p, "cross_attn.projk", y_, ops)
    v = linear(p, "cross_attn.projv", y_, ops)
    x = x + linear(p, "cross_attn.proj", attention(q, k, v, heads, pos_x, pos_y, base, ops),
                   ops)
    return x + mlp(p, "mlp", layer_norm(p, "norm3", x), ops)


def encode(w: P, img: torch.Tensor, cfg: dict, ops: Ops):
    """(B, H, W, 3) images → (tokens (B, N, C), positions, (gh, gw))."""
    x = conv(w, "patch_embed.proj", img.permute(0, 3, 1, 2), ops, stride=cfg["patch_size"],
             padding=0)
    gh, gw = x.shape[2], x.shape[3]
    x = x.flatten(2).transpose(1, 2)
    pos = positions(x.shape[0], gh, gw, x.device)
    for i in range(cfg["enc_depth"]):
        x = encoder_block(_sub(w, f"enc_blocks.{i}"), x, pos, cfg["enc_num_heads"],
                          cfg["rope_base"], ops)
    return layer_norm(w, "enc_norm", x), pos, (gh, gw)


def decode(w: P, f1, f2, pos1, pos2, cfg: dict, ops: Ops) -> Tuple[List, List]:
    """Each view's list [encoder tokens, block 1, …, block l (normed)]."""
    out1, out2 = [f1], [f2]
    d1, d2 = linear(w, "decoder_embed", f1, ops), linear(w, "decoder_embed", f2, ops)
    heads, base = cfg["dec_num_heads"], cfg["rope_base"]
    for i in range(cfg["dec_depth"]):
        d1, d2 = (decoder_block(_sub(w, f"dec_blocks.{i}"), d1, d2, pos1, pos2, heads, base, ops),
                  decoder_block(_sub(w, f"dec_blocks2.{i}"), d2, d1, pos2, pos1, heads, base,
                                ops))
        out1.append(d1)
        out2.append(d2)
    out1[-1] = layer_norm(w, "dec_norm", out1[-1])
    out2[-1] = layer_norm(w, "dec_norm", out2[-1])
    return out1, out2


def _rcu(p: P, name: str, x, ops: Ops):
    out = conv(p, f"{name}.conv1", F.relu(x), ops)
    return conv(p, f"{name}.conv2", F.relu(out), ops) + x


def _fusion(p: P, name: str, x, ops: Ops, skip=None):
    if skip is not None:
        x = x + _rcu(p, f"{name}.resConfUnit1", skip, ops)
    x = _rcu(p, f"{name}.resConfUnit2", x, ops)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    return conv(p, f"{name}.out_conv", x, ops)


def dpt(p: P, taps: List[torch.Tensor], grid, ops: Ops) -> torch.Tensor:
    """DPTOutputAdapter_fix: 4 × (B, N, C_i) tokens → (B, 4, gh·p', gw·p')."""
    gh, gw = grid
    x = [t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw) for t in taps]
    x = [conv(p, f"act_postprocess.{i}.0", t, ops) for i, t in enumerate(x)]
    x[0] = conv_transpose(p, "act_postprocess.0.1", x[0], ops, 4)
    x[1] = conv_transpose(p, "act_postprocess.1.1", x[1], ops, 2)
    x[3] = conv(p, "act_postprocess.3.1", x[3], ops, stride=2)
    x = [conv(p, f"scratch.layer{i + 1}_rn", t, ops) for i, t in enumerate(x)]
    path = _fusion(p, "scratch.refinenet4", x[3], ops)[:, :, :x[2].shape[2], :x[2].shape[3]]
    path = _fusion(p, "scratch.refinenet3", path, ops, x[2])
    path = _fusion(p, "scratch.refinenet2", path, ops, x[1])
    path = _fusion(p, "scratch.refinenet1", path, ops, x[0])
    out = conv(p, "head.0", path, ops)
    out = F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=True)
    out = F.relu(conv(p, "head.2", out, ops))
    return conv(p, "head.4", out, ops)


def head(p: P, enc_tokens, dec_out: List[torch.Tensor], grid, cfg: dict, ops: Ops) -> P:
    """Cat_MLP_LocalFeatures_DPT_Pts3d and its post-processing."""
    gh, gw = grid
    l = cfg["dec_depth"]
    taps = [dec_out[0]] + [dec_out[i] for i in (l * 2 // 4, l * 3 // 4, l)]
    pts = dpt(_sub(p, "dpt"), taps, grid, ops)
    cat = torch.cat([enc_tokens, dec_out[-1]], dim=-1)
    loc = mlp(p, "head_local_features", cat, ops)
    B = loc.shape[0]
    loc = F.pixel_shuffle(loc.transpose(-1, -2).reshape(B, -1, gh, gw), cfg["patch_size"])
    fmap = torch.cat([pts, loc], dim=1).permute(0, 2, 3, 1)
    xyz = fmap[..., 0:3]
    d = xyz.norm(dim=-1, keepdim=True)
    D = cfg["local_feat_dim"]
    desc = fmap[..., 4:4 + D]
    return {"pts3d": xyz / d.clip(min=1e-8) * torch.expm1(d),
            "conf": 1.0 + fmap[..., 3].clamp(max=CONF_LOGIT_MAX).exp(),
            "desc": desc / desc.norm(dim=-1, keepdim=True),
            "desc_conf": fmap[..., 4 + D].clamp(max=CONF_LOGIT_MAX).exp()}


def forward(w: P, img1, img2, cfg: dict, ops: Ops) -> Tuple[P, P]:
    """AsymmetricMASt3R on (B, H, W, 3) image batches: each view's head
    outputs, both in image 1's frame."""
    f1, pos1, grid = encode(w, img1, cfg, ops)
    f2, pos2, _ = encode(w, img2, cfg, ops)
    o1, o2 = decode(w, f1, f2, pos1, pos2, cfg, ops)
    return (head(_sub(w, "downstream_head1"), f1, o1, grid, cfg, ops),
            head(_sub(w, "downstream_head2"), f2, o2, grid, cfg, ops))


# --------------------------------------------------------------- matching
def _nearest(a: torch.Tensor, b: torch.Tensor, ops: Ops) -> torch.Tensor:
    """For each row of `a`, the index of the row of `b` with the largest dot
    product (the first on a tie), by blocks of `MATCH_BLOCK` rows."""
    return torch.cat([torch.argmax(ops.matmul(a[i:i + MATCH_BLOCK], b.T), dim=1)
                      for i in range(0, a.shape[0], MATCH_BLOCK)])


def grid_matches(desc1: torch.Tensor, desc2: torch.Tensor, subsample: int, ops: Ops):
    """Mutual nearest neighbours of (H, W, D) descriptor maps on image 1's
    `subsample`-pixel grid. Returns (grid queries (Q,), their nearest pixel
    of image 2 (Q,), whether each is mutual (Q,)), as flat pixel indices."""
    H1, W1, D = desc1.shape
    a, b = desc1.reshape(-1, D), desc2.reshape(-1, D)
    ys = torch.arange(0, H1, subsample, device=a.device)
    xs = torch.arange(0, W1, subsample, device=a.device)
    q = (ys[:, None] * W1 + xs[None, :]).reshape(-1)
    t = _nearest(a[q], b, ops)
    back = _nearest(b[t], a, ops)
    return q, t, back == q
