"""Plain PyTorch reference of one See3D inpaint call: the CLIP context, the
SD VAE, the MVDream SD-2.1 multi-view UNet with 9 input channels, the
warp-mix DDIM loop with classifier-free guidance, and the decode.

Written from the published architectures and the See3D pipeline
(mv_unet.py:42-1003, pipeline_mvd_warp_mix_classifier.py:27-700, diffusers'
AutoencoderKL and DDIMScheduler, OpenCLIP ViT-H/14) as functions of a flat
{name: tensor} parameter dict whose names are the checkpoints' keys.
`shapes` lists every parameter, which is how the benchmark lays out the
seeded weights it hands to both sides. Attention is exact softmax
attention computed in blocks of queries. Every product and convolution goes
through a `precision.Ops`. Imports nothing of the program.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import Ops

P = Dict[str, torch.Tensor]
SD_SCALE = 0.18215
BOS_ID, EOS_ID = 49406, 49407
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# Logits a block of queries may hold.
BLOCK_LOGITS = 1 << 28


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


def unet_shapes(cfg: dict) -> OrderedDict:
    """MultiViewUNetModel (mv_unet.py:614-1003) under its checkpoint keys."""
    s: OrderedDict = OrderedDict()
    mc = cfg["model_channels"]
    emb = 4 * mc
    _lin(s, "time_embed.0", mc, emb)
    _lin(s, "time_embed.2", emb, emb)
    if cfg["camera_dim"] is not None:
        _lin(s, "camera_embed.0", cfg["camera_dim"], emb)
        _lin(s, "camera_embed.2", emb, emb)

    def res(name, i, o):
        _norm(s, f"{name}.in_layers.0", i)
        _conv(s, f"{name}.in_layers.2", i, o, 3)
        _lin(s, f"{name}.emb_layers.1", emb, o)
        _norm(s, f"{name}.out_layers.0", o)
        _conv(s, f"{name}.out_layers.3", o, o, 3)
        if i != o:
            _conv(s, f"{name}.skip_connection", i, o, 1)

    def transformer(name, ch):
        inner = ch  # heads · 64 = ch
        _norm(s, f"{name}.norm", ch)
        _lin(s, f"{name}.proj_in", ch, inner)
        for d in range(cfg["transformer_depth"]):
            b = f"{name}.transformer_blocks.{d}"
            for a, ctx in (("attn1", inner), ("attn2", cfg["context_dim"])):
                _lin(s, f"{b}.{a}.to_q", inner, inner, False)
                _lin(s, f"{b}.{a}.to_k", ctx, inner, False)
                _lin(s, f"{b}.{a}.to_v", ctx, inner, False)
                _lin(s, f"{b}.{a}.to_out.0", inner, inner)
                if a == "attn1":
                    _lin(s, f"{b}.ff.net.0.proj", inner, 8 * inner)
                    _lin(s, f"{b}.ff.net.2", 4 * inner, inner)
            for n in (1, 2, 3):
                _norm(s, f"{b}.norm{n}", inner)
        _lin(s, f"{name}.proj_out", inner, ch)

    _conv(s, "input_blocks.0.0", cfg["in_channels"], mc, 3)
    chans, ch, ds, blk = [mc], mc, 1, 1
    mult = cfg["channel_mult"]
    for level, m in enumerate(mult):
        for _ in range(cfg["num_res_blocks"]):
            res(f"input_blocks.{blk}.0", ch, mc * m)
            ch = mc * m
            if ds in cfg["attention_resolutions"]:
                transformer(f"input_blocks.{blk}.1", ch)
            chans.append(ch)
            blk += 1
        if level != len(mult) - 1:
            _conv(s, f"input_blocks.{blk}.0.op", ch, ch, 3)
            chans.append(ch)
            ds *= 2
            blk += 1
    res("middle_block.0", ch, ch)
    transformer("middle_block.1", ch)
    res("middle_block.2", ch, ch)
    blk = 0
    for level, m in reversed(list(enumerate(mult))):
        for i in range(cfg["num_res_blocks"] + 1):
            res(f"output_blocks.{blk}.0", ch + chans.pop(), mc * m)
            ch = mc * m
            j = 1
            if ds in cfg["attention_resolutions"]:
                transformer(f"output_blocks.{blk}.1", ch)
                j = 2
            if level and i == cfg["num_res_blocks"]:
                _conv(s, f"output_blocks.{blk}.{j}.conv", ch, ch, 3)
                ds //= 2
            blk += 1
    _norm(s, "out.0", ch)
    _conv(s, "out.2", ch, cfg["out_channels"], 3)
    return s


def vae_shapes(cfg: dict) -> OrderedDict:
    """diffusers AutoencoderKL under its keys."""
    s: OrderedDict = OrderedDict()
    base, mult, z = cfg["base_ch"], cfg["ch_mult"], cfg["z_ch"]

    def resnet(name, i, o):
        _norm(s, f"{name}.norm1", i)
        _conv(s, f"{name}.conv1", i, o, 3)
        _norm(s, f"{name}.norm2", o)
        _conv(s, f"{name}.conv2", o, o, 3)
        if i != o:
            _conv(s, f"{name}.conv_shortcut", i, o, 1)

    def mid(name, c):
        resnet(f"{name}.resnets.0", c, c)
        _norm(s, f"{name}.attentions.0.group_norm", c)
        for k in ("to_q", "to_k", "to_v", "to_out.0"):
            _lin(s, f"{name}.attentions.0.{k}", c, c)
        resnet(f"{name}.resnets.1", c, c)

    _conv(s, "encoder.conv_in", 3, base, 3)
    ch = base
    for i, m in enumerate(mult):
        o = base * m
        resnet(f"encoder.down_blocks.{i}.resnets.0", ch, o)
        resnet(f"encoder.down_blocks.{i}.resnets.1", o, o)
        if i != len(mult) - 1:
            _conv(s, f"encoder.down_blocks.{i}.downsamplers.0.conv", o, o, 3)
        ch = o
    mid("encoder.mid_block", ch)
    _norm(s, "encoder.conv_norm_out", ch)
    _conv(s, "encoder.conv_out", ch, 2 * z, 3)
    rev = list(reversed(mult))
    ch = base * rev[0]
    _conv(s, "decoder.conv_in", z, ch, 3)
    mid("decoder.mid_block", ch)
    for i, m in enumerate(rev):
        o = base * m
        for j in range(3):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", ch if j == 0 else o, o)
        if i != len(rev) - 1:
            _conv(s, f"decoder.up_blocks.{i}.upsamplers.0.conv", o, o, 3)
        ch = o
    _norm(s, "decoder.conv_norm_out", ch)
    _conv(s, "decoder.conv_out", ch, 3, 3)
    _conv(s, "quant_conv", 2 * z, 2 * z, 1)
    _conv(s, "post_quant_conv", z, z, 1)
    return s


def clip_vision_shapes(cfg: dict) -> OrderedDict:
    s: OrderedDict = OrderedDict()
    d, p = cfg["embed_dim"], cfg["patch_size"]
    s["patch_embed.weight"] = (d, 3, p, p)
    s["class_embedding"] = (d,)
    s["pos_embed"] = ((cfg["image_size"] // p) ** 2 + 1, d)
    _norm(s, "pre_ln", d)
    for i in range(cfg["depth"]):
        _norm(s, f"blocks.{i}.norm1", d)
        _lin(s, f"blocks.{i}.attn.qkv", d, 3 * d)
        _lin(s, f"blocks.{i}.attn.proj", d, d)
        _norm(s, f"blocks.{i}.norm2", d)
        _lin(s, f"blocks.{i}.mlp.fc1", d, 4 * d)
        _lin(s, f"blocks.{i}.mlp.fc2", 4 * d, d)
    _norm(s, "post_ln", d)
    _lin(s, "visual_projection", d, cfg["projection_dim"], False)
    return s


def clip_text_shapes(cfg: dict) -> OrderedDict:
    s: OrderedDict = OrderedDict()
    w = cfg["width"]
    s["token_embedding"] = (cfg["vocab_size"], w)
    s["pos_embed"] = (cfg.get("max_positions") or cfg["n_ctx"], w)
    for i in range(cfg["depth"]):
        _norm(s, f"blocks.{i}.norm1", w)
        _lin(s, f"blocks.{i}.attn.qkv", w, 3 * w)
        _lin(s, f"blocks.{i}.attn.proj", w, w)
        _norm(s, f"blocks.{i}.norm2", w)
        _lin(s, f"blocks.{i}.fc1", w, 4 * w)
        _lin(s, f"blocks.{i}.fc2", 4 * w, w)
    _norm(s, "final_ln", w)
    return s


def shapes(models: dict) -> OrderedDict:
    """Every parameter of the four networks, prefixed by network."""
    out: OrderedDict = OrderedDict()
    for prefix, fn in (("unet", unet_shapes), ("vae", vae_shapes),
                       ("clip_vision", clip_vision_shapes), ("clip_text", clip_text_shapes)):
        for k, v in fn(models[prefix]).items():
            out[f"{prefix}.{k}"] = v
    return out


# ------------------------------------------------------------------ layers
def _sub(p: P, prefix: str) -> P:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def linear(p: P, name: str, x, ops: Ops):
    return ops.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def conv(p: P, name: str, x, ops: Ops, stride: int = 1, padding: int = 1):
    return ops.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride=stride,
                      padding=padding)


def group_norm(p: P, name: str, x, eps: float, groups: int = 32):
    return F.group_norm(x, min(groups, x.shape[1]), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def layer_norm(p: P, name: str, x, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def attention(q, k, v, ops: Ops, causal: bool = False):
    """softmax(q kᵀ / √D) v for (B, N, H, D) queries and (B, M, H, D) keys
    and values, in blocks of queries."""
    B, N, H, D = q.shape
    M = k.shape[1]
    kt = k.permute(0, 2, 3, 1)                       # (B, H, D, M)
    vt = v.permute(0, 2, 1, 3)                       # (B, H, M, D)
    step = max(1, min(N, BLOCK_LOGITS // max(1, B * H * M)))
    out = []
    for n0 in range(0, N, step):
        qb = q[:, n0:n0 + step].permute(0, 2, 1, 3)  # (B, H, n, D)
        s = ops.matmul(qb, kt) / math.sqrt(D)
        if causal:
            rows = torch.arange(n0, n0 + qb.shape[2], device=q.device)[:, None]
            s = s.masked_fill(torch.arange(M, device=q.device)[None] > rows, float("-inf"))
        out.append(ops.matmul(torch.softmax(s, dim=-1), vt))
    return torch.cat(out, 2).permute(0, 2, 1, 3)


# -------------------------------------------------------------------- UNet
def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _resblock(p, name, x, emb, ops):
    h = conv(p, f"{name}.in_layers.2", F.silu(group_norm(p, f"{name}.in_layers.0", x, 1e-5)), ops)
    e = linear(p, f"{name}.emb_layers.1", F.silu(emb), ops)[:, :, None, None]
    h = F.silu(group_norm(p, f"{name}.out_layers.0", h + e, 1e-5))
    h = conv(p, f"{name}.out_layers.3", h, ops)
    skip = f"{name}.skip_connection.weight"
    return (conv(p, f"{name}.skip_connection", x, ops, padding=0) if skip in p else x) + h


def _cross(p, name, x, ctx, ops, heads):
    B, N, C = x.shape
    M = ctx.shape[1]
    q = linear(p, f"{name}.to_q", x, ops).reshape(B, N, heads, -1)
    k = linear(p, f"{name}.to_k", ctx, ops).reshape(B, M, heads, -1)
    v = linear(p, f"{name}.to_v", ctx, ops).reshape(B, M, heads, -1)
    return linear(p, f"{name}.to_out.0", attention(q, k, v, ops).reshape(B, N, -1), ops)


def _transformer(p, name, x, ctx, n_frames, ops, head_dim, depth):
    B, C, H, W = x.shape
    heads = C // head_dim
    h = group_norm(p, f"{name}.norm", x, 1e-6).permute(0, 2, 3, 1).reshape(B, H * W, C)
    h = linear(p, f"{name}.proj_in", h, ops)
    for d in range(depth):
        b = f"{name}.transformer_blocks.{d}"
        bf, L, c = h.shape
        n = layer_norm(p, f"{b}.norm1", h, 1e-6).reshape(bf // n_frames, n_frames * L, c)
        h = h + _cross(p, f"{b}.attn1", n, n, ops, heads).reshape(bf, L, c)
        h = h + _cross(p, f"{b}.attn2", layer_norm(p, f"{b}.norm2", h, 1e-6), ctx, ops, heads)
        a, gate = linear(p, f"{b}.ff.net.0.proj", layer_norm(p, f"{b}.norm3", h, 1e-6),
                         ops).chunk(2, dim=-1)
        h = h + linear(p, f"{b}.ff.net.2", a * F.gelu(gate), ops)
    h = linear(p, f"{name}.proj_out", h, ops)
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def unet(p: P, x, t, ctx, n_frames: int, cfg: dict, ops: Ops):
    """(B·F, 9, h, w) inputs, (B·F,) timesteps, (B·F, 77, C) context →
    (B·F, 4, h, w); the blocks in `unet_shapes`' order."""
    hd, depth = cfg["num_head_channels"], cfg["transformer_depth"]
    attn_at, nrb, mult = cfg["attention_resolutions"], cfg["num_res_blocks"], cfg["channel_mult"]
    emb = linear(p, "time_embed.2", F.silu(linear(
        p, "time_embed.0", timestep_embedding(t, cfg["model_channels"]), ops)), ops)

    def block(name, h, ds):
        h = _resblock(p, f"{name}.0", h, emb, ops)
        if ds in attn_at:
            h = _transformer(p, f"{name}.1", h, ctx, n_frames, ops, hd, depth)
        return h

    h = conv(p, "input_blocks.0.0", x, ops)
    hs, ds, blk = [h], 1, 1
    for level in range(len(mult)):
        for _ in range(nrb):
            h = block(f"input_blocks.{blk}", h, ds)
            hs.append(h)
            blk += 1
        if level != len(mult) - 1:
            h = conv(p, f"input_blocks.{blk}.0.op", h, ops, stride=2)
            hs.append(h)
            ds *= 2
            blk += 1
    h = _resblock(p, "middle_block.0", h, emb, ops)
    h = _transformer(p, "middle_block.1", h, ctx, n_frames, ops, hd, depth)
    h = _resblock(p, "middle_block.2", h, emb, ops)
    blk = 0
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            h = block(f"output_blocks.{blk}", torch.cat([h, hs.pop()], dim=1), ds)
            if level and i == nrb:
                j = 2 if ds in attn_at else 1
                h = conv(p, f"output_blocks.{blk}.{j}.conv",
                         F.interpolate(h, scale_factor=2.0, mode="nearest"), ops)
                ds //= 2
            blk += 1
    return conv(p, "out.2", F.silu(group_norm(p, "out.0", h, 1e-5)), ops)


# --------------------------------------------------------------------- VAE
def _vae_resnet(p, name, x, ops):
    h = conv(p, f"{name}.conv1", F.silu(group_norm(p, f"{name}.norm1", x, 1e-6)), ops)
    h = conv(p, f"{name}.conv2", F.silu(group_norm(p, f"{name}.norm2", h, 1e-6)), ops)
    if f"{name}.conv_shortcut.weight" in p:
        x = conv(p, f"{name}.conv_shortcut", x, ops, padding=0)
    return x + h


def _vae_mid(p, name, x, ops):
    x = _vae_resnet(p, f"{name}.resnets.0", x, ops)
    a = f"{name}.attentions.0"
    B, C, H, W = x.shape
    h = group_norm(p, f"{a}.group_norm", x, 1e-6).permute(0, 2, 3, 1).reshape(B, H * W, C)
    q, k, v = (linear(p, f"{a}.{n}", h, ops)[:, :, None] for n in ("to_q", "to_k", "to_v"))
    h = linear(p, f"{a}.to_out.0", attention(q, k, v, ops)[:, :, 0], ops)
    x = x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return _vae_resnet(p, f"{name}.resnets.1", x, ops)


def vae_encode(p: P, x, ops: Ops):
    """(B, 3, H, W) in [-1, 1] → the scaled latent mean (B, 4, H/8, W/8)."""
    h = conv(p, "encoder.conv_in", x, ops)
    i = 0
    while f"encoder.down_blocks.{i}.resnets.0.conv1.weight" in p:
        for j in range(2):
            h = _vae_resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h, ops)
        ds = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if f"{ds}.weight" in p:
            h = conv(p, ds, F.pad(h, (0, 1, 0, 1)), ops, stride=2, padding=0)
        i += 1
    h = _vae_mid(p, "encoder.mid_block", h, ops)
    h = conv(p, "encoder.conv_out", F.silu(group_norm(p, "encoder.conv_norm_out", h, 1e-6)), ops)
    mean, _ = conv(p, "quant_conv", h, ops, padding=0).chunk(2, dim=1)
    return mean * SD_SCALE


def vae_decode(p: P, z, ops: Ops):
    h = conv(p, "post_quant_conv", z / SD_SCALE, ops, padding=0)
    h = _vae_mid(p, "decoder.mid_block", conv(p, "decoder.conv_in", h, ops), ops)
    i = 0
    while f"decoder.up_blocks.{i}.resnets.0.conv1.weight" in p:
        for j in range(3):
            h = _vae_resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, ops)
        us = f"decoder.up_blocks.{i}.upsamplers.0.conv"
        if f"{us}.weight" in p:
            h = conv(p, us, F.interpolate(h, scale_factor=2.0, mode="nearest"), ops)
        i += 1
    return conv(p, "decoder.conv_out", F.silu(group_norm(p, "decoder.conv_norm_out", h, 1e-6)),
                ops)


# -------------------------------------------------------------------- CLIP
def _vit_block(p, name, x, heads, eps, ops, causal, mlp):
    B, N, C = x.shape
    q, k, v = linear(p, f"{name}.attn.qkv", layer_norm(p, f"{name}.norm1", x, eps),
                     ops).reshape(B, N, 3, heads, C // heads).unbind(2)
    x = x + linear(p, f"{name}.attn.proj", attention(q, k, v, ops, causal).reshape(B, N, C), ops)
    h = layer_norm(p, f"{name}.norm2", x, eps)
    return x + linear(p, f"{name}.{mlp[1]}", F.gelu(linear(p, f"{name}.{mlp[0]}", h, ops)), ops)


def clip_image_context(p: P, image, cfg: dict, ops: Ops, n_tokens: int = 77,
                       scale: float = 0.2):
    """(H, W, 3) image in [0, 1] → (1, n_tokens, P): `scale` × the projected
    class token, tiled over the prompt positions."""
    x = image.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    x = (x - mean) / std
    h = ops.conv2d(x, p["patch_embed.weight"], stride=cfg["patch_size"])
    h = h.flatten(2).transpose(1, 2)
    h = torch.cat([p["class_embedding"].expand(1, 1, -1), h], dim=1) + p["pos_embed"][None]
    h = layer_norm(p, "pre_ln", h, 1e-6)
    for i in range(cfg["depth"]):
        h = _vit_block(p, f"blocks.{i}", h, cfg["num_heads"], 1e-6, ops, False,
                       ("mlp.fc1", "mlp.fc2"))
    h = layer_norm(p, "post_ln", h, 1e-6)
    proj = linear(p, "visual_projection", h[:, 0], ops)
    return scale * proj[:, None, :].repeat(1, n_tokens, 1)


def clip_text_context(p: P, cfg: dict, ops: Ops, device):
    """The empty prompt's last hidden state, (1, n_ctx, width)."""
    ids = torch.zeros((1, cfg["n_ctx"]), dtype=torch.long, device=device)
    ids[0, 0], ids[0, 1] = BOS_ID, EOS_ID
    x = p["token_embedding"][ids] + p["pos_embed"][None, :cfg["n_ctx"]]
    for i in range(cfg["depth"]):
        x = _vit_block(p, f"blocks.{i}", x, cfg["num_heads"], 1e-5, ops, True, ("fc1", "fc2"))
    return layer_norm(p, "final_ln", x, 1e-5)


# -------------------------------------------------------------------- DDIM
class DDIM:
    """Scaled-linear betas with the zero-terminal-SNR rescale, trailing
    timesteps, v-prediction, eta 0 (diffusers DDIMScheduler as See3D sets it)."""

    def __init__(self, cfg: dict, device):
        n = cfg["num_train_timesteps"]
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n) ** 2
        ac = np.cumprod(1.0 - betas)
        s = np.sqrt(ac)
        s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
        self.ac = torch.as_tensor((s ** 2).astype(np.float32), device=device)
        step = (n - 1) // cfg["num_steps"]
        self.timesteps = [int(t) for t in np.round(np.arange(n - 1, 0, -step))]
        self.step_size = n // cfg["num_steps"]
        self.guidance = cfg["guidance_scale"]

    def a(self, t: int):
        return self.ac[t] if t >= 0 else torch.ones((), device=self.ac.device)

    def step(self, v, t: int, x):
        a_t, a_p = self.a(t), self.a(t - self.step_size)
        x0 = torch.sqrt(a_t) * x - torch.sqrt(1 - a_t) * v
        eps = torch.sqrt(a_t) * v + torch.sqrt(1 - a_t) * x
        return torch.sqrt(a_p) * x0 + torch.sqrt(1 - a_p) * eps


def decay_weight(t: int) -> float:
    """The warp-mix weight (pipeline_mvd_warp_mix_classifier.py:27-51)."""
    t = float(t)
    if t >= 60.0:
        w = 1.0 - (1.0 - 0.8) * (200.0 - t) / (200.0 - 60.0)
    else:
        w = 0.8 * math.exp(-0.075 * (60.0 - t))
    return min(max(w, 0.0), 1.0)


def unet_input(z, masks, x, t: int, eps, gt_num: int, ddim: DDIM):
    """The UNet's input at timestep t: [cond frames | uncond frames], each
    [latents | warp mix | mask]; reference frames pinned to their clean
    latents; the warp mix re-noised at t // 5."""
    Fn = z.shape[0]
    gt = (torch.arange(Fn, device=z.device) < gt_num).to(torch.float32)[:, None, None, None]
    x = gt * z + (1 - gt) * x
    tv = t // 5
    noisy = torch.sqrt(ddim.a(tv)) * z + torch.sqrt(1 - ddim.a(tv)) * eps
    w = decay_weight(tv)
    mix = gt * z + (1 - gt) * (w * noisy + (1 - w) * x)
    return torch.cat([torch.cat([x, mix, masks], 1), torch.cat([x, gt * z, gt * masks], 1)])


def guided_step(out, t: int, x, gt_num: int, z, ddim: DDIM):
    """CFG (1 + s)·cond − s·uncond, then one DDIM step of the pinned state."""
    Fn = x.shape[0]
    s = ddim.guidance
    gt = (torch.arange(Fn, device=z.device) < gt_num).to(torch.float32)[:, None, None, None]
    x = gt * z + (1 - gt) * x
    return ddim.step((1 + s) * out[:Fn] - s * out[Fn:], t, x)


class Weights:
    """The four networks' parameter dicts, split from one {name: tensor}."""

    def __init__(self, params: P):
        self.all = params
        self.unet, self.vae = _sub(params, "unet"), _sub(params, "vae")
        self.clip_vision, self.clip_text = _sub(params, "clip_vision"), _sub(params, "clip_text")

    @staticmethod
    def from_flat(flat: torch.Tensor, layout: OrderedDict) -> "Weights":
        """Views of one flat buffer, laid out in `layout`'s order."""
        params, off = {}, 0
        for name, shape in layout.items():
            n = int(np.prod(shape))
            params[name] = flat[off:off + n].view(shape)
            off += n
        return Weights(params)


def inpaint(w: Weights, models: dict, refs, warps, masks, noise_fn, ops: Ops,
            capture: Optional[Sequence[int]] = None) -> dict:
    """One whole call, the first of a stage: refs (R, H, W, 3), warps (W, H,
    W, 3), masks (W, H, W) at the model's resolution; noise_fn(0, latent
    shape, steps) gives (x_T, [one per timestep]). Returns the output images and, for the steps in
    `capture`, what the program's hooks capture: {"ctx", "z", "inp": {k: ..},
    "out": {k: ..}, "final", "images"}."""
    ddim = DDIM(models["ddim"], refs.device)
    R = refs.shape[0]
    ctx = clip_image_context(w.clip_vision, refs[0], models["clip_vision"], ops)
    ctx = ctx + clip_text_context(w.clip_text, models["clip_text"], ops, refs.device)
    frames = torch.cat([refs, warps])
    z = vae_encode(w.vae, frames.permute(0, 3, 1, 2) * 2.0 - 1.0, ops)
    f = frames.shape[1] // z.shape[2]
    m = torch.cat([torch.ones_like(masks[:1]).expand(R, -1, -1), masks])[:, None, ::f, ::f]
    Fn = frames.shape[0]
    ctx2 = ctx.repeat(2 * Fn, 1, 1)
    x_T, step_noise = noise_fn(0, tuple(z.shape), len(ddim.timesteps))
    x = x_T
    cap = {"ctx": ctx, "z": z, "inp": {}, "out": {}}
    for k, (t, eps) in enumerate(zip(ddim.timesteps, step_noise)):
        inp = unet_input(z, m, x, t, eps, R, ddim)
        tv = torch.full((2 * Fn,), t, dtype=torch.int64, device=z.device)
        out = unet(w.unet, inp, tv, ctx2, Fn, models["unet"], ops)
        if capture is not None and k in capture:
            cap["inp"][k], cap["out"][k] = inp, out
        x = guided_step(out, t, x, R, z, ddim)
    gt = (torch.arange(Fn, device=z.device) < R).to(torch.float32)[:, None, None, None]
    final = (gt * z + (1 - gt) * x)[R:]
    dec = vae_decode(w.vae, final, ops)
    cap["final"] = final
    cap["images"] = torch.clamp((dec + 1.0) / 2.0, 0, 1).permute(0, 2, 3, 1)
    return cap
