"""Work of SAM's image encoder from its sizes: the numerators of
`mfu_pct.sam` and `attn_roofline.sam`.

Only products and convolutions are counted, 2 operations a multiply-add,
as `torch.utils.flop_counter` counts them (norms, softmax, GELU, the resize
and the rel-pos gathers are left out). The published work: a windowed
block's `qkv` and `proj` and its attention run on the grid padded to a
multiple of the window (70² tokens at 64² and 14), as the published model
computes them; its MLP runs on the unpadded grid.

Per view of g² tokens, width C, h heads of d = C/h, windows of w²:
- the patch embedding 2·g²·C·3p²;
- a windowed block 8·T·C² (qkv 6, proj 2) on the T padded tokens, 16·g²·C²
  (MLP), and per window 4·h·w⁴·d (the two products) + 2·h·w²·2w·d (the
  rel-pos terms, q against the height and the width tables);
- a global block 24·g²·C² and 4·h·g⁴·d + 2·h·g²·2g·d;
- the neck: 2·g²·C·D (1×1) + 2·g²·D·D·9 (3×3).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.counts.attention import attention_work
from perfbench.counts.peaks import TF32_FLOPS, least_time


def _sizes(cfg: dict):
    g = cfg["img_size"] // cfg["patch_size"]
    w = cfg["window_size"]
    gp = -(-g // w) * w
    return g, w, gp, cfg["encoder_dim"], cfg["encoder_heads"]


def attention_calls(cfg: dict, views: int) -> List[Tuple[Tuple[int, int, int, int, int], int]]:
    """Each block's attention core over `views` images: ((B, N, M, H, D),
    the grid side of its rel-pos terms), in block order."""
    g, w, gp, C, h = _sizes(cfg)
    d = C // h
    out = []
    for i in range(cfg["encoder_depth"]):
        if i in cfg["global_attn_indexes"]:
            out.append(((views, g * g, g * g, h, d), g))
        else:
            out.append(((views * (gp // w) ** 2, w * w, w * w, h, d), w))
    return out


def _rel_pos(shape, side: int) -> Tuple[float, float]:
    """Operations of the rel-pos terms and the bytes of their two tables."""
    B, N, _, H, D = shape
    return 2.0 * B * H * N * 2 * side * D, 4.0 * 2 * (2 * side - 1) * D


def attention_flops(cfg: dict, views: int) -> float:
    return sum(attention_work(*s)[0] + _rel_pos(s, side)[0]
               for s, side in attention_calls(cfg, views))


def attention_least_s(cfg: dict, views: int) -> float:
    """The least time of every attention core of an encoder call over
    `views` images, each against dense TF32 (no arithmetic accurate to
    float32 runs faster on this card): q, k and v read and the output
    written once, the rel-pos terms' tables read once."""
    total = 0.0
    for s, side in attention_calls(cfg, views):
        ops, nbytes = attention_work(*s)
        rops, rbytes = _rel_pos(s, side)
        total += least_time(ops + rops, nbytes + rbytes, TF32_FLOPS)
    return total


def view_flops(cfg: dict) -> Dict[str, float]:
    """The work of one view through the encoder, by part."""
    g, w, gp, C, h = _sizes(cfg)
    p, D = cfg["patch_size"], cfg["embed_dim"]
    n_global = sum(1 for i in range(cfg["encoder_depth"]) if i in cfg["global_attn_indexes"])
    n_window = cfg["encoder_depth"] - n_global
    out = {"patch_embed": 2.0 * g * g * C * 3 * p * p,
           "linears": (n_window * (8.0 * gp * gp * C * C + 16.0 * g * g * C * C)
                       + n_global * 24.0 * g * g * C * C),
           "attention": attention_flops(cfg, 1),
           "neck": 2.0 * g * g * C * D + 2.0 * g * g * D * D * 9}
    out["total"] = sum(out.values())
    return out
