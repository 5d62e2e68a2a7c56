"""Floating-point operations of MASt3R's pair stage, from its sizes: the
numerator of `mfu_pct.mast3r`.

Only products and convolutions are counted, 2 operations a multiply-add,
as `torch.utils.flop_counter` counts them (norms, softmax, GELU and the
resizes are left out). What the inputs need, not what a program may
repeat: each image of a set is encoded once, each ordered pair is decoded
once and gets both heads once, and the matching of a pair takes, for each
query of image 1's grid, one row of products against every pixel of image
2 and one more from its target back against every pixel of image 1.

Per image of N = (H/p)·(W/p) tokens:
- encoder: the patch embedding 2·N·C·3p², and per block 24·N·C² (qkv 6,
  projection 2, MLP 16) + 4·N²·C (the two attention products);
- decoder, per view and block of width c: 32·N·c² (self qkv 6 and
  projection 2; cross q, k, v, projection 8; MLP 16) + 8·N²·c (two
  attentions of N by N), and `decoder_embed` 2·N·C·c;
- head: the DPT's 1×1 projections, transposed convolutions, the 3×3 stride-
  2 convolution, the four 3×3 `layer_rn`, per fusion block two or four 3×3
  convolutions at its input's size and the 1×1 `out_conv` at twice that,
  the head's 3×3 convolutions at half and at full resolution and its 1×1;
  the local-feature MLP 2·N·(C+c)·4(C+c) + 2·N·4(C+c)·(d+1)·p².
"""

from __future__ import annotations

from typing import Dict


def _grid(cfg: dict, height: int, width: int):
    p = cfg["patch_size"]
    return height // p, width // p


def encoder_flops(cfg: dict, height: int, width: int) -> float:
    gh, gw = _grid(cfg, height, width)
    N, C, p = gh * gw, cfg["enc_embed_dim"], cfg["patch_size"]
    return 2.0 * N * C * 3 * p * p + cfg["enc_depth"] * (24.0 * N * C * C + 4.0 * N * N * C)


def decoder_flops(cfg: dict, height: int, width: int) -> float:
    """Both views of one ordered pair."""
    gh, gw = _grid(cfg, height, width)
    N, C, c = gh * gw, cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    per_view = 2.0 * N * C * c + cfg["dec_depth"] * (32.0 * N * c * c + 8.0 * N * N * c)
    return 2 * per_view


def _conv(hw: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * hw * c_in * c_out * k * k


def head_flops(cfg: dict, height: int, width: int) -> float:
    """One head on one image."""
    gh, gw = _grid(cfg, height, width)
    N = gh * gw
    C, c, f = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["dpt_features"]
    d = cfg["dpt_layer_dims"]
    p = cfg["patch_size"]
    # Resolutions of the four levels: ×4, ×2, ×1, ×½ of the token grid.
    hw = [16 * N, 4 * N, N, (-(-gh // 2)) * (-(-gw // 2))]
    ops = sum(_conv(N, c_in, d_i, 1) for c_in, d_i in zip((C, c, c, c), d))
    ops += 2.0 * N * d[0] * d[0] * 16 + 2.0 * N * d[1] * d[1] * 4     # transposed
    ops += _conv(hw[3], d[3], d[3], 3)                                  # stride 2
    ops += sum(_conv(hw[i], d[i], f, 3) for i in range(4))              # layer_rn
    # refinenet4 (one residual unit) then 3, 2, 1 (two each); out_conv ×2.
    for level, units in ((3, 1), (2, 2), (1, 2), (0, 2)):
        ops += units * 2 * _conv(hw[level], f, f, 3) + _conv(4 * hw[level], f, f, 1)
    full = height * width
    ops += _conv(full // 4, f, f // 2, 3) + _conv(full, f // 2, f // 2, 3)
    ops += _conv(full, f // 2, 4, 1)
    cat = C + c
    n_out = (cfg["local_feat_dim"] + int(cfg["two_confs"])) * p * p
    ops += 2.0 * N * cat * 4 * cat + 2.0 * N * 4 * cat * n_out
    return ops


def matching_flops(cfg: dict, height: int, width: int, subsample: int) -> float:
    """One pair: each grid query against image 2, its target against
    image 1."""
    q = (-(-height // subsample)) * (-(-width // subsample))
    return 2 * 2.0 * q * height * width * cfg["local_feat_dim"]


def set_flops(cfg: dict, views: int, height: int, width: int, subsample: int) -> Dict[str, float]:
    """The work one set of `views` images needs through exhaustive pairs."""
    pairs = views * (views - 1) // 2
    out = {"encoder": views * encoder_flops(cfg, height, width),
           "decoder": 2 * pairs * decoder_flops(cfg, height, width),
           "heads": 2 * pairs * 2 * head_flops(cfg, height, width),
           "matching": pairs * matching_flops(cfg, height, width, subsample)}
    out["total"] = sum(out.values())
    return out
