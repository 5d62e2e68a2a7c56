"""Work of exact attention (kernel B3) from its shapes: 4·B·H·N·M·D
operations (the two products), q, k and v read once and the output written
once, in float32; and the launches of one See3D UNet call."""

from __future__ import annotations

from typing import List, Tuple

from perfbench.counts.peaks import TF32_FLOPS, least_time

Shape = Tuple[int, int, int, int, int]   # (B, N, M, H, D)


def attention_work(B: int, N: int, M: int, H: int, D: int):
    return 4.0 * B * H * N * M * D, 4.0 * (2 * B * N * H * D + 2 * B * M * H * D)


def least_s(shape: Shape) -> float:
    """Against dense TF32: no arithmetic accurate to float32 runs faster on
    this card."""
    return least_time(*attention_work(*shape), TF32_FLOPS)


def unet_launches(cfg: dict, frames: int, branches: int, latent: int, n_ctx: int) -> List[Shape]:
    """The attention calls of one MV-UNet call over `branches` × `frames`
    frames of latent² tokens: per transformer block a joint self-attention
    over all frames of a branch and a per-frame cross-attention to the
    context."""
    mult, nrb, at = cfg["channel_mult"], cfg["num_res_blocks"], cfg["attention_resolutions"]
    hd, mc = cfg["num_head_channels"], cfg["model_channels"]
    blocks = []
    for level, m in enumerate(mult):
        if 2 ** level in at:
            blocks += [(level, mc * m)] * (nrb + (nrb + 1))
    blocks.append((len(mult) - 1, mc * mult[-1]))                      # the middle block
    out = []
    for level, ch in blocks:
        side = latent // 2 ** level
        for _ in range(cfg["transformer_depth"]):
            out.append((branches, frames * side * side, frames * side * side, ch // hd, hd))
            out.append((branches * frames, side * side, n_ctx, ch // hd, hd))
    return out
