"""MASt3R two-view geometry network (counterpart of
`g4splat_tpu.priors.mast3r`).

AsymmetricMASt3R: a CroCo ViT-L/16 encoder with 2D RoPE shared by both
images, two ViT-B cross-attention decoders (one per image, weights
independent) and per-image heads that give
- dense 3D points in image 1's frame (direction × expm1 of the norm),
- a confidence 1 + exp,
- L2-normalised local descriptors and a descriptor confidence (the Cat-MLP
  head: an MLP over [encoder ‖ last decoder] tokens and a pixel shuffle).

Module names are the reference checkpoint's (`tests/fixtures/
mast3r_vitl_keys.json`), so a reference state dict loads with
`load_state_dict(strict=True)`; `mask_token` is kept for that and unused.
Images go in as (B, H, W, 3), H and W multiples of the patch size, as the
JAX package feeds them. `MASt3RModel` runs pair batches under `fp32_math`
and without gradients; `reciprocal_nn_matches` / `extract_correspondences`
match descriptors densely by blocks, never holding the full similarity.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from g4splat_torch.device import DeviceLike, fp32_math, resolve_device
from g4splat_torch.priors.dpt import DPTOutputAdapter
from g4splat_torch.priors.vit import LN_EPS, Block, DecoderBlock, Mlp, PatchEmbed, grid_positions


class MASt3RConfig(NamedTuple):
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    local_feat_dim: int = 24
    rope_base: float = 100.0
    dpt_features: int = 256
    # CroCo's dpt_block.py layer dims, not DepthAnything's.
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    two_confs: bool = True


TINY_CONFIG = MASt3RConfig(
    patch_size=16, enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
    dec_embed_dim=48, dec_depth=2, dec_num_heads=2, local_feat_dim=8,
    dpt_features=32, dpt_layer_dims=(8, 16, 24, 32),
)


class CatMLPDPTHead(nn.Module):
    """pts3d and conf by DPT over [encoder, three decoder taps]; local
    descriptors by an MLP over [encoder ‖ last decoder tap] and a pixel
    shuffle."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = cfg
        enc, dec = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.dpt = DPTOutputAdapter((enc, dec, dec, dec), cfg.dpt_features, cfg.dpt_layer_dims,
                                    cfg.patch_size, head_out=4)
        cat = enc + dec
        n_out = (cfg.local_feat_dim + int(cfg.two_confs)) * cfg.patch_size ** 2
        self.head_local_features = Mlp(cat, 4 * cat, n_out)

    def forward(self, enc_tokens, dec_taps, grid) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        gh, gw = grid
        p = cfg.patch_size
        dpt = self.dpt([enc_tokens] + list(dec_taps), grid).permute(0, 2, 3, 1)
        feats = self.head_local_features(torch.cat([enc_tokens, dec_taps[-1]], -1))
        B = feats.shape[0]
        C = cfg.local_feat_dim + int(cfg.two_confs)
        # Pixel shuffle: (B, gh, gw, C·p·p) → (B, gh·p, gw·p, C).
        feats = (feats.reshape(B, gh, gw, C, p, p).permute(0, 1, 4, 2, 5, 3)
                 .reshape(B, gh * p, gw * p, C))
        xyz = dpt[..., :3]
        d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        pts3d = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
        conf = 1.0 + torch.exp(torch.clamp(dpt[..., 3], max=15.0))
        desc = feats[..., :cfg.local_feat_dim]
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        # desc_conf_mode ('exp', 0, inf) of the released checkpoints: exp, no +1.
        desc_conf = (torch.exp(torch.clamp(feats[..., -1], max=15.0)) if cfg.two_confs
                     else conf)
        return {"pts3d": pts3d, "conf": conf, "desc": desc, "desc_conf": desc_conf}


class AsymmetricMASt3R(nn.Module):
    def __init__(self, cfg: MASt3RConfig = MASt3RConfig()):
        super().__init__()
        self.cfg = cfg
        enc, dec = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dec))
        self.patch_embed = PatchEmbed(cfg.patch_size, enc)
        self.enc_blocks = nn.ModuleList(
            Block(enc, cfg.enc_num_heads, 4.0, use_rope=True, rope_base=cfg.rope_base)
            for _ in range(cfg.enc_depth))
        self.enc_norm = nn.LayerNorm(enc, eps=LN_EPS)
        self.decoder_embed = nn.Linear(enc, dec)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(dec, cfg.dec_num_heads, 4.0, use_rope=True, rope_base=cfg.rope_base)
            for _ in range(cfg.dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(dec, cfg.dec_num_heads, 4.0, use_rope=True, rope_base=cfg.rope_base)
            for _ in range(cfg.dec_depth))
        self.dec_norm = nn.LayerNorm(dec, eps=LN_EPS)
        self.downstream_head1 = CatMLPDPTHead(cfg)
        self.downstream_head2 = CatMLPDPTHead(cfg)

    def encode(self, img: torch.Tensor):
        """(B, H, W, 3) → (tokens (B, N, C), positions (B, N, 2), (gh, gw))."""
        x, (gh, gw) = self.patch_embed(img)
        pos = grid_positions(x.shape[0], gh, gw, x.device)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos, (gh, gw)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        """Two (B, H, W, 3) batches → per-image head dicts; pts3d of both
        heads live in image 1's camera frame. Both images ride one encoder
        pass."""
        cfg = self.cfg
        B = img1.shape[0]
        f, pos, grid = self.encode(torch.cat([img1, img2]))
        f1, f2, pos1, pos2 = f[:B], f[B:], pos[:B], pos[B:]
        d1, d2 = self.decoder_embed(f1), self.decoder_embed(f2)
        outs1, outs2 = [], []
        for i, (b1, b2) in enumerate(zip(self.dec_blocks, self.dec_blocks2)):
            d1, d2 = b1(d1, d2, pos1, pos2), b2(d2, d1, pos2, pos1)
            last = i == cfg.dec_depth - 1
            outs1.append(self.dec_norm(d1) if last else d1)
            outs2.append(self.dec_norm(d2) if last else d2)
        # DPT hooks at depth/2, 3·depth/4 and the last block.
        hooks = [max(0, cfg.dec_depth * 2 // 4 - 1), max(0, cfg.dec_depth * 3 // 4 - 1),
                 cfg.dec_depth - 1]
        out1 = self.downstream_head1(f1, [outs1[i] for i in hooks], grid)
        out2 = self.downstream_head2(f2, [outs2[i] for i in hooks], grid)
        return out1, out2


def _cat(dicts):
    return {k: torch.cat([d[k] for d in dicts]) for k in dicts[0]}


class MASt3RModel:
    """The network on one device (the card unless `device` says otherwise),
    with the pair-inference entry points of the JAX wrapper."""

    def __init__(self, cfg: MASt3RConfig = MASt3RConfig(),
                 model: Optional[AsymmetricMASt3R] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        if model is None:
            dev = resolve_device(device)
            with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
                torch.manual_seed(seed)
                with torch.device(dev):
                    model = AsymmetricMASt3R(cfg)
        self.model = model.eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _in(self, img) -> torch.Tensor:
        return torch.as_tensor(img, device=self.device).to(torch.float32)

    @torch.no_grad()
    @fp32_math()
    def infer_pair(self, img1, img2):
        return self.model(self._in(img1), self._in(img2))

    @torch.no_grad()
    @fp32_math()
    def encode_image(self, img) -> torch.Tensor:
        """Encoder tokens (B, N, C): the retrieval features."""
        return self.model.encode(self._in(img))[0]

    def symmetric_inference(self, img1, img2):
        """Both orderings: (X11, X21) in frame 1, (X22, X12) in frame 2."""
        out11, out21 = self.infer_pair(img1, img2)
        out22, out12 = self.infer_pair(img2, img1)
        return out11, out21, out22, out12

    def symmetric_inference_batch(self, imgs1, imgs2, max_batch: int = 8):
        """Symmetric inference over a pair batch (B, H, W, 3) × 2: both
        orderings ride one doubled batch, one `infer_pair` per chunk of
        `max_batch`. Returns B per-pair 4-tuples (X11, X21, X22, X12), each
        map with a leading axis of 1."""
        a, b = self._in(imgs1), self._in(imgs2)
        B = a.shape[0]
        q, s = torch.cat([a, b]), torch.cat([b, a])
        chunks = [self.infer_pair(q[i:i + max_batch], s[i:i + max_batch])
                  for i in range(0, q.shape[0], max_batch)]
        o1, o2 = _cat([c[0] for c in chunks]), _cat([c[1] for c in chunks])

        def take(d, i):
            return {k: v[i:i + 1] for k, v in d.items()}

        return [(take(o1, k), take(o2, k), take(o1, B + k), take(o2, B + k))
                for k in range(B)]


# ------------------------------------------------------------------ matching
@fp32_math()
def reciprocal_nn_matches(desc1: torch.Tensor, desc2: torch.Tensor, block: int = 4096):
    """Dense mutual nearest neighbours of (H, W, D) descriptor maps: each
    pixel of image 1 takes the argmax of its dot products with image 2 (the
    nearest neighbour for unit descriptors; the first on a tie), computed
    by blocks of `block` queries, and the same back; a pair is a match when
    it is mutual. Returns (idx 1→2 (N1,), mutual (N1,)) on the inputs'
    device. Runs in fp32 with TF32 off: a TF32 product flips argmaxes
    between near-equal descriptors."""
    D = desc1.shape[-1]
    a, b = desc1.reshape(-1, D).float(), desc2.reshape(-1, D).float()

    def nn_idx(a, b):
        return torch.cat([torch.argmax(a[i:i + block] @ b.T, dim=1)
                          for i in range(0, a.shape[0], block)])

    nn12, nn21 = nn_idx(a, b), nn_idx(b, a)
    return nn12, nn21[nn12] == torch.arange(a.shape[0], device=a.device)


def extract_correspondences(desc1, desc2, conf1, conf2, subsample: int = 8):
    """Mutual matches on a `subsample`-strided grid of image 1 with the
    confidence sqrt(c1·c2). Returns host numpy (xy1 (M, 2), xy2 (M, 2),
    conf (M,)), as the JAX package's host-side assembly does."""
    H1, W1, _ = desc1.shape
    W2 = desc2.shape[1]
    nn12, mutual = reciprocal_nn_matches(desc1, desc2)
    dev = nn12.device
    ys = torch.arange(H1, device=dev)[:, None]
    xs = torch.arange(W1, device=dev)[None, :]
    grid = ((ys % subsample == 0) & (xs % subsample == 0)).reshape(-1)
    idx1 = torch.nonzero(mutual & grid).reshape(-1)
    idx2 = nn12[idx1]
    conf = torch.sqrt(conf1.reshape(-1)[idx1] * conf2.reshape(-1)[idx2])
    idx1, idx2 = idx1.cpu().numpy(), idx2.cpu().numpy()
    xy1 = np.stack([idx1 % W1, idx1 // W1], axis=1)
    xy2 = np.stack([idx2 % W2, idx2 // W2], axis=1)
    return xy1, xy2, conf.cpu().numpy()
