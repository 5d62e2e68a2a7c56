"""See3D multi-view diffusion inpainting (counterpart of
`g4splat_tpu.priors.see3d`).

- `MultiViewUNet` — the MVDream SD-2.1 UNet with "3D" self-attention over the
  tokens of all frames of a branch jointly, cross-attention to the CLIP
  context, timestep-embedded ResBlocks and zero-initialised output
  projections. Modules are NCHW and their parameter names are the reference
  state-dict keys (``input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight``,
  …), so `load_state_dict` reads the MVD checkpoint with no converter.
  Attention goes through `ops.attention.memory_efficient_attention` (kernel
  B3 on the card) unless the caller passes another function.
- `DDIMSampler` — scaled-linear betas, zero-terminal-SNR rescale, "trailing"
  timesteps and v-prediction, as the JAX package builds them.
- `See3DPipeline` — the warp-mix inpainting loop: reference frames pinned to
  their clean latents, the warp-mix channel re-noised at t // 5, one UNet
  call for the cond and uncond branches with ``num_frames=F``, CFG
  ``(1+s)·cond − s·uncond`` and the optional guidance rescale.

LayerNorms use ε = 1e-6, as the JAX package's flax defaults do (the
reference torch modules use 1e-5; ROADMAP C6). Latents are NCHW here: the
pipeline takes (F, 4, h, w) latents and (F, 1, h, w) masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from g4splat_torch.ops.attention import memory_efficient_attention
from g4splat_torch.parallel.mesh import Replicas, run_spmd
from g4splat_torch.utils.profiling import annotated

Attention = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
LN_EPS = 1e-6


# ------------------------------------------------------------------ building
def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos|sin order (mv_unet.py:42-60)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class CrossAttention(nn.Module):
    """MemoryEfficientCrossAttention (mv_unet.py:139-227), ip_dim=0."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x, context=None, attention: Optional[Attention] = None):
        context = x if context is None else context
        B, N, _ = x.shape
        M = context.shape[1]
        q = self.to_q(x).reshape(B, N, self.heads, self.dim_head)
        k = self.to_k(context).reshape(B, M, self.heads, self.dim_head)
        v = self.to_v(context).reshape(B, M, self.heads, self.dim_head)
        out = (attention or memory_efficient_attention)(q, k, v)
        return self.to_out(out.reshape(B, N, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock3D(nn.Module):
    """Self-attention over all frames jointly, then per-frame cross-attention
    and a GEGLU feed-forward (mv_unet.py:229-272).

    With `shard` (a `parallel.mesh.Shard` of a `run_spmd` call) the frame
    batch is split over the mesh's entries: every per-frame op stays local,
    and the joint attention gathers the normalised tokens of every entry
    once, so each local query frame attends to its own branch's F·l keys and
    values. LayerNorm is per token, so normalising before the gather equals
    normalising after it."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x, context, num_frames: int, attention: Optional[Attention] = None,
                shard=None):
        bf, l, c = x.shape
        if shard is None:
            h = self.norm1(x).reshape(bf // num_frames, num_frames * l, c)
            x = x + self.attn1(h, attention=attention).reshape(bf, l, c)
        else:
            x_n = self.norm1(x)
            full = shard.all_gather(x_n)
            g = shard.index * bf + torch.arange(bf, device=x.device)
            kv = full.reshape(full.shape[0] // num_frames, num_frames * l, c)[g // num_frames]
            x = x + self.attn1(x_n, kv, attention=attention)
        x = x + self.attn2(self.norm2(x), context, attention=attention)
        return x + self.ff(self.norm3(x))


class SpatialTransformer3D(nn.Module):
    """mv_unet.py:275-332: GN + linear proj_in, `depth` transformer blocks,
    zero-init linear proj_out, residual."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock3D(inner, heads, dim_head, context_dim) for _ in range(depth))
        self.proj_out = nn.Linear(inner, channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x, context, num_frames: int, attention: Optional[Attention] = None,
                shard=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, context, num_frames, attention=attention, shard=shard)
        h = self.proj_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    """mv_unet.py:514-612 (up/down=False, the checkpoint configuration)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(nn.GroupNorm(32, in_ch), nn.SiLU(),
                                       nn.Conv2d(in_ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_ch), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        nn.init.zeros_(self.out_layers[3].weight)
        nn.init.zeros_(self.out_layers[3].bias)
        self.skip_connection = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                                else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers(x)
        e = self.emb_layers(emb)[:, :, None, None]
        norm, rest = self.out_layers[0], self.out_layers[1:]
        if self.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = norm(h) * (1 + scale) + shift
        else:
            h = norm(h + e)
        return self.skip_connection(x) + rest(h)


class Downsample(nn.Module):
    """mv_unet.py:480-512 (use_conv=True): stride-2 conv named ``op``."""

    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """mv_unet.py:447-477: nearest ×2 + conv named ``conv``."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


@dataclass(frozen=True)
class UNetConfig:
    """Mirrors the MultiViewUNetModel constructor (mv_unet.py:644-700): the
    See3D checkpoint is MVDream SD-2.1 with 9 input channels (4 latent + 4
    warp-mix + 1 mask). ``attention_resolutions`` holds downsample factors."""

    in_channels: int = 9
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_heads: int = -1
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    camera_dim: Optional[int] = 16
    use_scale_shift_norm: bool = False

    def heads_for(self, ch: int) -> Tuple[int, int]:
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels

    def n_transformer_blocks(self) -> int:
        """Transformer blocks in the UNet: each makes two attention calls."""
        levels = sum(1 for i in range(len(self.channel_mult))
                     if 2 ** i in self.attention_resolutions)
        return self.transformer_depth * (levels * (2 * self.num_res_blocks + 1) + 1)


TINY_UNET = UNetConfig(
    in_channels=9, out_channels=4, model_channels=32,
    channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(1, 2),
    num_heads=-1, num_head_channels=16, context_dim=16, camera_dim=None,
)


class MultiViewUNet(nn.Module):
    """Checkpoint-structured MultiViewUNetModel (mv_unet.py:614-1003).

    ``x``: (B·F, in_ch, h, w), ``t``: (B·F,), ``context``: (B·F, M,
    context_dim), optional ``camera``: (B·F, camera_dim).
    """

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb = 4 * mc
        ssn = cfg.use_scale_shift_norm
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(), nn.Linear(emb, emb))
        if cfg.camera_dim is not None:
            self.camera_embed = nn.Sequential(nn.Linear(cfg.camera_dim, emb), nn.SiLU(),
                                              nn.Linear(emb, emb))

        def transformer(ch):
            heads, dim_head = cfg.heads_for(ch)
            return SpatialTransformer3D(ch, heads, dim_head, cfg.context_dim,
                                        cfg.transformer_depth)

        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(cfg.in_channels, mc, 3,
                                                                    padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, mc * mult, emb, ssn)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb, ssn), transformer(ch),
                                           ResBlock(ch, ch, emb, ssn)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mc * mult, emb, ssn)]
                ch = mc * mult
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(ch, cfg.out_channels, 3, padding=1))
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)

    @staticmethod
    def _run(layers, h, emb, context, num_frames, attention, shard):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif isinstance(layer, SpatialTransformer3D):
                h = layer(h, context, num_frames, attention=attention, shard=shard)
            else:
                h = layer(h)
        return h

    @annotated("g4s:see3d.unet")
    def forward(self, x, t, context, num_frames: int, camera=None,
                attention: Optional[Attention] = None, shard=None):
        """`shard`: this call's part of a frame batch split over a mesh
        (`BasicTransformerBlock3D`); `num_frames` stays the branch's."""
        emb = self.time_embed(timestep_embedding(t, self.cfg.model_channels))
        if camera is not None:
            emb = emb + self.camera_embed(camera)
        hs = []
        h = x
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context, num_frames, attention, shard)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, num_frames, attention, shard)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb, context, num_frames,
                          attention, shard)
        return self.out(h)


# --------------------------------------------------------------------- DDIM
def custom_decay_function_weight(t: torch.Tensor) -> torch.Tensor:
    """Warp-mix decay weight (pipeline_mvd_warp_mix_classifier.py:27-51)."""
    t = t.to(torch.float32)
    t_peak, t_end, v_end = 200.0, 60.0, 0.8
    slow = 1.0 - (1.0 - v_end) * (t_peak - t) / (t_peak - t_end)
    fast = v_end * torch.exp(-0.075 * (t_end - t))
    return torch.clamp(torch.where(t >= t_end, slow, fast), 0.0, 1.0)


@dataclass
class DDIMConfig:
    num_train_timesteps: int = 1000
    num_steps: int = 50
    guidance_scale: float = 2.0
    beta_start: float = 0.00085
    beta_end: float = 0.012
    rescale_zero_snr: bool = True
    prediction_type: str = "v"           # 'v' or 'epsilon'
    timestep_spacing: str = "trailing"   # 'trailing' or 'leading'
    guidance_rescale: float = 0.0        # production runs 0.0 (mv_diffusion.py:67)


class DDIMSampler:
    """Scaled-linear-beta DDIM with the reference's scheduler overrides
    (zero terminal SNR, trailing timesteps; mv_diffusion.py:44,
    pipeline_mvd_warp_mix_classifier.py:552-555)."""

    def __init__(self, cfg: DDIMConfig = DDIMConfig()):
        self.cfg = cfg
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps) ** 2
        ac = np.cumprod(1.0 - betas)
        if cfg.rescale_zero_snr:
            # diffusers rescale_zero_terminal_snr: shift sqrt(ac) so the
            # terminal value is exactly 0, keeping the first value fixed.
            s = np.sqrt(ac)
            s = (s - s[-1]) * (s[0] / (s[0] - s[-1]))
            ac = s ** 2
        self.alphas_cumprod = torch.as_tensor(ac.astype(np.float32))
        n = cfg.num_train_timesteps
        if cfg.timestep_spacing == "trailing":
            step = (n - 1) // cfg.num_steps
            self.timesteps = np.round(np.arange(n - 1, 0, -step)).astype(np.int64)
        else:
            step = n // cfg.num_steps
            self.timesteps = np.arange(0, n, step)[::-1].copy()
        # diffusers DDIMScheduler.step: prev_timestep = t - n // num_steps.
        self.step_size = n // cfg.num_steps

    def _acp(self, t, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] (1 for t < 0), shaped to broadcast against `like`."""
        ac = self.alphas_cumprod.to(like.device)
        t = torch.as_tensor(t, device=like.device).long()
        a = torch.where(t >= 0, ac[torch.clamp(t, min=0)], torch.ones((), device=like.device))
        return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))

    def add_noise(self, x0, noise, t):
        a = self._acp(t, x0)
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise

    def to_eps_x0(self, model_out, t, x):
        """Resolve the model output into (eps, x0) per prediction type."""
        a_t = self._acp(t, x)
        if self.cfg.prediction_type == "v":
            x0 = torch.sqrt(a_t) * x - torch.sqrt(1 - a_t) * model_out
            eps = torch.sqrt(a_t) * model_out + torch.sqrt(1 - a_t) * x
        else:
            x0 = (x - torch.sqrt(1 - a_t) * model_out) / torch.sqrt(torch.clamp(a_t, min=1e-12))
            eps = model_out
        return eps, x0

    def step(self, model_out, t, x):
        """One deterministic DDIM step (eta=0) from t to t − step_size."""
        eps, x0 = self.to_eps_x0(model_out, t, x)
        a_prev = self._acp(torch.as_tensor(t) - self.step_size, x)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


# ----------------------------------------------------------------- pipeline
Noise = Tuple[torch.Tensor, Sequence[torch.Tensor]]


class See3DPipeline:
    """Warp-conditioned multi-view inpainting
    (pipeline_mvd_warp_mix_classifier.py:511-700):

    * frames ``[:gt_num]`` are reference images whose latents are pinned to
      their clean encodings at the start of every step (:640-644);
    * the warp-mix channel is ``w(t/5)·add_noise(img_latents, t/5) +
      (1-w)·latents`` for generated frames (:646-654);
    * UNet input = [latents | warp_mix | mask] (9 channels, :660-664);
    * CFG: the uncond branch zeroes the warp-mix and mask channels of
      generated frames and keeps the same context (:666-672), combined as
      ``(1+s)·cond − s·uncond`` (:692-694);
    * cond and uncond frames go through one UNet call with ``num_frames=F``.

    With a `parallel.mesh.DeviceMesh` whose `data` size divides 2F, that
    call's frames split over the `data` entries (n = 2 is the cond / uncond
    split), each entry running the UNet's copy on its device in its own
    thread and meeting the others in the joint attention's gather; the DDIM
    state stays on the home device. Otherwise the call is unsharded.
    """

    def __init__(self, unet: MultiViewUNet, ddim: DDIMConfig = DDIMConfig(), mesh=None):
        self.unet = unet
        self.sampler = DDIMSampler(ddim)
        self.mesh = mesh
        self._replicas = Replicas(unet)

    def _denoise(self, inp, t_vec, context, num_frames: int,
                 attention: Optional[Attention]) -> torch.Tensor:
        """The UNet over the 2F cond + uncond frames, split over the mesh's
        `data` entries when their number divides 2F."""
        n = self.mesh.shape["data"] if self.mesh is not None else 1
        if n == 1 or inp.shape[0] % n:
            return self.unet(inp, t_vec, context, num_frames=num_frames, attention=attention)
        devs = self.mesh.data_devices
        b = inp.shape[0] // n

        def entry(shard):
            dev, part = devs[shard.index], slice(shard.index * b, (shard.index + 1) * b)
            return self._replicas.on(dev)(inp[part].to(dev), t_vec[part].to(dev),
                                          context[part].to(dev), num_frames=num_frames,
                                          attention=attention, shard=shard)

        return torch.cat([o.to(inp.device) for o in run_spmd(devs, entry)])

    def draw_noise(self, shape, device, generator: Optional[torch.Generator] = None
                   ) -> Noise:
        """x_T and one noise tensor per timestep, from `generator`."""
        draws = [torch.randn(shape, generator=generator, device=device)
                 for _ in range(len(self.sampler.timesteps) + 1)]
        return draws[0], draws[1:]

    @torch.no_grad()
    def inpaint_latents(self, img_latents: torch.Tensor, masks: torch.Tensor,
                        context: torch.Tensor, gt_num: int = 0,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Noise] = None,
                        attention: Optional[Attention] = None) -> torch.Tensor:
        """Denoised latents (F, 4, h, w) from encoded refs + warps
        ``img_latents`` (F, 4, h, w), latent-resolution masks (F, 1, h, w)
        (1 = visible) and context (F, M, context_dim); frames ``[:gt_num]``
        come back as their clean encodings. Noise is ``(x_T, [one per
        timestep])`` when given, else drawn from `generator`."""
        sampler, cfg = self.sampler, self.sampler.cfg
        Fn = img_latents.shape[0]
        dev = img_latents.device
        if noise is None:
            noise = self.draw_noise(img_latents.shape, dev, generator)
        x_T, step_noise = noise
        if len(step_noise) != len(sampler.timesteps):
            raise ValueError(f"{len(step_noise)} step noises for "
                             f"{len(sampler.timesteps)} timesteps")
        gt = (torch.arange(Fn, device=dev) < gt_num).to(torch.float32)[:, None, None, None]
        ctx2 = torch.cat([context, context], dim=0)
        x = gt * img_latents + (1 - gt) * x_T
        for t, eps in zip(sampler.timesteps.tolist(), step_noise):
            x = gt * img_latents + (1 - gt) * x
            tv = torch.full((Fn,), t // 5, dtype=torch.int64, device=dev)
            noisy_warp = sampler.add_noise(img_latents, eps, tv)
            w = custom_decay_function_weight(tv)[:, None, None, None]
            mix = gt * img_latents + (1 - gt) * (w * noisy_warp + (1 - w) * x)
            cond = torch.cat([x, mix, masks], dim=1)
            unc = torch.cat([x, gt * img_latents, gt * masks], dim=1)
            t_vec = torch.full((2 * Fn,), t, dtype=torch.int64, device=dev)
            out = self._denoise(torch.cat([cond, unc], dim=0), t_vec, ctx2, Fn, attention)
            s = cfg.guidance_scale
            model_out = (1 + s) * out[:Fn] - s * out[Fn:]
            if cfg.guidance_rescale > 0.0:
                # rescale_noise_cfg (:53-63): pull the CFG output's per-frame
                # std back toward the cond branch's.
                std_c = out[:Fn].std(dim=(1, 2, 3), keepdim=True, unbiased=False)
                std_g = model_out.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
                rescaled = model_out * (std_c / torch.clamp(std_g, min=1e-12))
                gr = cfg.guidance_rescale
                model_out = gr * rescaled + (1 - gr) * model_out
            x = sampler.step(model_out, t, x)
        return gt * img_latents + (1 - gt) * x

