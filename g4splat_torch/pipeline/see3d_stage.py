"""The See3D generative inpainting stage (counterpart of
`g4splat_tpu.pipeline.orchestrator.G4SplatPipeline._run_see3d_inpaint`).
The priors it reads are the See3D fields of `orchestrator.Priors`.

`run_see3d_inpaint` runs every selected warp of a stage through the MV-UNet
jointly, with the input views pinned as all-visible reference frames, the
CLIP context of the first reference view shared by all frames, and
last-prediction chaining when `group_size` splits the sequence
(see3d_util.py:145-220); optionally a 2× super-resolution pass
(see3d_util.py:223-275) whose outputs are side artifacts.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from g4splat_torch.core.resize import resize_bilinear
from g4splat_torch.device import DeviceLike, fp32_math, resolve_device
from g4splat_torch.priors.see3d import Attention, Noise, See3DPipeline
from g4splat_torch.utils.profiling import annotated

if TYPE_CHECKING:
    from g4splat_torch.pipeline.orchestrator import Priors

# (seed, latent shape (F, 4, h, w), timesteps) → (x_T, one noise per timestep)
NoiseFn = Callable[[int, Tuple[int, ...], int], Noise]


def _f32(x, dev: torch.device) -> torch.Tensor:
    """Host arrays are copied to `dev`; a tensor must already lie there."""
    if not torch.is_tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    if x.device != dev:
        raise ValueError(f"See3D stage input lies on {x.device}, the stage runs on {dev}")
    return x.to(torch.float32)


def _check_priors(priors: Priors, dev: torch.device):
    """Every prior network's weights must lie on the stage's device."""
    for name, module in (("vae", priors.vae), ("see3d", priors.see3d.unet),
                         ("see3d_sr", priors.see3d_sr and priors.see3d_sr.unet),
                         ("image_embedder", getattr(priors.image_embedder, "model", None)),
                         ("text_embedder", getattr(priors.text_embedder, "model", None))):
        devs = {p.device for p in module.parameters()} if module is not None else set()
        if devs - {dev}:
            raise ValueError(f"priors.{name} lies on {sorted(map(str, devs))}, the stage "
                             f"runs on {dev}")


def _context(priors: Priors, ref0: torch.Tensor) -> torch.Tensor:
    """context = prompt_embeds + image_embeds: the empty-prompt text
    embedding plus 0.2× the CLIP class embedding of the first reference view
    (pipeline_mvd_warp_mix_classifier.py:463-464,676-686); either alone when
    the other tower is absent, zeros when both are."""
    dev = ref0.device
    ctx_img = ctx_txt = None
    if priors.image_embedder is not None:
        ctx_img = torch.as_tensor(priors.image_embedder(ref0), device=dev)
        ctx_img = ctx_img[None] if ctx_img.ndim == 2 else ctx_img
    if priors.text_embedder is not None:
        ctx_txt = torch.as_tensor(priors.text_embedder(), device=dev)
        ctx_txt = ctx_txt[None] if ctx_txt.ndim == 2 else ctx_txt
    if ctx_img is not None and ctx_txt is not None:
        if ctx_img.shape[-1] != ctx_txt.shape[-1]:
            raise ValueError(
                "See3D conditioning width mismatch: text embedder emits "
                f"{ctx_txt.shape[-1]} but image embedder emits {ctx_img.shape[-1]}. The "
                "reference pairs the SD2.1 OpenCLIP text tower (1024) with CLIP-ViT-H-14's "
                "projection_dim=1024 (mv_diffusion.py:35).")
        return ctx_txt + ctx_img
    if ctx_img is not None or ctx_txt is not None:
        return ctx_img if ctx_img is not None else ctx_txt
    return torch.zeros((1, 4, priors.see3d.unet.cfg.context_dim), device=dev)


@annotated("g4s:see3d.call")
@torch.no_grad()
@fp32_math()
def run_see3d_inpaint(priors: Priors, images, input_view_num: int, warps: Sequence,
                      masks: Sequence, stage: int, mvd_resolution: Optional[int] = 512,
                      group_size: Optional[int] = None, super_resolution: bool = False,
                      noise_fn: Optional[NoiseFn] = None,
                      attention: Optional[Attention] = None, device: DeviceLike = None
                      ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """Inpaint one stage's warps with See3D.

    `images` holds the views, the first `input_view_num` of which are the
    references; `warps` are (H, W, 3) renders in [0, 1] and `masks` their
    (H, W) visibility (1 = visible). Frames run at `mvd_resolution`² (None
    keeps the warps' size). Each group's noise comes from a `torch.Generator`
    seeded with the group's seed (1000·stage + first warp index; SR
    500000 + 1000·stage + …), or from `noise_fn(seed, shape, timesteps)`.
    `attention` replaces the UNet's attention function (default: B3 on the
    card). The stage runs on `device` (default: the card) in fp32, TF32
    off: the priors must lie there, as must any tensor input; numpy inputs
    are copied there. Returns one (H, W, 3) image per warp, and the SR
    pass's 2×-resolution predictions when `super_resolution` is set (else
    None).
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _check_priors(priors, dev)
    vae = priors.vae
    H, W = warps[0].shape[:2]

    def to_mvd(img) -> torch.Tensor:
        img = _f32(img, dev)
        if mvd_resolution is not None and tuple(img.shape[:2]) != (mvd_resolution,) * 2:
            img = resize_bilinear(img, (mvd_resolution, mvd_resolution))
        return img

    refs = [to_mvd(images[v]) for v in range(input_view_num)]
    gt_num = len(refs)
    warp_l = [to_mvd(w) for w in warps]
    mask_l = [to_mvd(_f32(m, dev)[..., None])[..., 0] for m in masks]
    f = vae.factor
    ctx1 = _context(priors, refs[0])

    def run_groups(pipe: See3DPipeline, refs_g, warps_g, masks_g, group, key_base):
        """Each group runs refs + [last prediction] + its warps jointly; the
        chained frame is re-generated and discarded."""
        ones_g = torch.ones_like(masks_g[0])
        preds: List[torch.Tensor] = []
        for i in range(0, len(warps_g), group):
            extra_w = [preds[-1]] if preds else []
            extra_m = [masks_g[i - 1]] if preds else []
            frames = list(refs_g) + extra_w + list(warps_g[i:i + group])
            fmasks = [ones_g] * len(refs_g) + extra_m + list(masks_g[i:i + group])
            z = vae.encode(torch.stack(frames).permute(0, 3, 1, 2) * 2.0 - 1.0)
            m = torch.stack(fmasks)[:, None, ::f, ::f]
            ctx = ctx1.repeat(len(frames), 1, 1)
            seed = key_base + i
            n_t = len(pipe.sampler.timesteps)
            noise = (noise_fn(seed, tuple(z.shape), n_t) if noise_fn is not None else
                     pipe.draw_noise(z.shape, dev, torch.Generator(device=dev).manual_seed(seed)))
            out_z = pipe.inpaint_latents(z, m, ctx, gt_num=len(refs_g), noise=noise,
                                         attention=attention)
            dec = vae.decode(out_z[len(refs_g) + len(extra_w):])
            dec = torch.clamp((dec + 1.0) / 2.0, 0, 1).permute(0, 2, 3, 1)
            preds.extend(dec.unbind(0))
        return preds

    preds = run_groups(priors.see3d, refs, warp_l, mask_l, group_size or (gt_num + len(warp_l)),
                       1000 * stage)

    sr_preds = None
    if super_resolution and preds:
        # Re-inpaint at 2× with the predictions as warps under the same
        # masks, in groups of (len + 3) // 2, with the SR checkpoint when one
        # is wired. Later stages keep consuming the base predictions.
        def up2(img):
            return resize_bilinear(img, (2 * img.shape[0], 2 * img.shape[1]))

        sr_pipe = priors.see3d_sr or priors.see3d
        masks_sr = [up2(m[..., None])[..., 0] for m in mask_l]
        sr_preds = run_groups(sr_pipe, [up2(r) for r in refs], [up2(p) for p in preds],
                              masks_sr, (gt_num + len(preds) + 3) // 2, 500_000 + 1000 * stage)

    outs = [torch.clamp(resize_bilinear(p, (H, W)), 0.0, 1.0) for p in preds]
    return outs, sr_preds
