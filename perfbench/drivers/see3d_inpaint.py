"""Driver of the See3D inpaint cells: `run_see3d_inpaint`, call after call,
at the configuration's widths on weights the benchmark draws from the seed.

Set-up lays every parameter of the four networks (the UNet, the VAE, both
CLIP towers) out in one flat buffer drawn on the card by one generator call,
builds the program's modules on the meta device and binds their parameters
to views of that buffer by name, makes the reference images, warps and masks
from the seed, and warms every shape up with one call of a short sampler.
The window runs whole calls; once its time is up the next UNet call raises
and the window closes after the device finishes what was queued. A traced
run profiles the first call and stops. Hooks registered here count the UNet
calls, and on the first call keep what the check compares: the context,
the encoded latents, the UNet's input and output at steps drawn from the
seed, the latents that go to the decoder, and the images returned. After
the window the plain reference (`reference.see3d`) recomputes each from the
same inputs and weights, drawn again from the seed.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.counts import attention as att_counts
from perfbench.reference import see3d as ref
from perfbench.reference.precision import Ops, fp32_flags


class WindowClosed(Exception):
    """Raised from the UNet's pre-hook once the window's time is up."""


def make_weights(layout, seed: int, device, std: float) -> torch.Tensor:
    """One flat buffer of every parameter: standard normals from one
    generator call, then per leaf: a matrix or kernel × std/√fan-in, a
    norm's scale 1 + 0.1·x, a bias 0.02·x, an embedding table 0.02·x."""
    total = sum(int(np.prod(s)) for s in layout.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for name, shape in layout.items():
            n = int(np.prod(shape))
            leaf = flat[off:off + n]
            if name.endswith(("class_embedding", "pos_embed", "token_embedding", ".bias")):
                leaf.mul_(0.02)
            elif len(shape) == 1:
                leaf.mul_(0.1).add_(1.0)
            else:
                leaf.mul_(std / math.sqrt(n // shape[0]))
            off += n
    return flat


def make_inputs(traffic: dict, seed: int, device):
    """Reference images, warps and masks at res²: smooth colour fields
    (coarse noise resized up) with fine noise; each mask keeps the pixels
    where a smooth field lies above its `visible` quantile."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    res, n_ref, n_warp = traffic["resolution"], traffic["references"], traffic["warps"]
    n = n_ref + n_warp

    def smooth(c, coarse):
        x = torch.rand((n, c, coarse, coarse), generator=gen, device=device)
        return F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False)

    img = smooth(3, 8) * 0.8 + 0.2 * torch.rand((n, 3, res, res), generator=gen, device=device)
    img = img.clamp(0, 1).permute(0, 2, 3, 1).contiguous()
    field = smooth(1, 6)[n_ref:, 0]
    q = torch.quantile(field.reshape(n_warp, -1)[:, ::97], 1.0 - traffic["visible"], dim=1)
    masks = (field > q[:, None, None]).to(torch.float32)
    return img[:n_ref], list(img[n_ref:].unbind(0)), list(masks.unbind(0))


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


class Inputs:
    """What the benchmark hands both sides: the images, warps and masks, the
    noise of each call (`noise(seed, shape, n_t)`, the form of the stage's
    `noise_fn`), and the steps the check follows."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.models, self.device = config["models"], device
        self.refs, self.warps, self.masks = make_inputs(traffic, seed, device)
        self.noise_seed = seed + 2
        n_t = len(ref.DDIM(self.models["ddim"], "cpu").timesteps)
        rng = np.random.default_rng(seed)
        self.check_at = sorted(int(k) for k in rng.choice(n_t - 1, traffic["checked_steps"],
                                                          replace=False))

    def noise(self, seed, shape, n_t):
        gen = torch.Generator(device=self.device).manual_seed(self.noise_seed + seed)
        draws = torch.randn((n_t + 1,) + tuple(shape), generator=gen, device=self.device)
        return draws[0], list(draws[1:].unbind(0))


def compare(x: Inputs, got: dict, w: ref.Weights, ops: Ops) -> List[tuple]:
    """The numbers compared: the context, the encoded latents, the first
    UNet input, the UNet's output at the drawn steps, the next step's input
    from the reference's guided DDIM step, and the decoded images, each as
    max |got − ref| / max |ref|, the reference run on what the program had
    at that point."""
    m = x.models
    R = x.refs.shape[0]
    ddim = ref.DDIM(m["ddim"], x.device)
    with torch.no_grad(), fp32_flags():
        ctx = (ref.clip_image_context(w.clip_vision, x.refs[0], m["clip_vision"], ops)
               + ref.clip_text_context(w.clip_text, m["clip_text"], ops, x.device))
        out = [("context", rel(got["ctx"], ctx))]
        frames = torch.cat([x.refs, torch.stack(x.warps)])
        z = ref.vae_encode(w.vae, frames.permute(0, 3, 1, 2) * 2.0 - 1.0, ops)
        out.append(("encode", rel(got["z"], z)))
        f = frames.shape[1] // z.shape[2]
        masks = torch.cat([torch.ones_like(x.masks[0])[None].expand(R, -1, -1),
                           torch.stack(x.masks)])[:, None, ::f, ::f]
        ts = ddim.timesteps
        x_T, eps = x.noise(0, tuple(z.shape), len(ts))
        out.append(("input", rel(got["inp"][0], ref.unet_input(z, masks, x_T, ts[0], eps[0],
                                                               R, ddim))))
        Fn = frames.shape[0]
        ctx2 = ctx.repeat(2 * Fn, 1, 1)
        unet_err = step_err = 0.0
        for k in x.check_at:
            inp = got["inp"][k]
            tv = torch.full((2 * Fn,), ts[k], dtype=torch.int64, device=x.device)
            o = ref.unet(w.unet, inp, tv, ctx2, Fn, m["unet"], ops)
            unet_err = max(unet_err, rel(got["out"][k], o))
            nxt = ref.unet_input(z, masks, ref.guided_step(o, ts[k], inp[:Fn, :4], R, z, ddim),
                                 ts[k + 1], eps[k + 1], R, ddim)
            step_err = max(step_err, rel(got["inp"][k + 1], nxt))
            del o
        out += [("unet", unet_err), ("step", step_err)]
        dec = ref.vae_decode(w.vae, got["final"], ops)
        img = torch.clamp((dec + 1.0) / 2.0, 0, 1).permute(0, 2, 3, 1)
        out.append(("decode", rel(got["images"], img)))
    return out


def reference_weights(config: dict, seed: int, device) -> ref.Weights:
    layout = ref.shapes(config["models"])
    return ref.Weights.from_flat(make_weights(layout, seed, device, config["weight_std"]), layout)


def program_modules(models: dict, w: ref.Weights) -> dict:
    """The program's four networks, built on the meta device, their
    parameters bound by name to the views of `w`. Raises where the program's
    parameters are not the architecture's."""
    from g4splat_torch.priors.clip_text import CLIPText
    from g4splat_torch.priors.clip_vision import CLIPVision
    from g4splat_torch.priors.see3d import MultiViewUNet, UNetConfig
    from g4splat_torch.priors.vae import AutoencoderKL

    m = models
    u = dict(m["unet"])
    for k in ("channel_mult", "attention_resolutions"):
        u[k] = tuple(u[k])
    with torch.device("meta"):
        nets = {"unet": MultiViewUNet(UNetConfig(**u)),
                "vae": AutoencoderKL(m["vae"]["base_ch"], tuple(m["vae"]["ch_mult"]),
                                     m["vae"]["z_ch"]),
                "clip_vision": CLIPVision(**m["clip_vision"]),
                "clip_text": CLIPText(**m["clip_text"])}
    for prefix, net in nets.items():
        names = dict(net.named_parameters())
        want = {k[len(prefix) + 1:] for k in w.all if k.startswith(prefix + ".")}
        if set(names) != want or any(net.named_buffers()):
            raise RuntimeError(f"{prefix}: the program's parameters are not the "
                               f"architecture's: {sorted(set(names) ^ want)[:8]}")
        for name in names:
            mod, _, leaf = name.rpartition(".")
            view = w.all[f"{prefix}.{name}"]
            if tuple(view.shape) != tuple(names[name].shape):
                raise RuntimeError(f"{prefix}.{name}: shape {tuple(names[name].shape)}, "
                                   f"architecture {tuple(view.shape)}")
            setattr(net.get_submodule(mod) if mod else net, leaf,
                    torch.nn.Parameter(view, requires_grad=False))
        net.eval()
    return nets


class InpaintCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from g4splat_torch.pipeline.orchestrator import Priors
        from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint
        from g4splat_torch.priors.clip_text import CLIPTextEmbedder
        from g4splat_torch.priors.clip_vision import CLIPImageEmbedder
        from g4splat_torch.priors.see3d import DDIMConfig, See3DPipeline

        self.run = run_see3d_inpaint
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        m = config["models"]
        self.layout = ref.shapes(m)
        flat = make_weights(self.layout, seed, device, config["weight_std"])
        w = ref.Weights.from_flat(flat, self.layout)
        nets = program_modules(m, w)
        del w
        self.nets = nets
        self.priors = Priors(see3d=See3DPipeline(nets["unet"], DDIMConfig(**m["ddim"])),
                             vae=nets["vae"],
                             image_embedder=CLIPImageEmbedder(nets["clip_vision"]),
                             text_embedder=CLIPTextEmbedder(nets["clip_text"]))
        self.x = Inputs(config, traffic, seed, device)
        ks = self.x.check_at
        self.capture_at = {0} | set(ks) | {k + 1 for k in ks}
        self.got: Dict = {"inp": {}, "out": {}}
        self.capturing = False
        self.rec = None
        self.stop = None
        self.unet_calls = 0
        self.call_step = 0
        self._hooks(nets["unet"], nets["vae"])
        # Warm-up: one call of a short sampler on the same modules and shapes.
        warm = Priors(see3d=See3DPipeline(nets["unet"], DDIMConfig(
            **dict(m["ddim"], num_steps=traffic["warmup_steps"]))), vae=self.priors.vae,
            image_embedder=self.priors.image_embedder, text_embedder=self.priors.text_embedder)
        t = time.perf_counter()
        self._call(warm, stage=0)
        print(f"[perfbench] warm-up call {time.perf_counter() - t:.2f} s", flush=True)
        self.unet_calls = 0
        self.images = None

    def _call(self, priors, stage: int):
        self.call_step = 0
        x = self.x
        outs, _ = self.run(priors, x.refs, x.refs.shape[0], x.warps, x.masks, stage=stage,
                           mvd_resolution=self.traffic["resolution"], noise_fn=x.noise,
                           device=self.device)
        return outs

    def _hooks(self, unet, vae):
        cell = self

        def pre(module, args, kwargs):
            if cell.stop is not None and cell.stop():
                raise WindowClosed
            if cell.rec is not None and cell.rec.tracing:
                cell._span = cell.rec.cuda("unet_call")
                cell._span.__enter__()
            if cell.capturing and cell.call_step in cell.capture_at:
                cell.got["inp"][cell.call_step] = args[0].detach().clone()
                if cell.call_step == 0:
                    cell.got["ctx"] = kwargs.get("context", args[2] if len(args) > 2 else None
                                                 )[:1].detach().clone()

        def post(module, args, kwargs, out):
            if cell.rec is not None and cell.rec.tracing:
                cell._span.__exit__(None, None, None)
            if cell.capturing and cell.call_step in cell.capture_at:
                cell.got["out"][cell.call_step] = out.detach().clone()
            cell.call_step += 1
            cell.unet_calls += 1

        unet.register_forward_pre_hook(pre, with_kwargs=True)
        unet.register_forward_hook(post, with_kwargs=True)
        for kind in ("encode", "decode"):
            orig = getattr(vae, kind)

            def wrapped(x, _orig=orig, _kind=kind):
                if cell.rec is not None:
                    with cell.rec.cuda("vae"):
                        y = _orig(x)
                else:
                    y = _orig(x)
                if cell.capturing:
                    cell.got["z" if _kind == "encode" else "final"] = (
                        y if _kind == "encode" else x).detach().clone()
                return y

            setattr(vae, kind, wrapped)

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, rec) -> dict:
        """The first call whole (captured for the check; in a traced run,
        profiled, and then a few UNet steps of a second call profiled with
        the host's operations), then, untraced, calls until the time is up."""
        self.rec = rec
        failed = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.unet_calls = 0
        with rec.traced():
            self.capturing = True
            outs = self._call(self.priors, stage=0)
            self.capturing = False
        self.images = torch.stack(outs)
        failed += int(not bool(torch.isfinite(self.images).all()))
        self.traced_unet = self.unet_calls
        calls = 1
        if rec.tracing:
            self.rec = None
            self.stop = lambda: self.call_step >= self.traffic["labelled_steps"]
            with rec.traced(labels=True):
                try:
                    self._call(self.priors, stage=calls)
                except WindowClosed:
                    pass
        else:
            deadline = t0 + seconds
            self.stop = lambda: time.perf_counter() > deadline
            try:
                while time.perf_counter() < deadline:
                    self._call(self.priors, stage=calls)
                    calls += 1
            except WindowClosed:
                pass
        self.stop = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.rec = None
        return {"see3d_steps_per_s": self.unet_calls / elapsed, "attempted": self.unet_calls,
                "failed": failed}

    # ---------------------------------------------------------------- counts
    def counts(self) -> Dict[str, float]:
        from torch.utils.flop_counter import FlopCounterMode

        m, tr = self.config["models"], self.traffic
        res, R, Wn = tr["resolution"], tr["references"], tr["warps"]
        lat = res // 2 ** (len(m["vae"]["ch_mult"]) - 1)
        Fn = R + Wn
        w = ref.Weights({k: torch.empty(s, device="meta") for k, s in self.layout.items()})
        ops = Ops()
        flops = {}
        for key, fn in (
                ("clip", lambda: ref.clip_image_context(
                    w.clip_vision, torch.empty((res, res, 3), device="meta"),
                    m["clip_vision"], ops)),
                ("encode", lambda: ref.vae_encode(
                    w.vae, torch.empty((Fn, 3, res, res), device="meta"), ops)),
                ("unet", lambda: ref.unet(
                    w.unet, torch.empty((2 * Fn, m["unet"]["in_channels"], lat, lat),
                                        device="meta"),
                    torch.zeros(2 * Fn, dtype=torch.long, device="meta"),
                    torch.empty((2 * Fn, m["clip_text"]["n_ctx"], m["unet"]["context_dim"]),
                                device="meta"), Fn, m["unet"], ops)),
                ("decode", lambda: ref.vae_decode(
                    w.vae, torch.empty((Wn, m["vae"]["z_ch"], lat, lat), device="meta"), ops))):
            with FlopCounterMode(display=False) as fc:
                fn()
            flops[key] = float(fc.get_total_flops())
        n_unet = self.traced_unet
        window_flops = (flops["clip"] + flops["encode"] + flops["decode"]
                        + n_unet * flops["unet"])
        b3 = sum(att_counts.least_s(s) for s in att_counts.unet_launches(
            m["unet"], Fn, 2, lat, m["clip_text"]["n_ctx"]))
        return {"window_flops": window_flops, "b3_least_s_per_unet": b3, "unet_calls": n_unet,
                "inpaint_calls": 1, "unet_flops": flops["unet"]}

    # ----------------------------------------------------------------- check
    def check(self) -> List[tuple]:
        got = dict(self.got, images=self.images)
        del self.priors, self.nets
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        limits = self.traffic["limits"]
        w = reference_weights(self.config, self.seed, self.device)
        return [(n, v, limits[n]) for n, v in compare(self.x, got, w, Ops())]


def control(config: dict, traffic: dict, seed: int, device, fault: str = "tf32") -> List[tuple]:
    """The check's numbers for the plain reference put in the program's
    place and run in TF32 (`fault="tf32"`, the control): the whole call, with
    what the program's hooks would capture."""
    if fault != "tf32":
        raise ValueError(f"no fault {fault!r} for this cell")
    x = Inputs(config, traffic, seed, device)
    w = reference_weights(config, seed, device)
    keep = {0} | set(x.check_at) | {k + 1 for k in x.check_at}
    with torch.no_grad(), fp32_flags():
        got = ref.inpaint(w, x.models, x.refs, torch.stack(x.warps), torch.stack(x.masks),
                          x.noise, Ops(tf32=True), capture=keep)
    return compare(x, got, w, Ops())


def setup(config: dict, traffic: dict, seed: int, device):
    return InpaintCell(config, traffic, seed, device)
