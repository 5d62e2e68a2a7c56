"""Driver of the SAM encoder cell: Segment Anything's image encoder as
`PlaneExcavator` runs it through `sam_mask_generator(...).batch`, set after
set, at the configuration's widths on weights the benchmark draws from the
seed.

Set-up lays every parameter of the model out in one flat buffer drawn on
the card by one generator call, in the reference's layout under the
official checkpoint's key names, and builds the program's `SAMPredictor`
on that state dict as the CLI builds it (the whole model: image encoder,
prompt encoder, mask decoder); it makes a pool of view sets from the seed
(`mast3r_pairs.make_images`) and warms up with whole sets for
`warmup_seconds`: the card runs this load at its 700 W cap, and its clocks
settle as it warms (1980 MHz cold, 1935-1965 MHz after about 20 s). A set is `views` images;
for each set the window makes the call `sam_mask_generator(...).batch`
makes, `SAMPredictor.encode_images(views, max_batch=max_batch)`: each view
squashed to img_size² and one encoder call a slab of `max_batch` views
under `no_grad` and `fp32_math`. An item is one view through the encoder,
its (g, g, embed_dim) embedding on the card; after each set one read to
the host counts the views whose embedding is not finite (`failed`). The
window runs whole sets: the set running at the deadline completes. A
traced run profiles one set, spanned by CUDA events (`traced`), then one
slab of `labelled_views` with the host's operations.

During the window's first set, forward hooks keep the first slab's tokens
after the first global block (`global_attn_indexes[0]`) and the neck's
output. After the window the plain reference (`reference.sam`) recomputes
both from the same views and from weights drawn again from the seed, view
by view and its global attention head by head. The numbers compared, each
max |program − reference| / max |reference| over the slab, and the limits
of `workloads/plane_views_10.json`:

- `tokens` (limit 1e-4): the residual stream after block 7, where the first
  4096-token attention with its rel-pos bias has run on the output of seven
  windowed blocks over the padded grid. Both sides compute in float32, in
  another order of summation;
- `neck` (limit 1e-4): the embedding the mask decoder reads, after all 32
  blocks and the neck's two LayerNorm2d.

A limit lies between the largest reading of sound runs and the smallest
reading of the control (`control`: the reference computed in TF32 in the
program's place), with room on both sides; PERF.md gives both readings.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.counts import sam as sam_counts
from perfbench import harness
from perfbench.drivers.mast3r_pairs import make_images
from perfbench.reference import sam as ref
from perfbench.reference.precision import Ops, fp32_flags

CONV_TRANSPOSED = ("output_upscaling.0.weight", "output_upscaling.3.weight")
COMPARED = ("tokens", "neck")


def make_weights(layout, seed: int, device, config: dict) -> Dict[str, torch.Tensor]:
    """Every leaf a view of one flat buffer of standard normals from one
    generator call: a matrix or kernel × weight_std/√fan-in (a transposed
    convolution's fan-in is its input channels), a norm's scale 1 + 0.1·x,
    a bias 0.02·x, `pos_embed` × pos_embed_std and each rel-pos table ×
    rel_pos_std."""
    total = sum(int(np.prod(s)) for s in layout.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape in layout.items():
            n = int(np.prod(shape))
            leaf = flat[off:off + n]
            if name.endswith(".bias"):
                leaf.mul_(0.02)
            elif name.endswith(".pos_embed"):
                leaf.mul_(config["pos_embed_std"])
            elif name.endswith((".rel_pos_h", ".rel_pos_w")):
                leaf.mul_(config["rel_pos_std"])
            elif len(shape) == 1:
                leaf.mul_(0.1).add_(1.0)
            else:
                fan_in = shape[0] if name.endswith(CONV_TRANSPOSED) else n // shape[0]
                leaf.mul_(config["weight_std"] / math.sqrt(fan_in))
            out[name] = leaf.view(shape)
            off += n
    return out


def reference_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(ref.shapes(config["model"]), seed, device, config)


def sam_config(model: dict):
    """The program's `SAMConfig` of the configuration's model; raises where
    its global blocks (every `global_attn_every`-th) are not the listed
    `global_attn_indexes`."""
    from g4splat_torch.priors.sam import SAMConfig

    cfg = SAMConfig(**{k: v for k, v in model.items() if k != "global_attn_indexes"})
    every = [i for i in range(cfg.encoder_depth) if (i + 1) % cfg.global_attn_every == 0]
    if every != list(model["global_attn_indexes"]):
        raise ValueError(f"global blocks {every} != global_attn_indexes "
                         f"{model['global_attn_indexes']}")
    return cfg


def program(model: dict, w: Dict[str, torch.Tensor], device):
    """The program's predictor on the state dict `w` (the checkpoint's
    whole key set), as the CLI builds it."""
    from g4splat_torch.priors.sam import SAMPredictor

    return SAMPredictor(sam_config(model), state_dict=w, device=device)


def first_slab(images: torch.Tensor, traffic: dict) -> torch.Tensor:
    """The views of the first set's first encoder call."""
    return images[0][:traffic["max_batch"]]


def compare(cfg: dict, views: torch.Tensor, got: dict, w: Dict[str, torch.Tensor],
            ops: Ops) -> List[tuple]:
    """Per compared output, max |got − ref| / max |ref| over the slab; the
    reference runs on the same views."""
    g = cfg["global_attn_indexes"][0]
    with torch.no_grad(), fp32_flags():
        neck, kept = ref.image_encoder(w, views, cfg, ops, keep=(g,))
    want = {"tokens": kept[g], "neck": neck.permute(0, 2, 3, 1)}
    out, largest = [], []
    for k in COMPARED:
        m = float(want[k].abs().max())
        largest.append(f"{k} {m!r}")
        if got.get(k) is None or got[k].shape != want[k].shape or not m > 0:
            out.append((k, math.inf))
            continue
        out.append((k, float((got[k].float() - want[k]).abs().max()) / m))
    print("[perfbench] largest reference value per output: " + " ".join(largest), flush=True)
    return out


class EncodeCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.cfg = config["model"]
        t = time.perf_counter()
        self.predictor = program(self.cfg, reference_weights(config, seed, device), device)
        self.images = make_images(traffic, seed, device)
        harness.sync(device)
        print(f"[perfbench] weights, model and images {time.perf_counter() - t:.2f} s", flush=True)
        self.got: Dict[str, torch.Tensor] = {}
        self.capturing = False
        self._keep_outputs()
        self.traced_sets = 0
        # Warm-up: whole sets for `warmup_seconds`, so that the window starts
        # on a card at the clocks it holds under this load at its power cap.
        t = time.perf_counter()
        k = 0
        while k == 0 or time.perf_counter() - t < traffic["warmup_seconds"]:
            self._run_set(k)
            k += 1
        print(f"[perfbench] warm-up {k} sets, {time.perf_counter() - t:.2f} s", flush=True)

    @property
    def encoder(self):
        return self.predictor.model.image_encoder

    def _keep_outputs(self):
        """Forward hooks that keep, while capturing, the first encoder
        call's tokens after the first global block and its neck output."""
        cell = self

        def keep(name):
            def hook(module, args, out):
                if cell.capturing and name not in cell.got:
                    cell.got[name] = out.detach().clone()
            return hook

        enc = self.encoder
        enc.blocks[self.cfg["global_attn_indexes"][0]].register_forward_hook(keep("tokens"))
        enc.register_forward_hook(keep("neck"))

    def _instrument(self, rec):
        """CUDA events around each encoder call (its forward pre-hook to its
        forward hook), for the traced window."""
        enc = self.encoder
        open_spans = []

        def pre(module, args):
            open_spans.append(rec.cuda("encode"))
            open_spans[-1].__enter__()

        def post(module, args, out):
            open_spans.pop().__exit__(None, None, None)

        handles = [enc.register_forward_pre_hook(pre),
                   enc.register_forward_hook(post, prepend=True)]
        return lambda: [h.remove() for h in handles]

    def _run_set(self, k: int, views=None) -> int:
        """One set of the window through `encode_images`. Returns the views
        whose embedding is not finite (one read to the host)."""
        tr = self.traffic
        imgs = self.images[k % tr["pool_sets"]][:views]
        emb = self.predictor.encode_images(imgs, max_batch=tr["max_batch"])
        return int((~torch.isfinite(emb)).flatten(1).any(1).sum())

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, rec) -> dict:
        dev = self.device
        V = self.traffic["views"]
        failed = items = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.capturing = True
        if rec.tracing:
            undo = self._instrument(rec)
            with rec.traced(), rec.cuda("traced"):
                failed += self._run_set(0)
            undo()
            self.capturing = False
            self.traced_sets = 1
            with rec.traced(labels=True):
                self._run_set(1, views=self.traffic["labelled_views"])
            return {"attempted": V, "failed": failed}
        deadline = t0 + seconds
        k = 0
        ends = [t0]
        while True:
            failed += self._run_set(k)
            self.capturing = False
            items += V
            k += 1
            ends.append(time.perf_counter())
            if ends[-1] >= deadline:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        sets_ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
        print(f"[perfbench] {k} sets, {items} views in {elapsed:.3f} s; a set "
              f"{sets_ms[0]:.2f} / {sorted(sets_ms)[k // 2]:.2f} / {sets_ms[-1]:.2f} ms "
              f"(first / median / last)", flush=True)
        return {"prior_items_per_s": items / elapsed, "attempted": items, "failed": failed}

    # ---------------------------------------------------------------- counts
    def counts(self) -> Dict[str, float]:
        V, mb = self.traffic["views"], self.traffic["max_batch"]
        f = sam_counts.view_flops(self.cfg)
        n = self.traced_sets
        least = sum(sam_counts.attention_least_s(self.cfg, min(mb, V - s))
                    for s in range(0, V, mb))
        return {"window_flops": n * V * f["total"], "sets": n, "set_flops": V * f["total"],
                "items": n * V, "attn_least_s": n * least,
                **{f"{k}_flops": V * v for k, v in f.items() if k != "total"}}

    # ----------------------------------------------------------------- check
    def check(self) -> List[tuple]:
        del self.predictor
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        w = reference_weights(self.config, self.seed, self.device)
        limits = self.traffic["limits"]
        views = first_slab(self.images, self.traffic)
        return [(n, v, limits[n]) for n, v in compare(self.cfg, views, self.got, w, Ops())]


def control(config: dict, traffic: dict, seed: int, device, fault: str = "tf32") -> List[tuple]:
    """The check's numbers for the plain reference put in the program's
    place and run in TF32 (`fault="tf32"`, the control) on the first slab."""
    if fault != "tf32":
        raise ValueError(f"no fault {fault!r} for this cell")
    cfg = config["model"]
    views = first_slab(make_images(traffic, seed, device), traffic)
    w = reference_weights(config, seed, device)
    g = cfg["global_attn_indexes"][0]
    with torch.no_grad(), fp32_flags():
        neck, kept = ref.image_encoder(w, views, cfg, Ops(tf32=True), keep=(g,))
    got = {"tokens": kept[g], "neck": neck.permute(0, 2, 3, 1)}
    del neck, kept
    return compare(cfg, views, got, w, Ops())


def setup(config: dict, traffic: dict, seed: int, device):
    return EncodeCell(config, traffic, seed, device)
