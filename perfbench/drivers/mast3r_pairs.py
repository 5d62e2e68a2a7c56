"""Driver of the MASt3R pair cells: the pair stage of MASt3R-SfM as
`G4SplatPipeline.run_sfm` runs it, set after set, at the configuration's
widths on weights the benchmark draws from the seed.

Set-up lays every parameter out in one flat buffer drawn on the card by one
generator call, in the reference's layout under the official checkpoint's
key names, builds the program's `AsymmetricMASt3R` on the meta device and
loads that state dict into it (`strict=True`, assigned, so the program's
parameters are views of the buffer), makes a pool of image sets from the
seed, and warms up both chunk shapes of a set and one matching. A set is
`views` images; for each set the window makes the calls `run_sfm` makes, in
its order and with its arguments: `symmetric_inference_batch` over the
exhaustive pairs (both orderings in chunks of `max_batch`), then
`extract_correspondences` on each pair, which ends on the host. An item is
one pair through both orderings with its correspondences on the host. The
window runs whole sets: the set running at the deadline completes. A traced
run profiles one set, spanned by CUDA events (`traced`), and then one pair
with the host's operations.

During the window's first set a wrapper of `MASt3RModel.infer_pair` keeps
the first chunk's head outputs, and the correspondences of `checked_pairs`
pairs drawn from the seed are kept. After the window the plain reference
(`reference.mast3r`) recomputes both from the same images and from weights
drawn again from the seed.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.counts import mast3r as mast3r_counts
from perfbench.reference import mast3r as ref
from perfbench.reference.precision import Ops, fp32_flags

HEAD_KEYS = ("pts3d", "conf", "desc", "desc_conf")
CONV_TRANSPOSED = (".act_postprocess.0.1.weight", ".act_postprocess.1.1.weight")


def make_weights(layout, seed: int, device, std: float) -> Dict[str, torch.Tensor]:
    """Every leaf a view of one flat buffer of standard normals from one
    generator call: a matrix or kernel × std/√fan-in (a transposed
    convolution's fan-in is its input channels), a norm's scale 1 + 0.1·x,
    a bias and the mask token 0.02·x."""
    total = sum(int(np.prod(s)) for s in layout.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape in layout.items():
            n = int(np.prod(shape))
            leaf = flat[off:off + n]
            if name.endswith(".bias") or name == "mask_token":
                leaf.mul_(0.02)
            elif len(shape) == 1:
                leaf.mul_(0.1).add_(1.0)
            else:
                fan_in = shape[0] if name.endswith(CONV_TRANSPOSED) else n // shape[0]
                leaf.mul_(std / math.sqrt(fan_in))
            out[name] = leaf.view(shape)
            off += n
    return out


def make_images(traffic: dict, seed: int, device) -> torch.Tensor:
    """(sets, views, H, W, 3) images in [0, 1]: smooth colour fields (coarse
    noise resized up) with fine noise."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    S, V, H, W = traffic["pool_sets"], traffic["views"], traffic["height"], traffic["width"]
    n = S * V
    coarse = torch.rand((n, 3, 6, 8), generator=gen, device=device)
    img = (0.8 * F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
           + 0.2 * torch.rand((n, 3, H, W), generator=gen, device=device))
    return img.clamp(0, 1).permute(0, 2, 3, 1).reshape(S, V, H, W, 3).contiguous()


def exhaustive_pairs(views: int) -> List[Tuple[int, int]]:
    """Every pair (i, j), i < j, in the order of `sfm.build_pairs_exhaustive`,
    which `run_sfm` uses up to 20 views."""
    return [(i, j) for i in range(views) for j in range(i + 1, views)]


class Inputs:
    """What the benchmark hands both sides: the image sets, the pairs, the
    chunk the check compares and the pairs whose matches it compares."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg = config["model"]
        self.traffic, self.device = traffic, device
        self.images = make_images(traffic, seed, device)
        self.pairs = exhaustive_pairs(traffic["views"])
        rng = np.random.default_rng(seed)
        self.checked = sorted(int(k) for k in rng.choice(len(self.pairs),
                                                          traffic["checked_pairs"],
                                                          replace=False))

    def chunk(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first set's first chunk: the first `max_batch` pairs in the
        order (i, j)."""
        imgs = self.images[0]
        pairs = self.pairs[:self.traffic["max_batch"]]
        return imgs[[i for i, _ in pairs]], imgs[[j for _, j in pairs]]


def head_gaps(got: Tuple[dict, dict], want: Tuple[dict, dict]) -> Dict[str, Tuple[float, float]]:
    """Per output, over both heads: (max |got − want|, max |want|)."""
    out = {}
    for k in HEAD_KEYS:
        out[k] = (max(float((g[k].float() - w[k].float()).abs().max()) for g, w in zip(got, want)),
                  max(float(w[k].float().abs().max()) for w in want))
    return out


def match_differences(q, t, mutual, xy1: np.ndarray, xy2: np.ndarray, w1: int,
                      w2: int) -> int:
    """Grid queries whose mutual flag or target differs between the
    reference's (q, t, mutual) and the program's correspondences; a
    program match off the grid counts as one."""
    q, t, mutual = (x.cpu().numpy() for x in (q, t, mutual))
    got = dict(zip((xy1[:, 1] * w1 + xy1[:, 0]).tolist(), (xy2[:, 1] * w2 + xy2[:, 0]).tolist()))
    differ = 0
    for qi, ti, mi in zip(q.tolist(), t.tolist(), mutual.tolist()):
        g = got.pop(qi, None)
        differ += int((g is not None) != mi or (mi and g != ti))
    return differ + len(got)


def compare(x: Inputs, got: dict, w: Dict[str, torch.Tensor], ops: Ops) -> List[tuple]:
    """The numbers compared: per head output of the first chunk, max |got −
    ref| / max |ref| over both heads; and the share of the checked pairs'
    grid queries whose mutual flag or target differs. The reference runs
    on the same images, in blocks of `check_block` ordered pairs."""
    cfg, tr = x.cfg, x.traffic
    a, b = x.chunk()
    gap = {k: [0.0, 0.0] for k in HEAD_KEYS}
    blk = tr["check_block"]
    with torch.no_grad(), fp32_flags():
        for s in range(0, a.shape[0], blk):
            want = ref.forward(w, a[s:s + blk], b[s:s + blk], cfg, ops)
            part = tuple({k: v[s:s + blk] for k, v in o.items()} for o in got["chunk"])
            for k, (d, m) in head_gaps(part, want).items():
                gap[k] = [max(gap[k][0], d), max(gap[k][1], m)]
            del want
        imgs = x.images[0]
        H, W = imgs.shape[1:3]
        differ = total = 0
        for k, (xy1, xy2) in zip(x.checked, got["matches"]):
            i, j = x.pairs[k]
            d_i = ref.forward(w, imgs[i:i + 1], imgs[j:j + 1], cfg, ops)[0]["desc"][0]
            d_j = ref.forward(w, imgs[j:j + 1], imgs[i:i + 1], cfg, ops)[0]["desc"][0]
            q, t, mutual = ref.grid_matches(d_i, d_j, tr["subsample"], ops)
            differ += match_differences(q, t, mutual, xy1, xy2, W, W)
            total += q.numel()
    print("[perfbench] largest reference value per output: "
          + " ".join(f"{k} {m!r}" for k, (_, m) in gap.items())
          + f"; grid queries differing {differ} of {total}", flush=True)
    out = [(k, d / m if m > 0 else math.inf) for k, (d, m) in gap.items()]
    return out + [("matches", differ / total)]


def reference_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(ref.shapes(config["model"]), seed, device, config["weight_std"])


def program_model(cfg: dict, w: Dict[str, torch.Tensor]):
    """The program's network on the meta device with the state dict `w`
    (the checkpoint's key set) loaded strictly by assignment, wrapped as
    the pipeline's `MASt3RModel`. Raises where the program's parameters are
    not the checkpoint's."""
    from g4splat_torch.priors.mast3r import AsymmetricMASt3R, MASt3RConfig, MASt3RModel

    mc = MASt3RConfig(**dict(cfg, dpt_layer_dims=tuple(cfg["dpt_layer_dims"])))
    with torch.device("meta"):
        net = AsymmetricMASt3R(mc)
    net.load_state_dict(ref.state_dict(w, cfg), strict=True, assign=True)
    for p in net.parameters():
        p.requires_grad_(False)
    return MASt3RModel(mc, model=net.eval())


class PairCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from g4splat_torch.priors.mast3r import extract_correspondences

        self.extract = extract_correspondences
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.model = program_model(config["model"], reference_weights(config, seed, device))
        self.x = Inputs(config, traffic, seed, device)
        self.pairs = self.x.pairs
        self.ids1 = [i for i, _ in self.pairs]
        self.ids2 = [j for _, j in self.pairs]
        self.got: Dict = {"chunk": None, "matches": []}
        self.capturing = False
        self._wrap_infer()
        self.traced_sets = 0
        # Warm-up: a set's two chunk shapes and one matching.
        t = time.perf_counter()
        mb = traffic["max_batch"]
        rest = (2 * len(self.pairs)) % mb or mb
        imgs = self.x.images[-1]
        for n in (mb, rest):
            a = imgs[[i for i, _ in self.pairs[:n]]]
            b = imgs[[j for _, j in self.pairs[:n]]]
            out = self.model.infer_pair(a, b)
        self.extract(out[0]["desc"][0], out[1]["desc"][0], out[0]["desc_conf"][0],
                     out[1]["desc_conf"][0], subsample=traffic["subsample"])
        del out
        print(f"[perfbench] warm-up {time.perf_counter() - t:.2f} s", flush=True)

    def _wrap_infer(self):
        """Keep the first chunk's head outputs while capturing."""
        cell, model = self, self.model
        orig = model.infer_pair

        def infer_pair(*a, **kw):
            out = orig(*a, **kw)
            if cell.capturing and cell.got["chunk"] is None:
                cell.got["chunk"] = tuple({k: v.detach().clone() for k, v in o.items()}
                                          for o in out)
            return out

        model.infer_pair = infer_pair

    def _instrument(self, rec):
        """Spans around the encoder (per call), the decoders (the first
        decoder block's pre-hook to the last one's post-hook) and both heads,
        by CUDA events, for the traced window."""
        net = self.model.model
        orig_encode = net.encode

        def encode(*a, **kw):
            with rec.cuda("encoder"):
                return orig_encode(*a, **kw)

        net.encode = encode
        open_spans = {}

        def opener(name):
            def pre(module, args):
                open_spans[name] = rec.cuda(name)
                open_spans[name].__enter__()
            return pre

        def closer(name):
            def post(module, args, out):
                open_spans.pop(name).__exit__(None, None, None)
            return post

        handles = [net.dec_blocks[0].register_forward_pre_hook(opener("decoder")),
                   net.dec_blocks2[-1].register_forward_hook(closer("decoder")),
                   net.downstream_head1.register_forward_pre_hook(opener("heads")),
                   net.downstream_head2.register_forward_hook(closer("heads"))]

        def undo():
            del net.encode
            for h in handles:
                h.remove()

        return undo

    def _run_set(self, k: int, rec, pairs=None) -> int:
        """One set of the window: pair inference, then each pair's
        correspondences on the host. Returns the pairs whose matches came
        back with a non-finite confidence."""
        tr = self.traffic
        imgs = self.x.images[k % tr["pool_sets"]]
        n = len(self.pairs) if pairs is None else pairs
        outs = self.model.symmetric_inference_batch(imgs[self.ids1[:n]], imgs[self.ids2[:n]],
                                                    mesh=None, max_batch=tr["max_batch"])
        failed = 0
        for p, o in enumerate(outs):
            with rec.cuda("matching"):
                xy1, xy2, conf = self.extract(o[0]["desc"][0], o[2]["desc"][0],
                                              o[0]["desc_conf"][0], o[2]["desc_conf"][0],
                                              subsample=tr["subsample"])
            failed += int(not np.isfinite(conf).all())
            if self.capturing and p in self.x.checked:
                self.got["matches"].append((xy1, xy2))
        return failed

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, rec) -> dict:
        dev = self.device
        failed = items = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.capturing = True
        if rec.tracing:
            undo = self._instrument(rec)
            with rec.traced(), rec.cuda("traced"):
                failed += self._run_set(0, rec)
            undo()
            self.capturing = False
            items = len(self.pairs)
            self.traced_sets = 1
            with rec.traced(labels=True):
                self._run_set(1, rec, pairs=self.traffic["labelled_pairs"])
            return {"attempted": items, "failed": failed}
        deadline = t0 + seconds
        k = 0
        while True:
            failed += self._run_set(k, rec)
            self.capturing = False
            items += len(self.pairs)
            k += 1
            if time.perf_counter() >= deadline:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        print(f"[perfbench] {k} sets, {items} pairs in {elapsed:.3f} s", flush=True)
        return {"prior_items_per_s": items / elapsed, "attempted": items, "failed": failed}

    # ---------------------------------------------------------------- counts
    def counts(self) -> Dict[str, float]:
        tr = self.traffic
        f = mast3r_counts.set_flops(self.config["model"], tr["views"], tr["height"],
                                    tr["width"], tr["subsample"])
        return {"window_flops": self.traced_sets * f["total"], "sets": self.traced_sets,
                "set_flops": f["total"], "items": self.traced_sets * len(self.pairs),
                **{f"{k}_flops": v for k, v in f.items() if k != "total"}}

    # ----------------------------------------------------------------- check
    def check(self) -> List[tuple]:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        w = reference_weights(self.config, self.seed, self.device)
        limits = self.traffic["limits"]
        return [(n, v, limits[n]) for n, v in compare(self.x, self.got, w, Ops())]


def control(config: dict, traffic: dict, seed: int, device, fault: str = "tf32") -> List[tuple]:
    """The check's numbers for the plain reference put in the program's
    place and run in TF32 (`fault="tf32"`, the control): the first chunk's
    head outputs and the checked pairs' matches."""
    if fault != "tf32":
        raise ValueError(f"no fault {fault!r} for this cell")
    x = Inputs(config, traffic, seed, device)
    w = reference_weights(config, seed, device)
    low = Ops(tf32=True)
    cfg, tr = x.cfg, traffic
    a, b = x.chunk()
    blk = tr["check_block"]
    imgs = x.images[0]
    W = imgs.shape[2]
    with torch.no_grad(), fp32_flags():
        parts = [ref.forward(w, a[s:s + blk], b[s:s + blk], cfg, low)
                 for s in range(0, a.shape[0], blk)]
        chunk = tuple({k: torch.cat([p[h][k] for p in parts]) for k in HEAD_KEYS}
                      for h in (0, 1))
        del parts
        matches = []
        for k in x.checked:
            i, j = x.pairs[k]
            d_i = ref.forward(w, imgs[i:i + 1], imgs[j:j + 1], cfg, low)[0]["desc"][0]
            d_j = ref.forward(w, imgs[j:j + 1], imgs[i:i + 1], cfg, low)[0]["desc"][0]
            q, t, mutual = ref.grid_matches(d_i, d_j, tr["subsample"], low)
            keep = mutual.cpu().numpy()
            q, t = q.cpu().numpy()[keep], t.cpu().numpy()[keep]
            matches.append((np.stack([q % W, q // W], 1), np.stack([t % W, t // W], 1)))
    return compare(x, {"chunk": chunk, "matches": matches}, w, Ops())


def setup(config: dict, traffic: dict, seed: int, device):
    return PairCell(config, traffic, seed, device)
