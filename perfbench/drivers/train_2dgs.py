"""Driver of the 2DGS training cells: `Trainer.step` in the loop that
`Trainer.train` runs, on a scene, cameras and supervision that the benchmark
makes from the seed.

Set-up builds one trainer, drives it through `check_steps` steps by its own
call (each on another view) and keeps what the check compares: each step's
loss, the first gradient's norm per leaf as Adam holds it (exp_avg / (1 −
β1) after one step), and the norm per leaf of the change after the last.
It then steps on to `start_iteration`, so the window begins with the
trainer's maintenance of that iteration behind it. The window steps the
trainer for the given seconds, syncing its metrics every `sync_every`
steps, with a CUDA event at each step's start on the training stream; a
traced run profiles the first `traced_steps` steps and stops.
After the window the plain reference (`reference.train2dgs`) follows the
same steps from the same inputs.
"""

from __future__ import annotations

import gc
import json
import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.counts import raster
from perfbench.counts.train_step import step_flops
from perfbench.reference import surfel, train2dgs
from perfbench.reference.precision import Ops, fp32_flags

ADAM_BETA1 = 0.9


# ------------------------------------------------------------------ inputs
def make_problem(scene_cfg: dict, seed: int, device) -> dict:
    """The benchmark's inputs from the seed, on `device`: a room-like shell
    of surfels (uniform in a cube, one in eight on the wall z = 3; SH degree
    3) seen by cameras on an arc; its renders by the plain reference give the
    images and the depth and normal priors; the initial scene is the same
    surfels jittered, grey and half opaque, in a buffer of `capacity`
    slots."""
    n, cap = scene_cfg["live"], scene_cfg["capacity"]
    W, H, V = scene_cfg["width"], scene_cfg["height"], scene_cfg["views"]
    spread = scene_cfg["spread"]
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(device=device, dtype=torch.float32)
    xyz = (torch.rand((n, 3), generator=gen, **f32) * 2 - 1) * spread
    wall = torch.randint(0, 8, (n,), generator=gen, device=device) == 0
    xyz[:, 2] = torch.where(wall, torch.full_like(xyz[:, 2], 3.0), xyz[:, 2])
    cols = torch.rand((n, 3), generator=gen, **f32)
    lo, hi = scene_cfg["log_scale"]
    log_s = lo + (hi - lo) * torch.rand((n,), generator=gen, **f32)
    quats = torch.randn((n, 4), generator=gen, **f32)
    f_rest = 0.05 * torch.randn((n, 15, 3), generator=gen, **f32)
    jitter = scene_cfg["jitter"] * torch.randn((n, 3), generator=gen, **f32)

    focal = scene_cfg["focal_at_768"] * W / 768.0
    r, h = scene_cfg["orbit_radius"], scene_cfg["orbit_height"]
    cams = [surfel.look_at([r * math.sin(a), h, -r * math.cos(a)], [0, 0, 0], [0, -1, 0],
                           focal, W, H, device)
            for a in (np.arange(V) - V // 2) * scene_cfg["orbit_step"]]
    gt = {"xyz": xyz, "features": torch.cat([((cols - 0.5) / surfel.SH_C0)[:, None], f_rest], 1),
          "opacity": torch.full((n,), scene_cfg["gt_opacity"], **f32),
          "scaling": torch.exp(log_s)[:, None].repeat(1, 2), "rotation_raw": quats}
    with torch.no_grad(), fp32_flags():
        outs = [surfel.render(c, gt, 3, Ops(), max_tiles=scene_cfg["max_tiles"]) for c in cams]
    views = {"image": torch.stack([o["render"] for o in outs]),
             "prior_depth": torch.stack([o["surf_depth"] for o in outs]),
             "prior_normal": torch.stack([o["rend_normal"] for o in outs]),
             "prior_curv": torch.zeros((V, H, W), **f32),
             "confidence": torch.ones((V, H, W), **f32),
             "color_weight": torch.ones(V, **f32),
             "scale_factor": torch.tensor(scene_cfg["scale_factor"], **f32)}
    op = math.log(scene_cfg["init_opacity"] / (1 - scene_cfg["init_opacity"]))

    def slots(live, dead):
        return torch.cat([live, dead.expand((cap - n,) + live.shape[1:])])

    init = {"xyz": slots(xyz + jitter, torch.zeros(3, **f32)),
            "f_dc": torch.zeros((cap, 1, 3), **f32),
            "f_rest": torch.zeros((cap, 15, 3), **f32),
            "opacity_raw": slots(torch.full((n, 1), op, **f32), torch.full((1,), -10.0, **f32)),
            "scaling_raw": slots(log_s[:, None].repeat(1, 2), torch.full((2,), -10.0, **f32)),
            "rotation_raw": slots(quats, torch.tensor([1.0, 0, 0, 0], **f32))}
    alive = torch.arange(cap, device=device) < n
    return {"init": init, "alive": alive, "cams": cams, "views": views}


def step_mark(device):
    """A step's start: a CUDA event on the current stream (no synchronize),
    or the host's clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def intervals_ms(marks) -> List[float]:
    """Milliseconds between consecutive marks (after a synchronize)."""
    if isinstance(marks[0], float):
        return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def rel_gap(got: float, ref: float, floor: float) -> float:
    return abs(got - ref) / max(abs(ref), floor)


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's gap of norms against the reference's norm of that leaf or
    the median leaf's, whichever is larger."""
    med = float(np.median([ref[k] for k in leaves]))
    return {k: rel_gap(got[k], ref[k], med) for k in leaves}


def compare(got: dict, ref: dict) -> List[tuple]:
    """The three numbers the check compares: the worst step's loss gap; the
    gap of the first gradient's norm of the median leaf; the gap of the
    change's norm by the worst leaf. The first gradient is taken at the
    median leaf because one near-edge-on splat can hold nearly all of the
    xyz and rotation leaves' difference (PERF.md). Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change."""
    loss = max(rel_gap(a, b, 1e-30) for a, b in zip(got["loss"], ref["loss"]))
    leaves = list(ref["grad"])
    grad = float(np.median(list(leaf_gaps(got["grad"], ref["grad"], leaves).values())))
    g_med = float(np.median([ref["grad"][k] for k in leaves]))
    moved = [k for k in leaves if ref["grad"][k] >= 1e-3 * g_med]
    change = max(leaf_gaps(got["change"], ref["change"], moved).values())
    return [("loss", loss), ("grad", grad), ("change", change)]


# -------------------------------------------------------------------- cell
class TrainCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from g4splat_torch.core.cameras import make_camera, stack_cameras
        from g4splat_torch.models.gaussians import GaussianScene
        from g4splat_torch.train.trainer import TrainConfig, Trainer, ViewData

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        t_in = time.perf_counter()
        self.problem = make_problem(config["scene"], seed, device)
        t_in = time.perf_counter() - t_in
        pb = self.problem
        init, cap = pb["init"], config["scene"]["capacity"]
        scene = GaussianScene(alive=pb["alive"].clone(),
                              mip_filter=torch.zeros((cap, 1), device=device),
                              max_sh_degree=3, active_sh_degree=3,
                              **{k: v.clone() for k, v in init.items()})
        cams = stack_cameras([make_camera(c.w2c, float(c.fx), float(c.fy), float(c.cx),
                                          float(c.cy), c.width, c.height, device=device)
                              for c in pb["cams"]])
        views = ViewData(**{k: v.clone() for k, v in pb["views"].items()})
        self.tcfg = TrainConfig(**config["train"])
        self.trainer = Trainer(scene, cams, views, self.tcfg, seed=seed)
        t = self.trainer
        start, n_check = traffic["start_iteration"], traffic["check_steps"]
        self.first_iteration = start - 1 - n_check
        t.iteration = self.first_iteration
        before = {k: p.detach().clone() for k, p in t.params.items()}
        losses, grads = [], {}
        for i in range(n_check):
            losses.append(t.step(sync_metrics=True)["loss"])
            if i == 0:
                for k, p in t.params.items():
                    m = t.optimizer.state.get(p, {}).get("exp_avg")
                    grads[k] = 0.0 if m is None else float(torch.linalg.norm(m)) / (1 - ADAM_BETA1)
        change = {k: float(torch.linalg.norm(p.detach() - before[k]))
                  for k, p in t.params.items()}
        del before
        self.got = {"loss": losses, "grad": grads, "change": change}
        while t.iteration < start:
            t.step(sync_metrics=True)
        self.pairs: List[dict] = []
        self.steps_traced = 0
        print(f"[perfbench] inputs {t_in:.2f} s", flush=True)

    # ---------------------------------------------------------------- window
    def _instrument(self, rec):
        """Spans around binning (CUDA events) and densify (host clock,
        synchronized on both sides), installed for the traced window."""
        from g4splat_torch.ops import rasterize_tiled

        orig_bin = rasterize_tiled.bin_splats

        def bin_splats(*a, **kw):
            with rec.cuda("binning"):
                return orig_bin(*a, **kw)

        rasterize_tiled.bin_splats = bin_splats
        t = self.trainer
        orig_densify = t.densify

        def densify(it):
            with rec.host("densify"):
                return orig_densify(it)

        t.densify = densify

        def undo():
            rasterize_tiled.bin_splats = orig_bin
            del t.densify

        return undo

    def _count_pairs(self) -> List[dict]:
        """The contributing pairs of each view on the trainer's scene as it
        stands, by the plain reference."""
        s = self.trainer.scene
        with torch.no_grad(), fp32_flags():
            p = {k: getattr(s, k).detach() for k in train2dgs.LEAVES}
            act = train2dgs.activated(p, s.alive, s.mip_filter)
            scene = {"xyz": p["xyz"], "features": torch.cat([p["f_dc"], p["f_rest"]], 1),
                     "opacity": act["opacity"], "scaling": act["scaling"],
                     "rotation_raw": p["rotation_raw"]}
            rows = []
            for c in self.problem["cams"]:
                out = surfel.render(c, scene, s.active_sh_degree, Ops(),
                                    max_tiles=self.tcfg.raster_max_tiles_per_splat,
                                    want_dist=False)
                rows.append({"pairs": int(out["n_pairs"].sum()), "entries": out["n_entries"],
                             "splats": int((out["radii"] > 0).sum()),
                             "live": int(s.alive.sum())})
        return rows

    def window(self, seconds: float, rec) -> dict:
        t = self.trainer
        dev = self.device
        every = self.traffic["sync_every"]
        steps = failed = 0

        def one():
            nonlocal steps, failed
            sync = (t.iteration + 1) % every == 0
            m = t.step(sync_metrics=sync)
            if sync and not math.isfinite(m["loss"]):
                failed += 1
            steps += 1

        if rec.tracing:
            self.pairs += self._count_pairs()
            undo = self._instrument(rec)
            t0 = time.perf_counter()
            with rec.traced():
                while steps < self.traffic["traced_steps"] and time.perf_counter() - t0 < seconds:
                    one()
            undo()
            self.steps_traced = steps
            self.pairs += self._count_pairs()
            with rec.traced(labels=True):
                for _ in range(self.traffic["labelled_steps"]):
                    one()
            return {"attempted": steps, "failed": failed}

        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            marks.append(step_mark(dev))
            one()
        marks.append(step_mark(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        ms = intervals_ms(marks)
        print(f"[perfbench] {steps} steps to iteration {t.iteration}; "
              f"{int(t.scene.num_alive)} live in {t.scene.capacity} slots; step ms "
              f"median {np.median(ms):.3f} max {max(ms):.3f}", flush=True)
        return {"train_steps_per_s": steps / elapsed,
                "train_step_p95_ms": float(np.percentile(ms, 95)),
                "attempted": steps, "failed": failed}

    # ---------------------------------------------------------------- counts
    def counts(self) -> Dict[str, float]:
        sc = self.config["scene"]
        W, H = sc["width"], sc["height"]
        dist = self.tcfg.lambda_dist != 0.0
        b1 = [raster.b1_least_s(r["pairs"], r["splats"], r["entries"], W, H, dist)
              for r in self.pairs]
        b2 = [raster.b2_least_s(r["pairs"], r["splats"], r["entries"], W, H, dist)
              for r in self.pairs]
        flops = [step_flops(r["pairs"], r["live"], r["entries"], W, H, dist) for r in self.pairs]
        return {"b1_least_s": float(np.mean(b1)), "b2_least_s": float(np.mean(b2)),
                "step_flops": float(np.mean(flops)), "steps": self.steps_traced,
                "pairs_per_view": float(np.mean([r["pairs"] for r in self.pairs]))}

    # ----------------------------------------------------------------- check
    def reference(self, ops: Ops) -> dict:
        pb = self.problem
        with fp32_flags():
            return train2dgs.follow(pb["init"], pb["alive"], pb["cams"], pb["views"],
                                    self.config["train"], self.first_iteration, self.seed,
                                    self.traffic["check_steps"], 3, ops)

    def check(self) -> List[tuple]:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference(Ops())
        worst = max(leaf_gaps(self.got["grad"], ref["grad"], list(ref["grad"])).values())
        print(f"[perfbench] first gradient, worst leaf's gap {worst!r}; per leaf (program, "
              "reference): " + json.dumps({k: {"grad": [self.got["grad"][k], ref["grad"][k]],
                                               "change": [self.got["change"][k],
                                                          ref["change"][k]]}
                                           for k in ref["grad"]}), flush=True)
        limits = self.traffic["limits"]
        return [(name, v, limits[name]) for name, v in compare(self.got, ref)]


def control(config: dict, traffic: dict, seed: int, device, fault: str = "tf32") -> List[tuple]:
    """The check's numbers for the plain reference put in the program's place,
    run in TF32 (`fault="tf32"`, the control) or with the losses taken over
    the top half of each image's rows (`"half_batch"`)."""
    pb = make_problem(config["scene"], seed, device)
    first = traffic["start_iteration"] - 1 - traffic["check_steps"]

    def run(ops, rows=slice(None)):
        with fp32_flags():
            return train2dgs.follow(pb["init"], pb["alive"], pb["cams"], pb["views"],
                                    config["train"], first, seed, traffic["check_steps"], 3,
                                    ops, rows)

    want = run(Ops())
    if fault == "tf32":
        got = run(Ops(tf32=True))
    elif fault == "half_batch":
        got = run(Ops(), slice(0, config["scene"]["height"] // 2))
    else:
        raise ValueError(f"no fault {fault!r} for this cell")
    return compare(got, want)


def setup(config: dict, traffic: dict, seed: int, device):
    return TrainCell(config, traffic, seed, device)
