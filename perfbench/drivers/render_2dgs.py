"""Driver of the 2DGS viewer cells: `render()` as the viewer, `render_all`
and `evaluate` call it, one request after another from one client, on a
trained-size scene that the benchmark makes from the seed.

Set-up draws the room of `train_2dgs.make_problem` (the same generator
calls in the same order, without its jitter and renders): `live` surfels
at the ground-truth opacity, SH degree 3, in a buffer of `capacity` slots
as training holds them, and a set of `poses` viewer cameras around the
room, a Latin hypercube over distance, yaw and height drawn from the seed,
visited in an order drawn from the seed. It renders every pose twice to
warm up. Each request of the window renders the next pose with
`RenderConfig(compute_distortion=False)` under `torch.no_grad()`, as
`render_camera_batch` does, and copies the colour frame to the host; the
loop is closed. A traced run profiles the first `traced_frames` requests,
spanned by CUDA events (`traced`), and then a few with the host's
operations.

The first `checked_frames` requests keep the colour, depth and normal maps
they returned. After the window the plain reference (`reference.surfel`)
renders those poses from the same surfels and compares.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.counts import raster
from perfbench.counts.render_frame import frame_flops
from perfbench.reference import surfel
from perfbench.reference.precision import Ops, fp32_flags

MAPS = (("rgb", "render"), ("depth", "surf_depth"), ("normal", "rend_normal"))


def make_scene(sc: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The room's raw surfel parameters (live ones only): the draws of
    `train_2dgs.make_problem`, in its order."""
    n = sc["live"]
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(device=device, dtype=torch.float32)
    xyz = (torch.rand((n, 3), generator=gen, **f32) * 2 - 1) * sc["spread"]
    wall = torch.randint(0, 8, (n,), generator=gen, device=device) == 0
    xyz[:, 2] = torch.where(wall, torch.full_like(xyz[:, 2], 3.0), xyz[:, 2])
    cols = torch.rand((n, 3), generator=gen, **f32)
    lo, hi = sc["log_scale"]
    log_s = lo + (hi - lo) * torch.rand((n,), generator=gen, **f32)
    quats = torch.randn((n, 4), generator=gen, **f32)
    f_rest = 0.05 * torch.randn((n, 15, 3), generator=gen, **f32)
    op = sc["gt_opacity"]
    return {"xyz": xyz, "f_dc": ((cols - 0.5) / surfel.SH_C0)[:, None], "f_rest": f_rest,
            "opacity_raw": torch.full((n, 1), math.log(op / (1 - op)), **f32),
            "scaling_raw": log_s[:, None].repeat(1, 2), "rotation_raw": quats}


def reference_scene(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's activated scene from the raw parameters."""
    return {"xyz": raw["xyz"], "features": torch.cat([raw["f_dc"], raw["f_rest"]], 1),
            "opacity": torch.sigmoid(raw["opacity_raw"][:, 0]),
            "scaling": torch.exp(raw["scaling_raw"]), "rotation_raw": raw["rotation_raw"]}


def make_poses(sc: dict, traffic: dict, seed: int, device):
    """The viewer cameras (reference `Cam`s) and the order of requests:
    `poses` cameras looking at the room's centre, each stratum of distance,
    yaw and height taken once (a Latin hypercube), in a seeded order."""
    rng = np.random.default_rng(seed)
    n = traffic["poses"]

    def strata(lo_hi, shuffle):
        lo, hi = lo_hi
        k = rng.permutation(n) if shuffle else np.arange(n)
        return lo + (hi - lo) * (k + rng.random(n)) / n

    r = strata(traffic["distance"], False)
    yaw = strata(traffic["yaw"], True)
    h = strata(traffic["height"], True)
    order = rng.permutation(n)
    focal = sc["focal_at_768"] * sc["width"] / 768.0
    cams = [surfel.look_at([ri * math.sin(a), hi, -ri * math.cos(a)], [0, 0, 0], [0, -1, 0],
                           focal, sc["width"], sc["height"], device)
            for ri, a, hi in zip(r, yaw, h)]
    return cams, [int(k) for k in order]


def max_gap(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """max |got − want| / max |want| over all the frames."""
    d = max(float((g - w).abs().max()) for g, w in zip(got, want))
    m = max(float(w.abs().max()) for w in want)
    return d / m if m > 0 else math.inf


def off_share(got: List[torch.Tensor], want: List[torch.Tensor], tol: float) -> float:
    """The share of pixels whose largest channel gap exceeds `tol` × max
    |want| over the frames."""
    m = max(float(w.abs().max()) for w in want)
    off = total = 0
    for g, w in zip(got, want):
        gap = (g - w).abs().reshape(w.shape[0], w.shape[1], -1).amax(-1)
        off += int((gap > tol * m).sum())
        total += gap.numel()
    return off / total


def compare(got: Dict[str, List[torch.Tensor]], want: Dict[str, List[torch.Tensor]],
            tol: float) -> List[tuple]:
    """Per map: the largest gap over the largest reference value, and the
    share of pixels off by more than `tol` of it."""
    out = [(name, max_gap(got[name], want[name])) for name, _ in MAPS]
    return out + [(f"{name}_off", off_share(got[name], want[name], tol)) for name, _ in MAPS]


def reference_frames(raw, cams, poses: List[int], ops: Ops, max_tiles: int) -> dict:
    scene = reference_scene(raw)
    want = {name: [] for name, _ in MAPS}
    with torch.no_grad(), fp32_flags():
        for k in poses:
            o = surfel.render(cams[k], scene, 3, ops, depth_ratio=0.0, max_tiles=max_tiles,
                              want_dist=False)
            for name, key in MAPS:
                want[name].append(o[key])
    return want


class RenderCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from g4splat_torch.core.cameras import make_camera, stack_cameras
        from g4splat_torch.models.gaussians import GaussianScene
        from g4splat_torch.ops.rasterize import render
        from g4splat_torch.ops.rasterize_common import RenderConfig

        self.render, self.rcfg = render, RenderConfig(compute_distortion=False)
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        sc = config["scene"]
        n, cap = sc["live"], sc["capacity"]
        raw = make_scene(sc, seed, device)
        f32 = dict(device=device, dtype=torch.float32)

        def slots(live, dead):
            return torch.cat([live, dead.to(**f32).expand((cap - n,) + live.shape[1:])])

        self.scene = GaussianScene(
            xyz=slots(raw["xyz"], torch.zeros(3)), f_dc=slots(raw["f_dc"], torch.zeros(1, 3)),
            f_rest=slots(raw["f_rest"], torch.zeros(15, 3)),
            opacity_raw=slots(raw["opacity_raw"], torch.full((1,), -10.0)),
            scaling_raw=slots(raw["scaling_raw"], torch.full((2,), -10.0)),
            rotation_raw=slots(raw["rotation_raw"], torch.tensor([1.0, 0, 0, 0])),
            alive=torch.arange(cap, device=device) < n,
            mip_filter=torch.zeros((cap, 1), **f32), max_sh_degree=3, active_sh_degree=3)
        del raw
        self.cams, self.order = make_poses(sc, traffic, seed, device)
        self.pcams = stack_cameras([make_camera(c.w2c, float(c.fx), float(c.fy), float(c.cx),
                                                float(c.cy), c.width, c.height, device=device)
                                    for c in self.cams])
        self.got: Dict[str, List[torch.Tensor]] = {name: [] for name, _ in MAPS}
        self.traced_frames = 0
        t = time.perf_counter()
        with torch.no_grad():
            for _ in range(traffic["warmup_cycles"]):
                for k in range(len(self.cams)):
                    self._frame(k)
        print(f"[perfbench] warm-up {time.perf_counter() - t:.2f} s", flush=True)

    def _frame(self, k: int, rec=None, keep: bool = False):
        """One request: the render of pose k and its colour frame on the
        host. Returns the frame and whether it holds a non-finite value (a
        device flag, read after the window)."""
        from g4splat_torch.core.cameras import camera_at

        out = self.render(camera_at(self.pcams, k), self.scene, config=self.rcfg,
                          backend="cuda")
        img = out["render"]
        if keep:
            for name, key in MAPS:
                self.got[name].append(out[key].detach().clone())
        bad = ~torch.isfinite(img).all()
        if rec is not None:
            with rec.cuda("copy"):
                frame = img.cpu()
        else:
            frame = img.cpu()
        return frame, bad

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, rec) -> dict:
        tr = self.traffic
        n, checked = len(self.order), tr["checked_frames"]
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        frames = 0
        lat: List[float] = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = t_last = time.perf_counter()
        with torch.no_grad():
            if rec.tracing:
                with rec.traced(), rec.cuda("traced"):
                    for frames in range(tr["traced_frames"]):
                        _, b = self._frame(self.order[frames % n], rec, keep=frames < checked)
                        bad += b
                frames += 1
                self.traced_frames = frames
                with rec.traced(labels=True):
                    for i in range(tr["labelled_frames"]):
                        self._frame(self.order[(frames + i) % n])
                return {"attempted": frames, "failed": int(bad)}
            while t_last - t0 < seconds:
                t = time.perf_counter()
                _, b = self._frame(self.order[frames % n], keep=frames < checked)
                t_last = time.perf_counter()
                lat.append(1e3 * (t_last - t))
                bad += b
                frames += 1
        print(f"[perfbench] {frames} frames; ms median {np.median(lat):.3f} "
              f"max {max(lat):.3f}", flush=True)
        return {"render_frames_per_s": frames / (t_last - t0),
                "render_p95_ms": float(np.percentile(lat, 95)),
                "attempted": frames, "failed": int(bad)}

    # ---------------------------------------------------------------- counts
    def counts(self) -> Dict[str, float]:
        """The work of the traced frames by the plain reference's walk of
        each pose they visited."""
        sc = self.config["scene"]
        W, H = sc["width"], sc["height"]
        n = len(self.order)
        visits = [self.order[i % n] for i in range(self.traced_frames)]
        live = int(self.scene.alive.sum())
        raw = {k: getattr(self.scene, k)[:live] for k in
               ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw")}
        scene = reference_scene(raw)
        rows = {}
        with torch.no_grad(), fp32_flags():
            for k in sorted(set(visits)):
                o = surfel.render(self.cams[k], scene, 3, Ops(), max_tiles=sc["max_tiles"],
                                  want_dist=False)
                pairs, splats, entries = (int(o["n_pairs"].sum()), int((o["radii"] > 0).sum()),
                                          o["n_entries"])
                rows[k] = (raster.b1_least_s(pairs, splats, entries, W, H, False),
                           frame_flops(pairs, live, entries, W, H), pairs)
        return {"b1_least_s": float(np.mean([rows[k][0] for k in visits])),
                "frame_flops": float(np.mean([rows[k][1] for k in visits])),
                "pairs_per_frame": float(np.mean([rows[k][2] for k in visits])),
                "frames": self.traced_frames}

    # ----------------------------------------------------------------- check
    def check(self) -> List[tuple]:
        sc, tr = self.config["scene"], self.traffic
        del self.scene
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        raw = make_scene(sc, self.seed, self.device)
        poses = self.order[:tr["checked_frames"]]
        want = reference_frames(raw, self.cams, poses, Ops(), sc["max_tiles"])
        nums = compare(self.got, want, tr["pixel_tol"])
        limits = tr["limits"]
        print("[perfbench] readings " + " ".join(f"{k} {v!r}" for k, v in nums), flush=True)
        return [(k, v, limits[k]) for k, v in nums if k in limits]


def control(config: dict, traffic: dict, seed: int, device, fault: str = "tf32") -> List[tuple]:
    """The check's numbers for the plain reference put in the program's
    place and run in TF32 (`fault="tf32"`, the control)."""
    if fault != "tf32":
        raise ValueError(f"no fault {fault!r} for this cell")
    sc = config["scene"]
    raw = make_scene(sc, seed, device)
    cams, order = make_poses(sc, traffic, seed, device)
    poses = order[:traffic["checked_frames"]]
    got = reference_frames(raw, cams, poses, Ops(tf32=True), sc["max_tiles"])
    want = reference_frames(raw, cams, poses, Ops(), sc["max_tiles"])
    return compare(got, want, traffic["pixel_tol"])


def setup(config: dict, traffic: dict, seed: int, device):
    return RenderCell(config, traffic, seed, device)
