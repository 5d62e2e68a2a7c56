"""The frozen counts against counts by hand on tiny scenes and shapes, and
the rasterizer's pairs as a function of the inputs: the same whichever of
the program's CPU routes (dense, tiled) walks the scene."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import attention, raster, train_step
from perfbench.counts.peaks import FP32_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS
from perfbench.reference import see3d as ref3d
from perfbench.reference import surfel
from perfbench.reference.precision import Ops
from perfbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(n, seed, opacity=(0.3, 0.95)):
    g = torch.Generator().manual_seed(seed)
    lo, hi = opacity
    return {"xyz": (torch.rand((n, 3), generator=g) * 2 - 1) * 1.2,
            "features": 0.3 * torch.randn((n, 16, 3), generator=g),
            "opacity": lo + (hi - lo) * torch.rand((n,), generator=g),
            "scaling": torch.exp(-2.6 + 0.6 * torch.rand((n, 2), generator=g)),
            "rotation_raw": torch.randn((n, 4), generator=g)}


CAM = surfel.look_at([0.2, -0.4, -4.0], [0, 0, 0], [0, -1, 0], 40.0, 32, 32, CPU)


def pairs_by_loop(s, cam, max_tiles=16) -> int:
    """Every pixel walked in plain Python: the splats whose first
    `max_tiles` rectangle tiles hold its tile, in depth order; count those
    with alpha ≥ 1/255 before the one that takes T under 1e-4."""
    p = surfel.preprocess(cam, s["xyz"], s["scaling"], s["rotation_raw"], s["opacity"],
                          s["features"], 3, Ops())
    T, c, depth = p.T.numpy().astype(np.float64), p.center.numpy(), p.depth.numpy()
    gx = -(-cam.width // 16)
    x0, y0, x1, y1 = (v.numpy() for v in surfel.tile_rect(p.center, p.radius, gx, gx))
    tiles = {}
    for i in np.nonzero(p.valid.numpy())[0]:
        rw = x1[i] - x0[i]
        for slot in range(min(rw * (y1[i] - y0[i]), max_tiles)):
            tiles.setdefault((y0[i] + slot // rw) * gx + x0[i] + slot % rw, []).append(i)
    total = 0
    for py in range(cam.height):
        for px in range(cam.width):
            walk = sorted(tiles.get((py // 16) * gx + px // 16, []), key=lambda i: (depth[i], i))
            t = 1.0
            for i in walk:
                k = px * T[i, 2] - T[i, 0]
                l = py * T[i, 2] - T[i, 1]
                q = np.cross(k, l)
                if abs(q[2]) < 1e-20:
                    continue
                u, v = q[0] / q[2], q[1] / q[2]
                rho = min(u * u + v * v, 2.0 * ((c[i, 0] - px) ** 2 + (c[i, 1] - py) ** 2))
                z = (u * T[i, 2, 0] + v * T[i, 2, 1] + T[i, 2, 2] if u * u + v * v <= rho
                     else T[i, 2, 2])
                a = min(float(s["opacity"][i]) * np.exp(-0.5 * rho), 0.99)
                if z < surfel.NEAR or a < 1.0 / 255.0:
                    continue
                if t * (1 - a) < 1e-4:
                    break
                t *= 1 - a
                total += 1
    return total


@pytest.mark.parametrize("seed,opacity", [(0, (0.3, 0.95)), (1, (0.005, 0.02))])
def test_pairs_match_a_count_by_hand(seed, opacity):
    s = scene(60, seed, opacity)
    with torch.no_grad():
        got = int(surfel.render(CAM, s, 3, Ops())["n_pairs"].sum())
    assert got > 0
    # Rounding can move alpha across 1/255 at a pixel or two.
    assert abs(got - pairs_by_loop(s, CAM)) <= max(2, got // 500)


def port_pairs(s, cam, route: str) -> int:
    """The contributing pairs as the program's dense oracle or its tiled
    route walks them."""
    from g4splat_torch.core.cameras import make_camera
    from g4splat_torch.ops.rasterize_common import alpha_depth, preprocess, tile_rect
    from g4splat_torch.ops.rasterize_dense import composite
    from g4splat_torch.ops.rasterize_tiled import bin_splats

    pc = make_camera(cam.w2c, float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                     cam.width, cam.height, device="cpu")
    p = preprocess(pc, s["xyz"], s["scaling"], s["rotation_raw"], s["opacity"][:, None],
                   s["features"], 3)
    bg = torch.zeros(3)
    if route == "dense":
        order = torch.argsort(torch.where(p.valid, p.depth, torch.inf), stable=True)
        ps = p.index(order)
        ys, xs = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32),
                                torch.arange(cam.width, dtype=torch.float32), indexing="ij")
        px, py = xs.reshape(-1), ys.reshape(-1)
        a, d = alpha_depth(ps.T, ps.center, ps.opacity, ps.valid, px, py)
        gx = -(-cam.width // 16)
        x0, y0, x1, y1 = tile_rect(ps.center, ps.radius, gx, gx)
        tx, ty = (px / 16).to(torch.int32)[None], (py / 16).to(torch.int32)[None]
        a = torch.where((tx >= x0[:, None]) & (tx < x1[:, None]) & (ty >= y0[:, None])
                        & (ty < y1[:, None]), a, 0.0)
        out = composite(a, d, ps.rgb, ps.normal, bg)
        k = torch.arange(a.shape[0])[:, None]
        return int(((a > 0) & (k < out.stop_at[None])).sum())
    b = bin_splats(p, cam.width, cam.height)
    gx = -(-cam.width // 16)
    total = 0
    for t in range(b.tile_start.numel()):
        ids = b.gauss_id[b.tile_start[t]:b.tile_start[t] + b.tile_count[t]].long()
        if not ids.numel():
            continue
        ly, lx = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
        px, py = lx.reshape(-1) + (t % gx) * 16, ly.reshape(-1) + (t // gx) * 16
        a, d = alpha_depth(p.T[ids], p.center[ids], p.opacity[ids], p.valid[ids], px, py)
        out = composite(a, d, p.rgb[ids], p.normal[ids], bg)
        k = torch.arange(a.shape[0])[:, None]
        total += int(((a > 0) & (k < out.stop_at[None])).sum())
    return total


@pytest.mark.parametrize("route", ["dense", "tiled"])
def test_pairs_are_a_function_of_the_inputs(route):
    s = scene(80, 4)
    with torch.no_grad():
        got = int(surfel.render(CAM, s, 3, Ops())["n_pairs"].sum())
        want = port_pairs(s, CAM, route)
    assert abs(got - want) <= max(2, got // 500)


def test_raster_work_by_hand():
    ops, nbytes = raster.b1_work(pairs=10, splats=3, entries=5, width=32, height=16, dist=False)
    assert ops == 10 * 58
    assert nbytes == 3 * 72 + 4 * 5 + 8 * 2 + 4 * 32 * 16 * 9
    ops, nbytes = raster.b2_work(pairs=10, splats=3, entries=5, width=32, height=16, dist=True)
    assert ops == 10 * (125 + 32)
    assert nbytes == 3 * 144 + 4 * 5 + 8 * 2 + 8 * 32 * 16 * 10
    assert raster.b1_least_s(10, 3, 5, 32, 16, False) == max(
        580 / FP32_FLOPS, (3 * 72 + 20 + 16 + 4 * 32 * 16 * 9) / HBM_BYTES_PER_S)


def test_step_flops_by_hand():
    want = (10 * 58 + 10 * 125 + 2 * (292 + 584) + 16 * 16 * train_step.PIXEL_LOSS_OPS
            + 2 * 59 * 12)
    assert train_step.step_flops(10, 2, 5, 16, 16, False) == want


def test_attention_work_by_hand():
    assert attention.attention_work(1, 2, 3, 1, 4) == (96.0, 4.0 * (16 + 24))
    assert attention.least_s((2, 8, 8, 2, 64)) == max(
        4 * 2 * 2 * 8 * 8 * 64 / TF32_FLOPS, 4 * (2 * 2 * 8 * 2 * 64 * 2) / HBM_BYTES_PER_S)


def test_unet_launches_at_full_width():
    cfg = tiny.config("see3d_mvdream_sd21")["models"]["unet"]
    launches = attention.unet_launches(cfg, frames=9, branches=2, latent=64, n_ctx=77)
    assert len(launches) == 32
    assert launches[0] == (2, 9 * 64 * 64, 9 * 64 * 64, 5, 64)
    assert launches[1] == (18, 64 * 64, 77, 5, 64)
    assert (2, 9 * 64, 9 * 64, 20, 64) in launches          # the middle block, 8 × 8
    assert attention.attention_work(*launches[0])[0] == 4 * 2 * 5 * 36864 ** 2 * 64


def test_flop_counter_counts_attention_by_the_rule():
    q = torch.empty((1, 8, 2, 4), device="meta")
    k = torch.empty((1, 6, 2, 4), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref3d.attention(q, k, k, Ops())
    assert fc.get_total_flops() == 4 * 1 * 2 * 8 * 6 * 4
