"""The viewer cell on the CPU at a tiny size: its room is train_room's,
its poses are a Latin hypercube that every seed fills alike, a frame's work
by hand, the tiny cell end to end with `correct` true, and `correct` false
for the control and for each fault planted in the timed path
underneath."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.counts.raster import FWD_OPS_PER_PAIR
from perfbench.counts.render_frame import PIXEL_POST_OPS, frame_flops
from perfbench.counts.train_step import SPLAT_FWD_OPS
from perfbench.drivers import render_2dgs as driver
from perfbench.drivers.train_2dgs import make_problem
from perfbench.tests import tiny, tiny_cells

CPU = torch.device("cpu")
SEED = 2 ** 31 + 53


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.layout(tmp_path_factory.mktemp("layout"))


def run(root, trace=False):
    return harness.run_cell(harness.load_cell(root, "render_tiny"), SEED, 0.5, trace, CPU,
                            time.perf_counter(), log=lambda s: None)


def test_the_room_is_train_rooms():
    sc = dict(tiny.config("room_2dgs")["scene"], **tiny.TRAIN_SCENE)
    raw = driver.make_scene(sc, 7, CPU)
    init = make_problem(sc, 7, CPU)["init"]
    n = sc["live"]
    for k in ("scaling_raw", "rotation_raw"):
        assert torch.equal(raw[k], init[k][:n]), k
    assert float((raw["xyz"] - init["xyz"][:n]).abs().max()) < 6 * sc["jitter"]


def test_every_seed_takes_each_stratum_once():
    sc = tiny.config("room_2dgs")["scene"]
    tr = tiny.traffic("viewer_frames")
    n = tr["poses"]
    for seed in (1, 2 ** 31 + 5):
        cams, order = driver.make_poses(sc, tr, seed, CPU)
        assert sorted(order) == list(range(n))
        eye = torch.stack([-(c.w2c[:3, :3].T @ c.w2c[:3, 3]) for c in cams])
        dist = torch.sqrt(eye[:, 0] ** 2 + eye[:, 2] ** 2).numpy()
        yaw = np.arctan2(eye[:, 0].numpy(), -eye[:, 2].numpy())
        for values, (lo, hi) in ((dist, tr["distance"]), (yaw, tr["yaw"]),
                                 (eye[:, 1].numpy(), tr["height"])):
            k = np.floor((values - lo) / (hi - lo) * n + 1e-4).astype(int)
            assert sorted(k.tolist()) == list(range(n))


def test_frame_work_by_hand():
    ops = frame_flops(1000, 50, 300, 64, 48)
    assert ops == 1000 * FWD_OPS_PER_PAIR + 50 * SPLAT_FWD_OPS + 64 * 48 * PIXEL_POST_OPS


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_correct(root, trace):
    out = run(root, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    if trace:
        # The device's metrics need a card; the host's and the counts' are read.
        assert {"preprocess_ms.render", "copy_ms.render", "host_syncs.render",
                "mfu_pct.render"} <= set(out["metrics"])
        assert all(v["value"] > 0 for v in out["metrics"].values())
        assert out["attempted"] == tiny_cells.RENDER_TRAFFIC["traced_frames"]
    else:
        assert set(out["metrics"]) == {"render_frames_per_s", "render_p95_ms", "setup_s"}
        assert out["attempted"] > 0


def test_the_control_fails_the_check(root):
    cell = harness.load_cell(root, "render_tiny")
    nums = dict(cell.driver().control(cell.config, cell.traffic, SEED, CPU, "tf32"))
    limits = cell.traffic["limits"]
    assert any(nums[n] > v for n, v in limits.items()), nums


def _altered_colour(monkeypatch):
    """Every colour frame's red channel 1 % high where render() makes it."""
    from g4splat_torch.ops import rasterize

    orig = rasterize.render

    def render(*a, **kw):
        out = dict(orig(*a, **kw))
        out["render"] = out["render"] * torch.tensor([1.01, 1.0, 1.0])
        return out

    monkeypatch.setattr(rasterize, "render", render)


def _stale_frame(monkeypatch):
    """Every request after the first answered with the previous one's
    maps."""
    from g4splat_torch.ops import rasterize

    orig = rasterize.render
    last = {}

    def render(*a, **kw):
        out = orig(*a, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    monkeypatch.setattr(rasterize, "render", render)


@pytest.mark.parametrize("fault", [_altered_colour, _stale_frame])
def test_a_fault_fails_the_check(root, monkeypatch, fault):
    fault(monkeypatch)
    out = run(root)
    assert not out["correct"], out["checks"]
    assert math.isfinite(out["metrics"]["render_frames_per_s"]["value"])
