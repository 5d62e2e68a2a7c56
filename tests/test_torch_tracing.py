"""The port's spans and counters (`g4splat_torch.utils.profiling`) on the CPU,
and the benchmark's per-layer metrics that read them.

- Under the benchmark's traced recorder (`perfbench.harness.Recorder`), two
  steps of a tiny `Trainer` on the cuda backend (its plain versions on CPU
  tensors), the second densifying and syncing its metrics, open every
  training span, each inside the span it belongs to and in the step's
  order, and count their binnings' entries. Without a profiler no `g4s:`
  span is entered and no counter moves.
- Each call on the training path that blocks the host until the card's
  queue drains (a read from the card, a copy to it from pageable memory)
  opens its own `g4s:sync.` span, once per call.
- A tiny `run_see3d_inpaint` in two groups opens `g4s:see3d.call` once, two
  `g4s:see3d.vae` per group and one `g4s:see3d.unet` per timestep.
- Each metric file that reads them returns its number from a synthetic
  `Trace`, and None where its spans are absent.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from g4splat_torch.core.cameras import camera_at, lookat_camera, stack_cameras
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops import rasterize_tiled
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig, conic_center, preprocess
from g4splat_torch.pipeline.orchestrator import Priors
from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint
from g4splat_torch.priors import clip_text as TT
from g4splat_torch.priors import clip_vision as TV
from g4splat_torch.priors import see3d as T
from g4splat_torch.priors import vae as TVAE
from g4splat_torch.train import densify, losses
from g4splat_torch.train import trainer as ttr
from g4splat_torch.utils import profiling
from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RES, N_GAUSS, CAPACITY = 24, 30, 64

# Each training span and the span it opens inside.
PARENT = {
    "g4s:render.preprocess": "g4s:train.step",
    "g4s:render.binning": "g4s:train.step",
    "g4s:sync.binning": "g4s:render.binning",
    "g4s:train.losses": "g4s:train.step",
    "g4s:train.backward": "g4s:train.step",
    "g4s:train.adam": "g4s:train.step",
    "g4s:train.densify": "g4s:train.step",
    "g4s:sync.densify": "g4s:train.densify",
    "g4s:sync.metrics": "g4s:train.step",
}
STEP_ORDER = ("g4s:render.preprocess", "g4s:render.binning", "g4s:train.losses",
              "g4s:train.backward", "g4s:train.adam", "g4s:train.densify",
              "g4s:sync.metrics")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_trainer(**cfg) -> ttr.Trainer:
    """A tiny trainer: 30 surfels in 64 slots seen by 2 cameras at 24², its
    images and priors rendered from the scene itself; densify every 2nd
    iteration, with a threshold that keeps the buffer's size."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (N_GAUSS, 2)),
                          rng.uniform(-0.15, 0.15, (N_GAUSS, 1))], 1).astype(np.float32)
    scene = GaussianScene.from_points(pts, rng.uniform(0.2, 1.0, (N_GAUSS, 3)),
                                      capacity=CAPACITY,
                                      scales=np.full(N_GAUSS, 0.15, np.float32),
                                      quats=rng.randn(N_GAUSS, 4), initial_opacity=0.6,
                                      device=CPU)
    cams = stack_cameras([lookat_camera([3.0 * np.sin(a), 0.2, -3.0 * np.cos(a)], [0, 0, 0],
                                        [0, -1, 0], fx=RES, fy=RES, width=RES, height=RES,
                                        device=CPU)
                          for a in (-0.2, 0.2)])
    with torch.no_grad():
        outs = [render(camera_at(cams, v), scene, backend="cuda") for v in range(2)]
    views = ttr.ViewData(image=torch.stack([o["render"] for o in outs]),
                         prior_depth=torch.stack([o["surf_depth"] for o in outs]),
                         prior_normal=torch.stack([o["rend_normal"] for o in outs]),
                         prior_curv=torch.zeros((2, RES, RES)),
                         confidence=torch.ones((2, RES, RES)), color_weight=torch.ones(2),
                         scale_factor=torch.tensor(10.0))
    cfg = ttr.TrainConfig(**{**dict(densify_from_iter=0, densify_until_iter=100,
                                    densification_interval=2, densify_grad_threshold=1.0,
                                    opacity_reset_interval=10_000, use_depth_order=False,
                                    sh_increase_interval=10_000), **cfg})
    return ttr.Trainer(scene, cams, views, cfg)


def host_ranges(fn):
    """`fn()` under the benchmark's traced recorder: its result and the
    host's ranges, (name, start µs, end µs)."""
    rec = harness.Recorder(True, CPU)
    with rec.traced():
        out = fn()
    return out, harness._events(rec.profile)[3]


def g4s(rows):
    return [r for r in rows if r[0].startswith("g4s:")]


def names(rows):
    out = {}
    for n, _, _ in g4s(rows):
        out[n] = out.get(n, 0) + 1
    return out


# ------------------------------------------------------------------ training

def test_a_traced_step_opens_every_span_in_its_place(monkeypatch):
    trainer = make_trainer()
    entries = []
    orig = rasterize_tiled.bin_splats

    def bin_splats(*a, **kw):
        b = orig(*a, **kw)
        entries.append(b.gauss_id.numel())
        return b

    monkeypatch.setattr(rasterize_tiled, "bin_splats", bin_splats)
    before = profiling.counters()

    def two_steps():
        trainer.step(sync_metrics=False)
        return trainer.step(sync_metrics=True)           # iteration 2: densify

    m, rows = host_ranges(two_steps)
    assert np.isfinite(m["loss"])
    # On CPU tensors the plain B1 and B2 find the conic centres again (2 more
    # `g4s:sync.conic` a step than the card's kernels, which do it in place).
    assert names(rows) == {"g4s:train.step": 2, "g4s:render.preprocess": 2,
                           "g4s:render.binning": 2, "g4s:sync.binning": 2,
                           "g4s:train.losses": 2, "g4s:train.backward": 2,
                           "g4s:train.adam": 2, "g4s:train.densify": 1,
                           "g4s:sync.densify": 1, "g4s:sync.metrics": 1,
                           "g4s:sync.c2w": 8, "g4s:sync.ndc2pix": 2, "g4s:sync.conic": 6,
                           "g4s:sync.bg": 2, "g4s:sync.ellipse": 2}
    for name, s, e in g4s(rows):
        if name in PARENT:
            assert any(p == PARENT[name] and ps <= s and e <= pe for p, ps, pe in rows), name
    last = [r for r in rows if r[0] == "g4s:train.step"][-1]
    starts = [min(s for n, s, e in rows if n == name and last[1] <= s and e <= last[2])
              for name in STEP_ORDER]
    assert starts == sorted(starts)
    after = profiling.counters()
    assert after["render.binnings"] - before.get("render.binnings", 0) == 2
    assert (after["render.binned_entries"] - before.get("render.binned_entries", 0)
            == sum(entries) > 0)


def test_without_a_profiler_no_span_is_entered_and_no_counter_moves(monkeypatch):
    entered = []
    rf = torch.autograd.profiler.record_function
    orig = rf.__enter__

    def spy(self):
        entered.append(self.name)
        return orig(self)

    monkeypatch.setattr(rf, "__enter__", spy)
    trainer = make_trainer()
    before = profiling.counters()
    with harness.Recorder(False, CPU).traced():
        trainer.step(sync_metrics=False)
        trainer.step(sync_metrics=True)
    assert not [n for n in entered if n.startswith("g4s:")]
    assert profiling.counters() == before
    assert profiling.annotate("g4s:a") is profiling.annotate("g4s:b")
    with harness.Recorder(True, CPU).traced():
        trainer.step(sync_metrics=False)
    assert "g4s:train.step" in entered and profiling.counters() != before


def test_counters_count_only_while_a_profiler_records(tmp_path):
    profiling.count("test.n", 5)
    assert "test.n" not in profiling.counters()
    with torch.profiler.profile():
        profiling.count("test.n", 5)
        profiling.count("test.n")
    c = profiling.counters()
    assert c["test.n"] == 6
    c["test.n"] = 0
    assert profiling.counters()["test.n"] == 6
    with profiling.trace(str(tmp_path)):
        assert profiling.counters() == {}
        profiling.count("test.n")
    assert profiling.counters() == {"test.n": 1}
    profiling.reset_counters()
    assert profiling.counters() == {}


def _binning(t):
    """A binning of view 0, its splats preprocessed beforehand."""
    s = t.scene
    prep = preprocess(camera_at(t.cameras, 0), xyz=s.xyz, scaling=s.scaling(),
                      rotation_raw=s.rotation_raw, opacity=s.opacity(),
                      features=s.features(), sh_degree=s.active_sh_degree,
                      config=RenderConfig())
    return lambda: rasterize_tiled.bin_splats(prep, RES, RES)


# Each site: a function of a fresh trainer that returns the call to profile,
# and the sync spans that call opens.
SYNC_SITES = {
    "c2w": (lambda t: lambda: t.cameras.c2w, {"g4s:sync.c2w": 1}),
    "ndc2pix": (lambda t: lambda: camera_at(t.cameras, 0).ndc2pix, {"g4s:sync.ndc2pix": 1}),
    "conic": (lambda t: lambda: conic_center(torch.eye(3)[None]), {"g4s:sync.conic": 1}),
    "render": (lambda t: lambda: render(camera_at(t.cameras, 0), t.scene, backend="dense"),
               {"g4s:sync.c2w": 4, "g4s:sync.ndc2pix": 1, "g4s:sync.conic": 1,
                "g4s:sync.bg": 1}),
    "binning": (_binning, {"g4s:sync.ellipse": 1, "g4s:sync.binning": 1}),
    "densify": (lambda t: lambda: t.densify(t.iteration), {"g4s:sync.densify": 1}),
    "grow": (lambda t: lambda: t._grow_capacity(2 * CAPACITY),
             {"g4s:sync.grow": 1, "g4s:sync.compact": 1}),
    "compact": (lambda t: lambda: densify.compact_and_grow(t.scene, CAPACITY + 8),
                {"g4s:sync.compact": 1}),
    "depth_order": (lambda t: lambda: losses.depth_order_loss(
        t.views.prior_depth[0] + 0.1, t.views.prior_depth[0], sample="global",
        generator=torch.Generator().manual_seed(0)), {"g4s:sync.depth_order": 1}),
}


@pytest.mark.parametrize("site", list(SYNC_SITES))
def test_each_blocking_call_opens_its_sync_span(site):
    make_call, want = SYNC_SITES[site]
    call = make_call(make_trainer())
    with torch.no_grad():
        _, rows = host_ranges(call)
    got = {n: c for n, c in names(rows).items() if n.startswith("g4s:sync.")}
    assert got == want


# --------------------------------------------------------------------- See3D

def test_an_inpaint_call_opens_its_spans():
    torch.manual_seed(0)
    steps = 3
    priors = Priors(
        see3d=T.See3DPipeline(T.MultiViewUNet(T.TINY_UNET).eval(),
                              T.DDIMConfig(num_steps=steps)),
        vae=TVAE.AutoencoderKL(16, (1, 2), 4).eval(),
        image_embedder=TV.CLIPImageEmbedder(TV.CLIPVision(
            embed_dim=32, depth=1, num_heads=2, patch_size=56, projection_dim=16).eval()),
        text_embedder=TT.CLIPTextEmbedder(TT.CLIPText(width=16, depth=1, num_heads=2).eval()))
    rng = np.random.RandomState(0)
    images = rng.rand(2, 12, 12, 3).astype(np.float32)
    warps = [rng.rand(12, 12, 3).astype(np.float32) for _ in range(3)]
    masks = [(rng.rand(12, 12) > 0.4).astype(np.float32) for _ in range(3)]
    (outs, _), rows = host_ranges(lambda: run_see3d_inpaint(
        priors, images, 2, warps, masks, 1, mvd_resolution=16, group_size=2, device="cpu"))
    assert len(outs) == 3 and all(bool(torch.isfinite(o).all()) for o in outs)
    groups = 2
    assert names(rows) == {"g4s:see3d.call": 1, "g4s:see3d.vae": 2 * groups,
                           "g4s:see3d.unet": steps * groups}
    call = [r for r in rows if r[0] == "g4s:see3d.call"][0]
    assert all(call[1] <= s and e <= call[2] for _, s, e in g4s(rows))


# ------------------------------------------------------------- metric files

HOST = {"g4s:train.step": [10.0, 12.0], "g4s:render.preprocess": [1.0, 2.0],
        "g4s:train.losses": [0.5, 0.7], "g4s:train.backward": [3.0, 4.0],
        "g4s:train.adam": [1.0, 1.0], "g4s:train.densify": [8.0],
        "g4s:sync.binning": [0.2, 0.4], "g4s:sync.metrics": [0.1],
        "g4s:sync.densify": [0.3], "pb:binning": [5.0, 5.0]}
DEVICE = {"g4s:render.binning": [2.0, 4.0], "g4s:see3d.call": [100.0],
          "g4s:see3d.vae": [7.0, 9.0], "g4s:see3d.unet": [5.0, 6.0, 7.0]}
WANT = {"step_host_ms.train": 11.0, "preprocess_ms.train": 1.5,
        "binning_span_ms.train": 3.0, "losses_ms.train": 0.6, "backward_ms.train": 3.5,
        "adam_ms.train": 1.0, "densify_span_ms.train": 8.0, "host_syncs.train": 2.0,
        "sync_wait_ms.train": 0.5, "unet_span_ms.see3d": 6.0, "vae_span_ms.see3d": 16.0}


def trace(host, dev):
    return harness.Trace(window_s=1.0, busy_s=0.5, kernels={}, spans={},
                         annotations=dev, host_annotations=host)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_span_metric_reads_its_spans(name):
    read = harness.metric_reader(ROOT, name)
    assert read(trace(HOST, DEVICE)) == pytest.approx(WANT[name], rel=1e-12)
    assert read(trace({}, {})) is None
    assert read(trace({"pb:binning": [5.0]}, {"pb:unet_call": [5.0]})) is None


def test_binned_entries_reads_the_counters():
    read = harness.metric_reader(ROOT, "binned_entries.train")
    profiling.reset_counters()
    assert read(trace({}, {})) is None
    with torch.profiler.profile():
        profiling.count("render.binned_entries", 3_000_000)
        profiling.count("render.binnings", 2)
    assert read(trace({}, {})) == pytest.approx(1.5, rel=1e-12)
    profiling.reset_counters()
    assert read(trace({}, {})) is None


def test_binning_kernel_pct_reads_the_counters():
    import json

    read = harness.metric_reader(ROOT, "binning_kernel_pct.train")
    profiling.reset_counters()
    with torch.profiler.profile():
        profiling.count("render.binnings", 4)
    assert read(trace({}, {})) is None            # no kernel counter: a tree without it
    with torch.profiler.profile():
        profiling.count("render.binnings_kernel", 4)
    assert read(trace({}, {})) == pytest.approx(100.0, rel=1e-12)
    profiling.reset_counters()
    assert read(trace({}, {})) is None
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["binning_kernel_pct.train"]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "rasterizer ops", "train_steps_per_s", ["train_room"])


def test_binning_on_cpu_tensors_takes_the_plain_path():
    """On CPU tensors `bin_splats` runs `bin_splats_plain` (same binning,
    exactly): it counts `render.binnings`, never `render.binnings_kernel`,
    and launches no kernel."""
    t = make_trainer()
    s = t.scene
    prep = preprocess(camera_at(t.cameras, 0), xyz=s.xyz, scaling=s.scaling(),
                      rotation_raw=s.rotation_raw, opacity=s.opacity(),
                      features=s.features(), sh_degree=s.active_sh_degree,
                      config=RenderConfig())
    launches = rasterize_tiled.BINNING.launches
    profiling.reset_counters()
    with torch.profiler.profile():
        got = rasterize_tiled.bin_splats(prep, RES, RES)
    c = profiling.counters()
    assert c["render.binnings"] == 1 and "render.binnings_kernel" not in c
    assert c["render.binned_entries"] == got.gauss_id.numel() > 0
    assert rasterize_tiled.BINNING.launches == launches
    ref = rasterize_tiled.bin_splats_plain(prep, RES, RES)
    assert got._fields == ref._fields
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    profiling.reset_counters()


def test_binning_carries_only_the_fields_that_are_read():
    assert rasterize_tiled.Binning._fields == (
        "gauss_id", "tile_id", "tile_start", "tile_count", "n_dropped", "n_overflow")


def test_every_new_metric_is_in_the_benchmark():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in list(WANT) + ["binned_entries.train"]:
        m = entries[name]
        cell = "see3d_inpaint" if name.endswith(".see3d") else "train_room"
        assert m["workloads"] == [cell]
        assert m["source"] == ("program_counter" if name == "binned_entries.train"
                               else "program_span")
        assert (ROOT / "perfbench" / "metrics" / f"{name}.py").is_file()
