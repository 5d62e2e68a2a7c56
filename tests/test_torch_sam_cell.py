"""The SAM encoder cell (`sam_encode`) on the CPU, at one torch thread and
importing no JAX: the benchmark's plain reference of SAM's image encoder
(`perfbench/reference/sam.py`) against the program, the planted faults the
comparison and the cell's check must catch, the work count, the program's
`g4s:sam.*` spans and `sam.*` counters, and the cell's metric readers.

- `SAMPredictor` at TINY_SAM, and at TINY_SAM with window_size 3 (the 8×8
  grid padded to 9×9, as ViT-H pads 64 to 70), on the benchmark's seeded
  state dict under the checkpoint's key names, loaded with every key: the
  tokens after the first global block and the neck's output within the
  oracle's 5e-5 (tests/test_torch_sam.py) of the reference.
- Planted in the program, each fault moves one of the two by more than
  that: rel_pos_h and rel_pos_w swapped, the global attention one block
  early, the window pad dropped (edge windows cropped, so their keys are
  too), pos_embed left out, the neck's LayerNorm2d eps × 1e4.
- A tiny `sam_encode` through `perfbench.harness.run_cell`: `correct` true,
  traced and not; false for each fault, for the program's linears in TF32
  and for the control (the reference in TF32).
- `counts/sam.py` equals `FlopCounterMode` over the tiny encoders and is
  5.95e12 ± 1 % a view at `SAMConfig()`.
"""

import dataclasses
import json
import time
import types
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from g4splat_torch.priors import sam as S
from g4splat_torch.utils import profiling
from perfbench import harness
from perfbench.counts import sam as counts
from perfbench.drivers import sam_encode as driver
from perfbench.reference import sam as ref
from perfbench.reference.precision import Ops, round_tf32
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
EMB_TOL = 5e-5
FULL = json.loads((ROOT / "perfbench" / "configs" / "sam_vit_h_1024.json").read_text())
TINY_TRAFFIC = {"views": 4, "width": 56, "height": 40, "pool_sets": 2, "max_batch": 2,
                "warmup_seconds": 0, "labelled_views": 2}
METRICS = ("encode_ms.sam", "window_attn_ms.sam", "global_attn_ms.sam", "mlp_ms.sam",
           "attn_roofline.sam", "mfu_pct.sam", "idle_pct.sam", "attn_logit_gb.sam")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(window: int = 4, depth: int = 2) -> dict:
    """TINY_SAM as the configuration file states a model."""
    cfg = dataclasses.asdict(dataclasses.replace(S.TINY_SAM, window_size=window,
                                                 encoder_depth=depth))
    every = cfg["global_attn_every"]
    return dict(cfg, global_attn_indexes=[i for i in range(depth) if (i + 1) % every == 0])


def config(m: dict) -> dict:
    return dict(FULL, model=m)


def views(n: int = 3, seed: int = 0) -> torch.Tensor:
    return torch.rand((n, 40, 56, 3), generator=torch.Generator().manual_seed(seed))


def program_outputs(m: dict, w, imgs):
    """The program's embedding and its tokens after the first global block."""
    p = driver.program(m, w, CPU)
    kept = []
    p.model.image_encoder.blocks[m["global_attn_indexes"][0]].register_forward_hook(
        lambda mod, a, out: kept.append(out))
    emb = p.encode_images(imgs, max_batch=len(imgs))
    return emb, kept[0]


def gaps(m: dict, w, imgs):
    emb, tokens = program_outputs(m, w, imgs)
    with torch.no_grad():
        neck, kept = ref.image_encoder(w, imgs, m, Ops(), keep=m["global_attn_indexes"][:1])
    want = {"tokens": kept[m["global_attn_indexes"][0]], "neck": neck.permute(0, 2, 3, 1)}
    got = {"tokens": tokens, "neck": emb}
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in got}


# ------------------------------------------------------------------ faults
def _swap_rel_pos(monkeypatch):
    orig = S._rel_pos_bias
    monkeypatch.setattr(S, "_rel_pos_bias",
                        lambda hw, rel_h, rel_w, q, heads: orig(hw, rel_w, rel_h, q, heads))


def _encoder_forward(monkeypatch, early: bool, pos: bool):
    def forward(self, x):
        h = self.patch_embed(x)
        if pos:
            h = h + self.pos_embed
        order = list(range(len(self.blocks)))
        for i, blk in enumerate(self.blocks):
            if early and blk.window == 0 and i > 0:
                order[i - 1], order[i] = i, i - 1
        for i in order:
            h = self.blocks[i](h)
        return self.neck(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    monkeypatch.setattr(S.ImageEncoder, "forward", forward)


def _global_one_early(monkeypatch):
    """Each global block runs one index early, before the windowed block
    ahead of it."""
    _encoder_forward(monkeypatch, early=True, pos=True)


def _no_pos_embed(monkeypatch):
    _encoder_forward(monkeypatch, early=False, pos=False)


def _cropped_windows(monkeypatch):
    """Windows cut at the grid's edge instead of padded: the edge windows
    attend over their own tokens only, with the rel-pos tables' centre rows."""
    orig = S.WindowBlock.forward

    def forward(self, x):
        ws, a = self.window, self.attn
        if not ws:
            return orig(self, x)
        h = self.norm1(x)
        att = torch.empty_like(h)
        for i in range(0, h.shape[1], ws):
            for j in range(0, h.shape[2], ws):
                t = h[:, i:i + ws, j:j + ws]
                th, tw = t.shape[1:3]
                crop = types.SimpleNamespace(
                    qkv=a.qkv, proj=a.proj, heads=a.heads, span=a.span, grid=(th, tw),
                    rel_pos_h=a.rel_pos_h[ws - th:ws + th - 1],
                    rel_pos_w=a.rel_pos_w[ws - tw:ws + tw - 1])
                out = S.EncoderAttention.forward(crop, t.reshape(t.shape[0], th * tw, -1))
                att[:, i:i + th, j:j + tw] = out.reshape(t.shape)
        x = x + att
        return x + self.mlp(self.norm2(x))

    monkeypatch.setattr(S.WindowBlock, "forward", forward)


def _neck_eps(monkeypatch):
    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + 1e4 * self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]

    monkeypatch.setattr(S.LayerNorm2d, "forward", forward)


def _tf32(monkeypatch):
    """The program's linear layers rounding both operands to TF32."""
    monkeypatch.setattr(torch.nn.Linear, "forward",
                        lambda self, x: torch.nn.functional.linear(
                            round_tf32(x), round_tf32(self.weight), self.bias))


FAULTS = [_swap_rel_pos, _global_one_early, _cropped_windows, _no_pos_embed, _neck_eps]


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("window", [4, 3], ids=["tiny", "padded"])
def test_reference_matches_the_program(window):
    m = model(window)
    w = driver.reference_weights(config(m), 5, CPU)
    p = driver.program(m, w, CPU)
    sd = p.model.state_dict()
    assert set(sd) == set(w) and all(sd[k].shape == w[k].shape for k in w)
    for k, gap in gaps(m, w, views()).items():
        assert gap < EMB_TOL, k


@pytest.mark.parametrize("fault", FAULTS)
def test_the_comparison_catches_a_fault(monkeypatch, fault):
    m = model(window=3)
    w = driver.reference_weights(config(m), 5, CPU)
    fault(monkeypatch)
    assert max(gaps(m, w, views()).values()) > EMB_TOL


def test_the_published_model_is_the_programs():
    """The configuration is `SAMConfig()` (ViT-H, global blocks 7/15/23/31);
    the reference's leaves are the program's state dict there, key for key
    and shape for shape; the parameter counts are the file's."""
    m = FULL["model"]
    assert driver.sam_config(m) == S.SAMConfig()
    assert m["global_attn_indexes"] == [7, 15, 23, 31]
    with torch.device("meta"):
        sd = S.SAM(S.SAMConfig()).state_dict()
    leaves = ref.shapes(m)
    assert {k: tuple(v.shape) for k, v in sd.items()} == dict(leaves)
    assert sum(v.numel() for v in sd.values()) == FULL["parameters"]
    assert sum(v.numel() for k, v in sd.items()
               if k.startswith("image_encoder.")) == FULL["encoder_parameters"]


# ------------------------------------------------------------------- work
@pytest.mark.parametrize("window", [4, 3], ids=["tiny", "padded"])
def test_work_count_equals_flop_counter(window):
    m = model(window, depth=4)
    p = S.SAMPredictor(driver.sam_config(m), seed=0, device=CPU)
    x = S.resize_bilinear(views(1), (m["img_size"],) * 2)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        p.model.image_encoder(x)
    assert fc.get_total_flops() == counts.view_flops(m)["total"]


def test_work_at_published_width():
    f = counts.view_flops(FULL["model"])
    assert abs(f["total"] / 5.95e12 - 1) < 0.01
    assert counts.attention_flops(FULL["model"], 2) == 2 * f["attention"]
    # Linear in the views but for the rel-pos tables, read once a call.
    assert 0 < counts.attention_least_s(FULL["model"], 10) == pytest.approx(
        10 * counts.attention_least_s(FULL["model"], 1), rel=1e-3)


# ------------------------------------------------------- spans, counters
def logit_bytes(m: dict, n_views: int) -> int:
    g = m["img_size"] // m["patch_size"]
    ws = m["window_size"]
    windows = (-(-g // ws)) ** 2
    n_global = len(m["global_attn_indexes"])
    per_view = ((m["encoder_depth"] - n_global) * windows * ws ** 4 + n_global * g ** 4)
    return 4 * m["encoder_heads"] * per_view * n_views


def test_spans_and_counters_under_the_recorder():
    m = model(window=3, depth=4)
    p = S.SAMPredictor(driver.sam_config(m), seed=0, device=CPU)
    profiling.reset_counters()
    rec = harness.Recorder(True, CPU)
    with rec.traced():
        p.encode_images(views(3), max_batch=2)
    rows = [r for r in harness._events(rec.profile)[3] if r[0].startswith("g4s:sam.")]
    seen = {}
    for n, _, _ in rows:
        seen[n] = seen.get(n, 0) + 1
    calls, depth, n_global = 2, m["encoder_depth"], len(m["global_attn_indexes"])
    assert seen == {"g4s:sam.encode": calls, "g4s:sam.attn.window": calls * (depth - n_global),
                    "g4s:sam.attn.global": calls * n_global, "g4s:sam.mlp": calls * depth}
    encodes = [(s, e) for n, s, e in rows if n == "g4s:sam.encode"]
    assert all(any(s0 <= s and e <= e0 for s0, e0 in encodes) for n, s, e in rows)
    c = profiling.counters()
    assert c["sam.images"] == 3
    assert c["sam.attn_logit_bytes"] == logit_bytes(m, 3)
    profiling.reset_counters()


def test_without_a_profiler_nothing_counts_and_the_embedding_is_the_same():
    m = model(window=3, depth=4)
    p = S.SAMPredictor(driver.sam_config(m), seed=0, device=CPU)
    profiling.reset_counters()
    plain = p.encode_images(views(3), max_batch=2)
    assert profiling.counters() == {}
    with torch.profiler.profile():
        traced = p.encode_images(views(3), max_batch=2)
    assert profiling.counters()["sam.images"] == 3
    assert torch.equal(plain, traced)
    profiling.reset_counters()


# --------------------------------------------------------------- the cell
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """`tiny.layout`'s benchmark with `sam_tiny`: `sam_encode` on the padded
    tiny model and 4 views at 56×40."""
    root = tiny.layout(tmp_path_factory.mktemp("layout"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["sam_vit_h_1024"]
    cell = {w["name"]: w for w in bench["workloads"]}["sam_encode"]
    path = "perfbench/configs/sam_tiny.json"
    (root / path).write_text(json.dumps(config(model(window=3))))
    bench["configs"].append(dict(conf, name="sam_tiny", file=path))
    mixes = root / "perfbench" / "workloads"
    traffic = json.loads((mixes / "plane_views_10.json").read_text())
    (mixes / "sam_tiny.json").write_text(json.dumps(dict(traffic, **TINY_TRAFFIC)))
    bench["workloads"].append(dict(cell, name="sam_tiny", config="sam_tiny", traffic="sam_tiny"))
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "sam_encode" in m.get("workloads", []):
                m["workloads"].append("sam_tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, trace=False):
    return harness.run_cell(harness.load_cell(root, "sam_tiny"), SEED, 0.3, trace, CPU,
                            time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_correct(root, trace):
    profiling.reset_counters()
    out = run(root, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] % 4 == 0 and out["attempted"] > 0
    if trace:
        # On the CPU there is no device timeline: the readers of the
        # program's device-side spans and of busy time give nothing.
        assert set(out["metrics"]) == {"encode_ms.sam", "mfu_pct.sam", "attn_logit_gb.sam"}
        want = logit_bytes(model(window=3), 1) / 1e9
        assert out["metrics"]["attn_logit_gb.sam"]["value"] == pytest.approx(want)
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert set(out["metrics"]) == {"prior_items_per_s", "setup_s"}
    profiling.reset_counters()


def test_the_control_fails_the_check(root):
    cell = harness.load_cell(root, "sam_tiny")
    nums = cell.driver().control(cell.config, cell.traffic, SEED, CPU, "tf32")
    limits = cell.traffic["limits"]
    assert any(v > limits[n] for n, v in nums), nums


@pytest.mark.parametrize("fault", FAULTS + [_tf32])
def test_a_fault_fails_the_check(root, monkeypatch, fault):
    fault(monkeypatch)
    out = run(root)
    assert not out["correct"], out["checks"]


# ---------------------------------------------------------------- readers
def _trace(**kw) -> harness.Trace:
    return harness.Trace(**dict(dict(window_s=0.0, busy_s=0.0, kernels={}, spans={}), **kw))


SPANS = {"g4s:sam.encode": [180.0] * 5, "g4s:sam.attn.window": [1.0] * 140,
         "g4s:sam.attn.global": [5.0] * 20, "g4s:sam.mlp": [4.0] * 160}
TRACES = {
    "encode_ms.sam": (dict(spans={"encode": [350.0, 360.0]}), 355.0),
    "window_attn_ms.sam": (dict(annotations=SPANS), 28.0),
    "global_attn_ms.sam": (dict(annotations=SPANS), 20.0),
    "mlp_ms.sam": (dict(annotations=SPANS), 128.0),
    "attn_roofline.sam": (dict(annotations=SPANS, counts={"attn_least_s": 0.024}), 10.0),
    "mfu_pct.sam": (dict(spans={"traced": [2000.0]}, counts={"window_flops": 49.5e12}), 5.0),
    "idle_pct.sam": (dict(spans={"traced": [2000.0]}, busy_s=1.9), 5.0),
    "attn_logit_gb.sam": (dict(), 6.0),
}


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_reads_its_trace(name):
    read = harness.metric_reader(ROOT, name)
    kw, want = TRACES[name]
    profiling.reset_counters()
    assert read(_trace()) is None
    if name == "attn_logit_gb.sam":
        with torch.profiler.profile():
            profiling.count("sam.images", 2)
            profiling.count("sam.attn_logit_bytes", 12_000_000_000)
    assert read(_trace(**kw)) == pytest.approx(want)
    profiling.reset_counters()
    entry = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    assert entry[name]["workloads"] == ["sam_encode"]
    assert entry[name]["moves"] == "prior_items_per_s"
