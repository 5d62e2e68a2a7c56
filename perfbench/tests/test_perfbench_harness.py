"""The harness on the CPU at tiny sizes: it finds cells and metrics from
files alone, imports nothing of JAX, runs a cell end to end with `correct`
true, and sees `correct` come out false for the control and for each fault
a cell can have, planted in the timed path underneath."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.layout(tmp_path_factory.mktemp("layout"))


def run(root, cell, trace=False, seconds=1.0):
    return harness.run_cell(harness.load_cell(root, cell), SEED, seconds, trace, CPU,
                            time.perf_counter(), log=lambda s: None)


def test_nothing_imports_jax():
    """Every module of the benchmark imported in a fresh interpreter; the
    top-level names in sys.modules compared whole."""
    mods = ["perfbench.harness", "perfbench.reading", "perfbench.control",
            "perfbench.reference.surfel", "perfbench.reference.train2dgs",
            "perfbench.reference.see3d", "perfbench.counts.raster",
            "perfbench.counts.attention", "perfbench.counts.train_step"]
    code = "\n".join(
        ["import importlib, sys, pathlib", f"sys.path.insert(0, {str(tiny.REPO)!r})"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["from perfbench import harness",
           "root = pathlib.Path(sys.argv[1])",
           "for d in sorted((root / 'perfbench' / 'drivers').glob('*.py')):",
           "    harness.load_module(d, 'd_' + d.stem)",
           "for d in sorted((root / 'perfbench' / 'metrics').glob('*.py')):",
           "    harness.load_module(d, 'm_' + d.stem.replace('.', '_'))",
           "import g4splat_torch.train.trainer, g4splat_torch.pipeline.see3d_stage",
           "print(sorted({m.split('.')[0] for m in sys.modules}))"])
    out = subprocess.run([sys.executable, "-c", code, str(tiny.REPO)], capture_output=True,
                         text=True, check=True).stdout
    names = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert "g4splat_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "g4splat_tpu"}


def test_cells_and_metrics_are_found_from_files(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perfbench" / "metrics" / "entries.train.py").write_text(
        "def read(trace):\n    return trace.counts.get('pairs_per_view')\n")
    bench["per_layer"].append({"name": "entries.train", "unit": "pairs", "better": "lower",
                               "source": "device_trace", "layer": "kernel B1",
                               "moves": "train_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(root, "train_tiny")
    assert cell.config["scene"]["live"] == tiny.TRAIN_SCENE["live"]
    assert cell.traffic["driver"] == "train_2dgs"
    assert {m["name"] for m in cell.end_to_end} == {"train_steps_per_s", "train_step_p95_ms",
                                                    "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"entries.train", "densify_ms.train"} <= names and "unet_call_ms.see3d" not in names
    t = harness.Trace(window_s=1.0, busy_s=0.5, kernels={}, spans={},
                      counts={"pairs_per_view": 7.0})
    assert harness.metric_reader(root, "entries.train")(t) == 7.0
    assert harness.metric_reader(root, "idle_pct.train")(t) == 50.0


def test_a_metric_file_reads_a_program_range(root, monkeypatch):
    """A range the program opens with `record_function` (as
    `utils.profiling.annotate` does) reaches `Trace` from the traced window,
    so a metric file added alone can read it."""
    from torch.profiler import record_function

    from g4splat_torch.train import trainer

    orig = trainer.adam_step

    def adam_step(*a, **kw):
        with record_function("prog:adam"):
            return orig(*a, **kw)

    monkeypatch.setattr(trainer, "adam_step", adam_step)
    (root / "perfbench" / "metrics" / "adam_ms.probe.py").write_text(
        "def read(trace):\n"
        "    v = trace.host_annotations.get('prog:adam')\n"
        "    return sum(v) / len(v) if v else None\n")
    cell = harness.load_cell(root, "train_tiny")
    rec = harness.Recorder(True, CPU)
    state = cell.driver().setup(cell.config, cell.traffic, SEED, CPU)
    state.window(1.0, rec)
    tr = harness.summarize(rec)
    n = state.steps_traced
    assert n > 0 and len(tr.host_annotations["prog:adam"]) == n
    assert len(tr.host_annotations["pb:binning"]) == n
    assert harness.metric_reader(root, "adam_ms.probe")(tr) > 0


def test_the_window_reports_every_step_p95(root):
    out = run(root, "train_tiny")
    p95 = out["metrics"]["train_step_p95_ms"]["value"]
    rate = out["metrics"]["train_steps_per_s"]["value"]
    assert out["attempted"] >= 1 and 0 < p95 <= 1e3 * out["attempted"] / rate


@pytest.mark.parametrize("cell", ["train_tiny", "see3d_tiny"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_correct(root, cell, trace):
    out = run(root, cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in harness.load_cell(root, cell).end_to_end}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["train_tiny", "see3d_tiny"])
def test_the_control_fails_the_check(root, cell):
    c = harness.load_cell(root, cell)
    nums = c.driver().control(c.config, c.traffic, SEED, CPU, "tf32")
    assert any(v > c.traffic["limits"][n] for n, v in nums), nums


def _half_rows(orig):
    def losses_from_render(scene, out, view, *a, **kw):
        h = view["image"].shape[0] // 2
        out = {k: v[:h] if torch.is_tensor(v) and v.ndim >= 2 else v for k, v in out.items()}
        view = {k: v[:h] if v.ndim >= 2 else v for k, v in view.items()}
        return orig(scene, out, view, *a, **kw)
    return losses_from_render


def _altered_render(orig):
    def render(*a, **kw):
        out = orig(*a, **kw)
        out["render"] = out["render"] + 1e-3
        return out
    return render


TRAIN_FAULTS = {
    "state unchanged": ("adam_step", lambda orig: (lambda optimizer, cfg: None)),
    "half of the batch": ("losses_from_render", _half_rows),
    "answer altered": ("render", _altered_render),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_training_fault_fails_the_check(root, monkeypatch, fault):
    from g4splat_torch.train import trainer

    name, plant = TRAIN_FAULTS[fault]
    monkeypatch.setattr(trainer, name, plant(getattr(trainer, name)))
    out = run(root, "train_tiny")
    assert not out["correct"], out["checks"]


def _scaled_unet(orig):
    def forward(self, *a, **kw):
        return orig(self, *a, **kw) * 1.01
    return forward


SEE3D_FAULTS = {
    "state unchanged": ("DDIMSampler", "step", lambda orig: (lambda self, out, t, x: x)),
    "answer altered": ("MultiViewUNet", "forward", _scaled_unet),
}


@pytest.mark.parametrize("fault", sorted(SEE3D_FAULTS))
def test_a_see3d_fault_fails_the_check(root, monkeypatch, fault):
    from g4splat_torch.priors import see3d

    cls, name, plant = SEE3D_FAULTS[fault]
    monkeypatch.setattr(getattr(see3d, cls), name, plant(getattr(getattr(see3d, cls), name)))
    out = run(root, "see3d_tiny")
    assert not out["correct"], out["checks"]


def _bare_layout(tmp_path):
    """BENCHMARK.json and perfbench/ alone."""
    import shutil

    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_run_without_a_card_prints_no_result(tmp_path):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "train_room", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=_bare_layout(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_a_missing_program_stops_the_set_up(tmp_path):
    """Without the program beside it the cell's set-up raises, so the run
    exits with an error before any result."""
    root = _bare_layout(tmp_path)
    code = "\n".join([
        "import sys, pathlib, torch",
        f"sys.path = [p for p in sys.path if p not in ('', {str(tiny.REPO)!r})]",
        f"sys.path.insert(0, {str(root)!r})",
        "from perfbench import harness",
        f"cell = harness.load_cell(pathlib.Path({str(root)!r}), 'train_room')",
        "try:",
        "    cell.driver().setup(cell.config, cell.traffic, 1, torch.device('cpu'))",
        "except ModuleNotFoundError as e:",
        "    print('missing', e.name)"])
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert "missing g4splat_torch" in out.stdout, out.stderr[-2000:]
