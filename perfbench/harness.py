"""The benchmark's machinery: it finds a cell's files by name, runs the cell
once, reads its trace and prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own under `perfbench/`, found by the name
that `BENCHMARK.json` gives it:

- `configs/<config>.json`: the configuration as it is run;
- `workloads/<traffic>.json`: the traffic mix, naming the driver that
  reads it and its parameters;
- `drivers/<driver>.py`: `setup(config, traffic, seed, device)` builds the
  cell and returns an object with `window(seconds, rec)`, `counts()` and
  `check()`;
- `metrics/<metric>.py`: `read(trace)` returns the metric or None.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "g4splat_tpu")
SPAN_PREFIX = "pb:"


# ------------------------------------------------------------------ layout
@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def driver(self):
        return load_module(self.root / "perfbench" / "drivers" / f"{self.traffic['driver']}.py",
                           f"perfbench_driver_{self.traffic['driver']}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its configuration,
    traffic and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "workloads" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, root, int(w["chips"]), config, traffic, e2e, per_layer)


def metric_reader(root: Path, name: str) -> Callable:
    return load_module(root / "perfbench" / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_")).read


# ------------------------------------------------------------------- spans
class Recorder:
    """Spans the drivers record around their calls into the program's
    layers, only while `tracing` (the timed runs record none). `cuda` spans
    are pairs of CUDA events read after the window; `host` spans end in a
    synchronize on both sides."""

    def __init__(self, tracing: bool, device):
        self.tracing = tracing
        self.device = device
        self._pending: List[Tuple[str, Any, Any]] = []
        self.spans: Dict[str, List[float]] = {}
        self.profile = None
        self.labels = None
        self.window_s = 0.0

    @contextlib.contextmanager
    def cuda(self, name: str):
        if not self.tracing:
            yield
            return
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            if self.device.type == "cuda":
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                yield
                b.record()
                self._pending.append((name, a, b))
            else:
                t = time.perf_counter()
                yield
                self.add(name, 1e3 * (time.perf_counter() - t))

    @contextlib.contextmanager
    def host(self, name: str):
        if not self.tracing:
            yield
            return
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            sync(self.device)
            t = time.perf_counter()
            yield
            sync(self.device)
            self.add(name, 1e3 * (time.perf_counter() - t))

    def add(self, name: str, ms: float):
        self.spans.setdefault(name, []).append(ms)

    def resolve(self):
        for name, a, b in self._pending:
            self.add(name, a.elapsed_time(b))
        self._pending.clear()

    @contextlib.contextmanager
    def traced(self, labels: bool = False):
        """Profile the block when tracing: the traced window, with the
        device's activity and the host's `record_function` ranges but none
        of its operations (so the host runs at its own pace), or with
        `labels` a short stretch that records the host's operations too, to
        say what the host did in each idle gap."""
        if not self.tracing:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        t = time.perf_counter()
        prof = profile(activities=acts)
        with contextlib.nullcontext() if labels else _user_ranges_only():
            prof.start()
        try:
            yield
            sync(self.device)
        finally:
            prof.stop()
        if labels:
            self.labels = prof
        else:
            self.window_s = time.perf_counter() - t
            self.profile = prof


@contextlib.contextmanager
def _user_ranges_only():
    """While open, a profiler that starts records of the host only the
    ranges that `record_function` opens (the user scope), not every
    operation: on the card that costs the window about what recording the
    device alone costs, where every host operation slowed a training step
    by more than half."""
    import torch.autograd.profiler as autograd_profiler
    from torch._C._profiler import RecordScope

    enable = autograd_profiler._enable_profiler
    autograd_profiler._enable_profiler = (
        lambda config, activities, scopes=None: enable(config, activities,
                                                       {RecordScope.USER_SCOPE}))
    try:
        yield
    finally:
        autograd_profiler._enable_profiler = enable


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------- trace
@dataclass
class Trace:
    """What a traced run gives the per-layer metrics."""
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]]          # device op → [seconds, launches]
    spans: Dict[str, List[float]]            # span → ms per occurrence
    counts: Dict[str, float] = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)
    # `record_function` ranges of the traced window, the program's own and
    # the drivers' (`pb:<span>`), name → ms per occurrence: as the device's
    # timeline holds them (first to last operation launched inside), and
    # on the host's clock where the profile recorded the host.
    annotations: Dict[str, List[float]] = field(default_factory=dict)
    host_annotations: Dict[str, List[float]] = field(default_factory=dict)


def _events(prof):
    """(name, start_us, end_us) of every operation that ran on the device,
    of every host operation (ranges included), and of the `record_function`
    ranges on the device's timeline and on the host's."""
    from torch.autograd import DeviceType

    dev, host, dev_ranges, host_ranges = [], [], [], []
    if prof is not None:
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            row = (e.name(), start, start + e.duration_ns() / 1e3)
            on_dev = e.device_type() == DeviceType.CUDA
            if e.is_user_annotation():
                (dev_ranges if on_dev else host_ranges).append(row)
            if not on_dev:
                host.append(row)
            elif not e.is_user_annotation() and row[2] > row[1]:
                dev.append(row)
    return dev, host, dev_ranges, host_ranges


def _by_name(rows) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for n, s, e in rows:
        out.setdefault(n, []).append((e - s) / 1e3)
    return out


def _merged(dev) -> List[List[float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(dev, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(rec: Recorder, top: int = 10) -> Trace:
    """Busy time and device time by op from the traced window's profile;
    the longest idle gaps, labelled by what the host was doing, from the
    labelled stretch."""
    dev, _, dev_ranges, host_ranges = _events(rec.profile)
    kernels: Dict[str, List[float]] = {}
    for n, s, e in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    busy = sum(e - s for s, e in _merged(dev)) / 1e6
    ldev, host, _, _ = _events(rec.labels)
    merged = _merged(ldev)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:top]
    labelled = []
    for length, g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = span = None
        for n, s, e in host:
            if s <= mid <= e:
                if n.startswith(SPAN_PREFIX):
                    if span is None or s > span[0]:
                        span = (s, n[len(SPAN_PREFIX):])
                elif inner is None or s > inner[0]:
                    inner = (s, n)
        label = "/".join(x[1] for x in (span, inner) if x) or "host idle"
        labelled.append([label, length / 1e6])
    ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda r: -r[1])[:top]
    return Trace(window_s=rec.window_s, busy_s=busy, kernels=kernels, spans=rec.spans,
                 breakdown={"device_ops": ops, "idle_gaps": labelled},
                 annotations=_by_name(dev_ranges), host_annotations=_by_name(host_ranges))


# ------------------------------------------------------------------ device
def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------- run
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """Set the cell up, run its window, read its metrics and check what the
    window produced. Returns the result line's object."""
    import torch

    driver = cell.driver()
    rec = Recorder(trace, device)
    state = driver.setup(cell.config, cell.traffic, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[perfbench] {cell.name}: set-up {setup_s:.3f} s")
    if device.type == "cuda":
        for i in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(i)
    window = state.window(seconds, rec)
    sync(device)
    rec.resolve()
    dev = device_info(device, cell.chips)
    metrics: Dict[str, dict] = {}
    if trace:
        tr = summarize(rec)
        tr.counts = state.counts()
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        for m in cell.per_layer:
            v = metric_reader(cell.root, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        log(f"[perfbench] traced window {tr.window_s:.3f} s, device busy {tr.busy_s:.3f} s; "
            f"counts {tr.counts}; ranges on the device "
            f"{ {n: len(v) for n, v in tr.annotations.items()} }, on the host "
            f"{ {n: len(v) for n, v in tr.host_annotations.items()} }")
    else:
        window["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(window[m["name"]]), "unit": m["unit"]}
    t = time.perf_counter()
    checks = state.check()
    log(f"[perfbench] check {time.perf_counter() - t:.3f} s")
    correct = (all(math.isfinite(v) and v <= lim for _, v, lim in checks)
               and int(window["failed"]) == 0)
    out = {"correct": correct, "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = tr.breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out
