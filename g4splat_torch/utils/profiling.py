"""Tracing, stage timing and metric logging (counterpart of
`g4splat_tpu.utils.profiling`).

- `trace(logdir)`: `torch.profiler` over the host and, where a card is
  present, the card (CUPTI); on exit one Chrome trace, `trace_*.json`, is
  written into `logdir` (chrome://tracing or ui.perfetto.dev read it). The
  profiler is yielded, so `key_averages()` can be read inside the block.
- `annotate(name)`: a named host range in the trace
  (`torch.profiler.record_function`).
- `StageTimer`: accumulated host-clock seconds per stage name; with
  `block_on` (a tensor or a device) the card is synchronized before the
  clock is read, so the time includes the queued device work.
- `MetricsLogger`: scalars kept in memory and appended to
  `logdir/metrics.jsonl`, line for line as the JAX package writes them, and
  to TensorBoard when `torch.utils.tensorboard` imports (the reference's
  tqdm EMA + TensorBoard-if-importable logging,
  train_with_refine_depth.py:49-53,667-725).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write its Chrome trace into `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """A named host range, visible in `trace`'s output."""
    return torch.profiler.record_function(name)


def _block(on) -> None:
    dev = on.device if isinstance(on, torch.Tensor) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _block(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1000 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:32s} {v['total_s']:8.2f}s  ×{v['count']:<6d} "
                         f"{v['mean_ms']:8.1f}ms/it")
        return "\n".join(lines)


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None, use_tensorboard: bool = True):
        self.history: List[dict] = []
        self._jsonl = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(logdir)

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self.history.append(rec)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
