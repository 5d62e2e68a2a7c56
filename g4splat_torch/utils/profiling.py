"""Tracing: spans and counters of the port's layers (counterpart of
`g4splat_tpu.utils.profiling`'s `trace` and `annotate`).

- `trace(logdir)`: `torch.profiler` over the host and, where a card is
  present, the card (CUPTI); on exit one Chrome trace, `trace_*.json`, is
  written into `logdir` (chrome://tracing or ui.perfetto.dev read it). The
  profiler is yielded, so `key_averages()` can be read inside the block.
  The counters are cleared when it starts.
- `annotate(name)`: a named span (`torch.profiler.record_function`),
  entered only while a torch profiler is recording; otherwise one shared
  `contextlib.nullcontext()`, so a run that is not traced pays a flag check
  per span and nothing else. `annotated(name)` is its decorator form, a span
  over a function's whole body. The spans are ranges of the profiler, so kineto
  puts them on the clock of the device trace: in `trace`'s Chrome trace each
  idle gap of the card sits under a named span of the port. On the device's
  timeline kineto gives each kernel to the innermost range open at its launch
  only, so a span meant to carry a layer's device time opens inside the
  layer's own function (`MultiViewUNet.forward`, `AutoencoderKL.encode`),
  beneath any hook or wrapper that opens a range around it. The port's spans
  are named `g4s:<layer>.<stage>`; `g4s:sync.<site>` marks a call that holds
  the host until the card's queue drains (a read from the card, or a copy to
  it from pageable memory).
- `count(name, n)`: adds `n` to a named integer counter, under the same
  condition as `annotate`; `counters()` returns a copy of them and
  `reset_counters()` clears them. They accumulate over every stretch that a
  profiler records, so read them as ratios of counters kept at one site.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict

import torch

_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}


def _recording() -> bool:
    """Whether a torch profiler is recording in this process."""
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write its Chrome trace into `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_counters()
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """A named span, visible in a profiler's trace while one records."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def annotated(name: str):
    """A decorator: the function's every call runs inside `annotate(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while a profiler records."""
    if _recording():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()
