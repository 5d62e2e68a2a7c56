"""Helpers the per-layer metric readers share."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple


def device_time(kernels: Dict[str, List[float]], patterns: Sequence[str]) -> Tuple[float, int]:
    """Seconds and launches of the device ops whose names match any of the
    regular expressions (searched anywhere in the name, so templated and
    decorated kernel names are found)."""
    rx = [re.compile(p) for p in patterns]
    secs, n = 0.0, 0
    for name, (s, c) in kernels.items():
        if any(r.search(name) for r in rx):
            secs += s
            n += c
    return secs, n


def mean_span(spans: Dict[str, List[float]], name: str) -> Optional[float]:
    v = spans.get(name)
    return sum(v) / len(v) if v else None


def idle_pct(trace) -> Optional[float]:
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
