"""Helpers of the per-layer metrics that read the program's own spans: the
`g4s:` ranges that `g4splat_torch.utils.profiling.annotate` opens while a
profiler records, as `Trace.annotations` (the device's timeline) and
`Trace.host_annotations` (the host's clock) hold them, name → ms per
occurrence. Each returns None where the spans are absent, as on a program
that opens none."""

from __future__ import annotations

from typing import Dict, List, Optional

STEP = "g4s:train.step"
CALL = "g4s:see3d.call"
SYNC = "g4s:sync."


def mean(ranges: Dict[str, List[float]], name: str) -> Optional[float]:
    """Mean ms of one occurrence of `name`."""
    v = ranges.get(name)
    return sum(v) / len(v) if v else None


def per(ranges: Dict[str, List[float]], name: str, unit: str) -> Optional[float]:
    """Total ms of `name` over the number of `unit` ranges in the same dict."""
    v, n = ranges.get(name), len(ranges.get(unit, ()))
    return sum(v) / n if v and n else None


def prefixed(ranges: Dict[str, List[float]], prefix: str) -> List[float]:
    """The ms of every occurrence of every range whose name starts with
    `prefix`."""
    return [ms for name, v in ranges.items() if name.startswith(prefix) for ms in v]
