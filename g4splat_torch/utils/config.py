"""The named YAML configs under `configs/` and their overlay onto the
stages' dataclasses (counterpart of `g4splat_tpu.utils.config.load_config`
and `apply_overrides`).

Every file under `configs/` is a flat ``key: value`` mapping, and PyYAML is
not a dependency of the port, so `load_config` parses that subset itself:
one ``key: value`` per line, ``#`` comments, and values that are integers,
floats, ``true`` / ``false``, ``null`` / ``~``, plain strings (quotes
stripped) or one-line flow lists of such scalars (``[2, 8, 16]``). A nested,
multi-line or mapping value is refused rather than misread.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict

CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "configs")

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")


def _scalar(text: str) -> Any:
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def _flow_list(text: str, n: int, line: str) -> list:
    """``[a, b, c]`` of scalars on one line."""
    body = text[1:-1].strip() if text.endswith("]") else None
    if body is None or any(c in body for c in "[]{}'\""):
        raise ValueError(f"line {n}: only one-line lists of plain scalars are read: {line!r}")
    return [_scalar(item.strip()) for item in body.split(",")] if body else []


def parse_flat_yaml(text: str) -> Dict[str, Any]:
    """A flat ``key: value`` YAML document → dict."""
    out: Dict[str, Any] = {}
    for n, line in enumerate(text.splitlines(), 1):
        body = line.split(" #", 1)[0].rstrip() if not line.lstrip().startswith("#") else ""
        if not body.strip():
            continue
        if body[0].isspace() or ":" not in body:
            raise ValueError(f"line {n}: only flat 'key: value' lines are read: {line!r}")
        key, value = body.split(":", 1)
        value = value.strip()
        if value[:1] == "[":
            out[key.strip()] = _flow_list(value, n, line)
            continue
        if value[:1] in ("{", "|", ">", "&", "*"):
            raise ValueError(f"line {n}: only scalar values are read: {line!r}")
        out[key.strip()] = _scalar(value)
    return out


def load_config(group: str, name: str = "default") -> Dict[str, Any]:
    """`configs/{group}/{name}.yaml` as a dict (FileNotFoundError if absent)."""
    with open(os.path.join(CONFIG_ROOT, group, f"{name}.yaml")) as f:
        return parse_flat_yaml(f.read())


def apply_overrides(obj, overrides: Dict[str, Any], strict: bool = False):
    """A copy of the dataclass `obj` with the YAML overrides applied; keys
    that are not fields are ignored unless `strict`."""
    fields = {f.name for f in dataclasses.fields(obj)}
    unknown = set(overrides) - fields
    if strict and unknown:
        raise KeyError(f"unknown config keys: {sorted(unknown)}")
    return dataclasses.replace(obj, **{k: v for k, v in overrides.items() if k in fields})
