"""Builds the port's CUDA sources (`g4splat_torch/csrc/*.cu`) into plain-C
shared libraries with nvcc and loads them with ctypes.

Each source compiles on its own (seconds, no PyTorch headers) into
``build/kernels/`` at the repository root, under a name that carries a hash of
the source and flags, so an edited source is never served a stale library.
Nothing is built at import: the first call that needs a kernel builds it.
`KernelInfo` records each kernel's source, the TPU kernel it replaces, and
the launches its wrapper counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("rasterize_fwd", "rasterize_bwd", "attention_fwd")

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclass
class KernelInfo:
    """A hand-written kernel and the count of its launches (incremented by
    its wrapper at each launch, and nowhere else)."""
    name: str
    source: str     # path in the repository
    replaces: str   # file:line of the TPU kernel it replaces
    launches: int = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source that is not built yet, one nvcc process
    per source, all started together. Returns {name: compiler log} (the
    ``-Xptxas -v`` register / shared-memory / spill report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = {}
    for name in names:
        log = _target(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _loaded:
        build_all((name,))
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]
