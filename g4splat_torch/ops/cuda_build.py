"""Builds the port's CUDA sources (`g4splat_torch/csrc/*.cu`) into plain-C
shared libraries with nvcc and loads them with ctypes.

Each source compiles on its own (seconds, no PyTorch headers) into
``build/kernels/`` at the repository root, under a name that carries a hash of
the source, every header beside it (``csrc/*.cuh``), the flags and the headers
of every include directory the flags name, so an edited source or header is
never served a stale library.
Nothing is built at import: the first call that needs a kernel builds it.
`KernelInfo` records each kernel's source, the TPU kernel it replaces, and
the launches its wrapper counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("rasterize_fwd", "rasterize_bwd", "attention_fwd", "binning", "preprocess")

_loaded: Dict[str, ctypes.CDLL] = {}


_count_lock = threading.Lock()
_load_lock = threading.Lock()


@dataclass
class KernelInfo:
    """A hand-written kernel and the count of its launches (incremented by
    its wrapper at each launch, and nowhere else; under a lock, since the
    mesh paths launch from several host threads)."""
    name: str
    source: str     # path in the repository
    replaces: str   # file:line of the TPU kernel it replaces
    launches: int = 0

    def count_launch(self):
        with _count_lock:
            self.launches += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")
    return path


def _include_dirs() -> list:
    return [Path(f[2:]) for f in NVCC_FLAGS if f.startswith("-I")]


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    headers = [(CSRC, p) for p in sorted(CSRC.glob("*.cuh"))]
    for d in _include_dirs():
        headers += [(d, p) for p in sorted(d.rglob("*")) if p.suffix in (".h", ".hpp", ".cuh")]
    for base, p in headers:
        h.update(str(p.relative_to(base)).encode() + p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def sass_mma_counts(name: str) -> Dict[str, Dict[str, int]]:
    """Tensor-core instructions per kernel function in the built library of
    `csrc/<name>.cu`, from ``cuobjdump -sass``: {function: {"HMMA": n,
    "HGMMA": n}} (`mma.sync` and `wgmma`)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (looked on PATH and /usr/local/cuda/bin)")
    sass = subprocess.run([tool, "-sass", str(_target(name))], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn and (m := re.search(r"\b(HGMMA|HMMA)\.", line)):
            counts[fn][m.group(1)] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use (once,
    whichever host thread asks first)."""
    with _load_lock:
        if name not in _loaded:
            build_all((name,))
            _loaded[name] = ctypes.CDLL(str(_target(name)))
        return _loaded[name]
