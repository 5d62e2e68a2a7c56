"""Image writes for render_all and eval (counterpart of the PNG part of
`g4splat_tpu.io.images`).

PNG is encoded with the standard library (zlib + struct): 8-bit grey, RGB or
RGBA, filter type 0, so the port needs no imaging package. Float images are
clipped to [0, 1], scaled by 255 and truncated to uint8, as the JAX package
writes them. `read_png` reads back what `save_image` writes.

`save_image_async` encodes on a small thread pool so that a render loop does
not wait for zlib (the JAX package does the same); the array is copied to
the host before the call returns, so callers may reuse their buffers, and
`flush_io()` waits for every queued write and re-raises the first error.
"""

from __future__ import annotations

import struct
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}          # channels → PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def to_uint8(img) -> np.ndarray:
    """(H, W[, C]) array or tensor → uint8: clip(·, 0, 1) · 255, truncated;
    uint8 input is copied unchanged."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr.copy()
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 1|3|4) → PNG bytes."""
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, got {c}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))


def read_png(path: str) -> np.ndarray:
    """A PNG as `save_image` writes it (8-bit, not interlaced, every row of
    filter type 0) → uint8 (H, W[, C]). Other PNGs are refused."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    off, header, idat = 8, None, []
    while off < len(data):
        n, tag = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        off += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit grey/RGB/RGBA PNGs without interlace")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only PNG filter type 0 is read")
    arr = rows[:, 1:].reshape(h, w, c)
    return arr[..., 0] if c == 1 else arr


_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()
_PENDING: List[Future] = []


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="g4io")
        return _POOL


def save_image_async(path: str, img) -> None:
    arr = to_uint8(img)

    def write():
        with open(path, "wb") as f:
            f.write(encode_png(arr))

    _PENDING.append(_pool().submit(write))


def flush_io() -> None:
    """Wait for every queued write; re-raise the first error."""
    pending, _PENDING[:] = _PENDING[:], []
    for fut in pending:
        fut.result()
