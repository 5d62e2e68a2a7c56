"""Image, depth-map and mask files of the reference's on-disk zoo
(counterpart of `g4splat_tpu.io.images`): `rgb_frame*.png`,
`depth_frame*.tiff` (float32 TIFF), `*_normal_*.npy`, `visibility_frame*.npy`,
`confident_map_frame*.png`; and the scene photos the CLI reads.

PNG is encoded with the standard library (zlib + struct): 8-bit grey, RGB or
RGBA, filter type 0, so the port needs no imaging package. Float images are
clipped to [0, 1], scaled by 255 and truncated to uint8, as the JAX package
writes them. `read_png` reads back what `save_image` writes. Depth maps are
float32 TIFFs written by the port's own encoder (uncompressed, one strip,
little-endian, SampleFormat IEEE float), which imaging libraries read as a
mode "F" image; `load_depth_tiff` reads those and any uncompressed float32
single-channel TIFF in strips (as PIL writes them). Masks are 8-bit grey PNGs
of 0 / 255. `load_image` decodes PNGs as `save_image` writes them itself
and hands other files (JPEG, PNGs with row filters) to Pillow, imported
when such a file comes.

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


def load_image(path: str) -> np.ndarray:
    """An image file → (H, W, 3) float32 in [0, 1], as Pillow's
    ``convert("RGB")`` gives it: grey repeated, alpha dropped."""
    try:
        arr = read_png(path)
    except ValueError:
        from PIL import Image

        arr = np.asarray(Image.open(path).convert("RGB"))
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3].astype(np.float32) / 255.0


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_mask_png(path: str, mask) -> None:
    """(H, W) mask → 8-bit grey PNG, 255 where mask > 0."""
    save_image(path, (_np(mask) > 0).astype(np.uint8) * 255)


def load_mask_png(path: str) -> np.ndarray:
    return read_png(path) > 127


# TIFF tags: ImageWidth, ImageLength, BitsPerSample, Compression,
# PhotometricInterpretation, StripOffsets, SamplesPerPixel, RowsPerStrip,
# StripByteCounts, SampleFormat.
_TIFF_TAGS = (256, 257, 258, 259, 262, 273, 277, 278, 279, 339)
_TIFF_TYPES = {3: ("H", 2), 4: ("I", 4)}       # SHORT, LONG


def encode_depth_tiff(depth) -> bytes:
    """(H, W) float → float32 TIFF bytes: little-endian, uncompressed, one
    strip, one sample per pixel."""
    arr = np.ascontiguousarray(_np(depth), dtype="<f4")
    if arr.ndim != 2:
        raise ValueError(f"a depth TIFF takes an (H, W) map, got {arr.shape}")
    h, w = arr.shape
    n_tags = len(_TIFF_TAGS)
    ifd_size = 2 + 12 * n_tags + 4
    data_off = 8 + ifd_size
    values = {256: (4, w), 257: (4, h), 258: (3, 32), 259: (3, 1), 262: (3, 1),
              273: (4, data_off), 277: (3, 1), 278: (4, h), 279: (4, arr.nbytes),
              339: (3, 3)}
    ifd = [struct.pack("<H", n_tags)]
    for tag in _TIFF_TAGS:
        typ, val = values[tag]
        fmt, _ = _TIFF_TYPES[typ]
        ifd.append(struct.pack("<HHI", tag, typ, 1) + struct.pack("<" + fmt, val).ljust(4, b"\0"))
    ifd.append(struct.pack("<I", 0))
    return b"II*\0" + struct.pack("<I", 8) + b"".join(ifd) + arr.tobytes()


def save_depth_tiff(path: str, depth) -> None:
    with open(path, "wb") as f:
        f.write(encode_depth_tiff(depth))


def load_depth_tiff(path: str) -> np.ndarray:
    """An uncompressed float32 single-channel TIFF (either byte order, any
    number of strips) → (H, W) float32. Other TIFFs are refused."""
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a TIFF")
    off = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[off:off + 2])[0]
    tags = {}
    for i in range(n):
        e = data[off + 2 + 12 * i: off + 14 + 12 * i]
        tag, typ, count = struct.unpack(order + "HHI", e[:8])
        if typ not in _TIFF_TYPES:
            continue
        fmt, size = _TIFF_TYPES[typ]
        raw = e[8:12] if count * size <= 4 else data[
            struct.unpack(order + "I", e[8:12])[0]:][:count * size]
        tags[tag] = struct.unpack(order + fmt * count, raw[:count * size])
    w, h = tags[256][0], tags[257][0]
    if (tags.get(258, (1,))[0] != 32 or tags.get(259, (1,))[0] != 1
            or tags.get(277, (1,))[0] != 1 or tags.get(339, (1,))[0] != 3):
        raise ValueError(f"{path}: only uncompressed float32 single-channel TIFFs")
    body = b"".join(data[o:o + c] for o, c in zip(tags[273], tags[279]))
    return np.frombuffer(body, order + "f4", count=h * w).reshape(h, w).astype(np.float32)


_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()
_PENDING: List[Future] = []


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="g4io")
        return _POOL


def _submit(fn) -> None:
    _PENDING.append(_pool().submit(fn))


def save_image_async(path: str, img) -> None:
    """`save_image` on the I/O pool; the image is copied to the host first."""
    arr = to_uint8(img)
    _submit(lambda: save_image(path, arr))


def save_mask_png_async(path: str, mask) -> None:
    arr = (_np(mask) > 0).astype(np.uint8) * 255
    _submit(lambda: save_image(path, arr))


def save_depth_tiff_async(path: str, depth) -> None:
    arr = np.array(_np(depth), np.float32, copy=True)
    _submit(lambda: save_depth_tiff(path, arr))


def save_npy_async(path: str, arr) -> None:
    arr = np.array(_np(arr), copy=True)
    _submit(lambda: np.save(path, arr))


def flush_io() -> None:
    """Wait for every queued write; re-raise the first error."""
    pending, _PENDING[:] = _PENDING[:], []
    for fut in pending:
        fut.result()
