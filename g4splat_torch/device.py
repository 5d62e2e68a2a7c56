"""Device selection and arithmetic precision shared by every entry point of
the port."""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises: the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "g4splat_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev


@contextlib.contextmanager
def fp32_math() -> Iterator[None]:
    """Run the block with TF32 off in cuBLAS matmuls and cuDNN convolutions,
    and restore the caller's settings after. The port computes in fp32, as
    the JAX package does; PyTorch lets cuDNN convolutions use TF32 unless
    told otherwise. Usable as a decorator. Kernel B3's TF32 instructions do
    not read these flags: it splits every fp32 operand into two TF32 parts
    and takes three products (3xTF32), which keeps fp32 accuracy."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
