"""The arithmetic the plain references run in, and the control's.

Every matrix product and convolution of a reference goes through an `Ops`.
`Ops()` computes in float32 with TF32 off. `Ops(tf32=True)` is the control
of the benchmark's checks: the same reference in the next precision below
the one the configurations state. It rounds both operands of every product
and convolution to TF32 (10 explicit mantissa bits, round to nearest even)
and accumulates in float32, which is what the card's TF32 tensor cores do,
so the control reads the same on the card and on the CPU. Gradients pass
the rounding unchanged, so a backward pass runs its products in float32
from the rounded operands.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F


def _round(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    # Back into the signed 32-bit range before reinterpreting the bits.
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32).reshape(x.shape)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` (float32) rounded to the nearest TF32 value, ties to even."""
    return _RoundTF32.apply(x)


class Ops:
    """Products and convolutions in float32 (TF32 off), or in TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def einsum(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self.r(x) for x in xs])

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.r(x), self.r(w), b, **kw)


@contextlib.contextmanager
def fp32_flags() -> Iterator[None]:
    """TF32 off in cuBLAS and cuDNN for the block, restored after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
