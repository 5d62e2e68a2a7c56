"""Kernel B3, exact attention forward on the card (`csrc/attention_fwd.cu`),
and its wrapper.

B3 replaces `g4splat_tpu/ops/attention.py::_tpu_flash`, the flash-attention
Pallas kernel that ships with JAX. It computes softmax(QKᵀ/√D)V at fp32
accuracy with an online softmax and never materialises the logits. For the
head widths in `TC_HEAD_DIMS` it runs on the tensor cores, every product as
`TF32_PRODUCTS` TF32 products of a hi/lo split of its fp32 operands (3×TF32);
the others run in fp32 on the CUDA cores. What bounds it on an H100:
`FLOPS_PER_PAIR_PER_DIM`·D operations per (query, key) pair, times
`TF32_PRODUCTS` on the tensor cores, and one exp2 per pair, against each of
q, k, v and the output moved once, so the arithmetic binds at every See3D
self-attention shape (PERF.md). No caller differentiates attention (See3D
only runs inference), so B3 has no backward kernel.

`attention_fwd` takes CUDA tensors only: it launches the kernel or raises.
`attention.memory_efficient_attention` is the dispatcher that sends CUDA
tensors here and runs the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from g4splat_torch.ops.cuda_build import KernelInfo

ATTENTION_FWD = KernelInfo(
    name="attention_fwd",
    source="g4splat_torch/csrc/attention_fwd.cu",
    replaces="g4splat_tpu/ops/attention.py:109",
)
HEAD_DIMS = (16, 32, 64, 128)
# Head widths that run on the tensor cores (the rest on the CUDA cores).
TC_HEAD_DIMS = (64,)
# QKᵀ and PV: one multiply and one add per dimension each.
FLOPS_PER_PAIR_PER_DIM = 4
# TF32 products per fp32 product in the 3×TF32 split (lo·hi, hi·lo, hi·hi).
TF32_PRODUCTS = 3


def _check_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, tokens, H, D), got {tuple(t.shape)}")
    B, N, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not form (B, N, H, D) / (B, M, H, D)")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)V, (B, N, H, D) from (B, N, H, D) q and (B, M, H, D)
    k, v on one CUDA device: kernel B3, fp32 only, D in `HEAD_DIMS`."""
    _check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"B3 runs on CUDA tensors only, got {q.device}")
    return _attention_fwd_cuda(q, k, v)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows of D floats as float4: the head dimension must be
    contiguous and every row start 16-byte aligned. Linear outputs reshaped to
    (B, N, H, D) already are; anything else is copied once."""
    if (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _attention_fwd_cuda(q, k, v):
    from g4splat_torch.ops.cuda_build import load

    B, N, H, D = q.shape
    M = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"B3 takes float32 only; {name} is {t.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"B3 is built for head dims {HEAD_DIMS}, got D={D}")
    if B * H > 65535:
        raise ValueError(f"B·H = {B * H} exceeds the grid's y limit 65535")
    if N == 0:
        return torch.empty_like(q)
    if M == 0:
        raise ValueError("attention over zero keys is undefined")
    lib = load("attention_fwd")
    fn = lib.g4_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, N, H, D), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, M, D,
                 ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err}")
    ATTENTION_FWD.count_launch()
    return out
