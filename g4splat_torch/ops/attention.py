"""Exact attention over long token sequences (counterpart of
`g4splat_tpu.ops.attention`).

The MV-UNet's "3D" self-attention runs over the tokens of all frames of a
branch jointly (B=2, H=5, D=64, N=M=36864 at 512 px with 9 frames), where the
(N, M) logits would take tens of GB. Every function here takes and returns
``(B, N, H, D)`` queries and ``(B, M, H, D)`` keys and values, as
``jax.nn.dot_product_attention`` does.

* `dot_product_attention_plain` — dense softmax(QKᵀ/√D)V.
* `chunked_attention` — the same function as an online softmax over
  (q_chunk, kv_chunk) logits tiles, exact up to float associativity.
* `memory_efficient_attention` — the entry point. Tensors on a CUDA device
  go to kernel B3 (`attention_cuda.attention_fwd`) at every size, since the
  kernel never materialises the logits. On the CPU it routes as the JAX
  package does: dense up to `_DENSE_LOGITS_LIMIT` logits, chunked above.

The plain versions accept bf16 (or any float type) and accumulate in f32;
the result comes back in q's type.
"""

from __future__ import annotations

import torch

# As g4splat_tpu/ops/attention.py: the chunked path takes over once the full
# (B, H, N, M) logits exceed this many elements.
_DENSE_LOGITS_LIMIT = 4096 * 4096
_Q_CHUNK = 1024
_KV_CHUNK = 2048
_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def dot_product_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Dense softmax(QKᵀ/√D)V in f32; (B, N, H, D) in q's dtype."""
    D = q.shape[-1]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / (D ** 0.5)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_chunk: int = _Q_CHUNK, kv_chunk: int = _KV_CHUNK) -> torch.Tensor:
    """Exact attention with at most (B, H, q_chunk, kv_chunk) live logits.

    The online softmax of the JAX `chunked_attention`: q is scaled by 1/√D,
    padded keys are masked to `_NEG_INF` (finite, so exp(m_old − m_new)
    never makes a NaN), and the sum is floored at 1e-30.
    """
    B, N, H, D = q.shape
    M = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    out = torch.empty((B, N, H, D), dtype=torch.float32, device=q.device)
    kf = k.float().permute(0, 2, 1, 3)          # (B, H, M, D)
    vf = v.float().permute(0, 2, 1, 3)
    for n0 in range(0, N, q_chunk):
        qc = q[:, n0:n0 + q_chunk].float().permute(0, 2, 1, 3) * scale
        nq = qc.shape[2]
        m = torch.full((B, H, nq), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, nq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, nq, D), dtype=torch.float32, device=q.device)
        for m0 in range(0, M, kv_chunk):
            s = qc @ kf[:, :, m0:m0 + kv_chunk].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, :, m0:m0 + kv_chunk]
            m = m_new
        out[:, n0:n0 + nq] = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def memory_efficient_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """softmax(QKᵀ/√D)V for (B, N, H, D) queries and (B, M, H, D) keys/values.

    On CUDA tensors: kernel B3, or it raises. On CPU tensors: the JAX
    package's routing, dense up to `_DENSE_LOGITS_LIMIT` logits, chunked
    above.
    """
    if q.device.type == "cuda":
        from g4splat_torch.ops.attention_cuda import attention_fwd

        return attention_fwd(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    B, N, H, _ = q.shape
    if B * H * N * k.shape[1] <= _DENSE_LOGITS_LIMIT:
        return dot_product_attention_plain(q, k, v)
    return chunked_attention(q, k, v)
