"""Parity of the port's attention (`g4splat_torch.ops.attention`) with
`g4splat_tpu.ops.attention` on the CPU.

The same numpy inputs go through the JAX functions and the port's plain
versions, at the shapes and tolerances of tests/test_attention.py: 2e-5
(f32), 2e-2 (bf16 inputs, f32 accumulation), 1e-4 (±30-scaled logits).
Given CPU tensors, the entry point `memory_efficient_attention` runs the
plain versions and B3's binding refuses them; the kernel itself is held
against the plain version on the card (tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_torch.ops.attention as TA
import g4splat_tpu.ops.attention as JA
from g4splat_torch.ops import attention_cuda


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(B, N, M, H, D, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return tuple((s * rng.randn(B, n, H, D)).astype(np.float32)
                 for n, s in ((N, scale), (M, scale), (M, 1.0)))


def t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("N,M", [(64, 64), (300, 300), (1000, 257)])
def test_chunked_matches_jax(N, M):
    q, k, v = qkv(2, N, M, 3, 32, N + M)
    ref_dense = np.asarray(jax.nn.dot_product_attention(q, k, v))
    ref_chunk = np.asarray(JA.chunked_attention(q, k, v, q_chunk=128, kv_chunk=96))
    got = TA.chunked_attention(*t(q, k, v), q_chunk=128, kv_chunk=96).numpy()
    np.testing.assert_allclose(got, ref_chunk, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref_dense, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N,M,D", [(64, 64, 32), (65, 65, 16), (50, 33, 16)])
def test_dense_matches_jax(N, M, D):
    q, k, v = qkv(2, N, M, 4, D, 7)
    ref = np.asarray(jax.nn.dot_product_attention(q, k, v))
    got = TA.dot_product_attention_plain(*t(q, k, v)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_non_divisible_padding_is_masked():
    q, k, v = qkv(1, 50, 33, 2, 16, 3)
    ref = np.asarray(jax.nn.dot_product_attention(q, k, v))
    got = TA.chunked_attention(*t(q, k, v), q_chunk=64, kv_chunk=64).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", ["chunked", "dense"])
def test_bf16_inputs_f32_accumulation(fn):
    q, k, v = qkv(1, 256, 256, 2, 64, 6)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax.nn.dot_product_attention(
        *(x.astype(jnp.float32) for x in (qb, kb, vb))))
    tb = tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
               for x in (qb, kb, vb))
    got = (TA.chunked_attention(*tb, q_chunk=128, kv_chunk=128) if fn == "chunked"
           else TA.dot_product_attention_plain(*tb))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_extreme_logits_stay_finite():
    q, k, v = qkv(1, 130, 130, 1, 8, 9, scale=30.0)
    got = TA.chunked_attention(*t(q, k, v), q_chunk=64, kv_chunk=64).numpy()
    assert np.isfinite(got).all()
    ref = np.asarray(jax.nn.dot_product_attention(q, k, v))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    ref_chunk = np.asarray(JA.chunked_attention(q, k, v, q_chunk=64, kv_chunk=64))
    np.testing.assert_allclose(got, ref_chunk, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [32, 33])
def test_cpu_routing_follows_jax(monkeypatch, n):
    """At B·H·N·M equal to the limit both packages stay dense; one past it
    both take the chunked path, and agree."""
    routes = {}
    for name, mod in (("jax", JA), ("torch", TA)):
        orig = mod.chunked_attention

        def spy(*a, _orig=orig, _name=name, **kw):
            routes[_name] = "chunked"
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, "chunked_attention", spy)
        monkeypatch.setattr(mod, "_DENSE_LOGITS_LIMIT", 32 * 32)
    q, k, v = qkv(1, n, 32, 1, 8, 15)
    ref = np.asarray(JA.memory_efficient_attention(q, k, v))
    got = TA.memory_efficient_attention(*t(q, k, v)).numpy()
    expect = "chunked" if n * 32 > 32 * 32 else None
    assert routes.get("jax") == expect and routes.get("torch") == expect
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_default_limit_matches_jax():
    assert TA._DENSE_LOGITS_LIMIT == JA._DENSE_LOGITS_LIMIT
    assert TA._NEG_INF == pytest.approx(float(JA._NEG_INF), rel=1e-6)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = qkv(2, 40, 77, 3, 16, 21)
    before = attention_cuda.ATTENTION_FWD.launches
    got = TA.memory_efficient_attention(*t(q, k, v))
    assert attention_cuda.ATTENTION_FWD.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.dot_product_attention(q, k, v)),
                               atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        attention_cuda.attention_fwd(*t(q, k, v))
    assert attention_cuda.ATTENTION_FWD.launches == before


@pytest.mark.parametrize("shapes", [((1, 8, 2, 16), (1, 8, 3, 16), (1, 8, 3, 16)),
                                    ((1, 8, 2, 16), (1, 8, 2, 16), (1, 9, 2, 16)),
                                    ((1, 8, 2, 16), (2, 8, 2, 16), (2, 8, 2, 16)),
                                    ((8, 2, 16), (8, 2, 16), (8, 2, 16))])
def test_wrapper_rejects_bad_shapes(shapes):
    with pytest.raises(ValueError):
        attention_cuda.attention_fwd(*(torch.zeros(s) for s in shapes))


def test_wrapper_rejects_mixed_devices():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="different devices"):
        attention_cuda.attention_fwd(q, k, k)


def _tf32(x):
    """cvt.rna.tf32.f32 on an fp32 tensor: keep 10 mantissa bits, rounding
    to nearest with ties away from zero (on the int32 view)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, products):
    """a @ b as B3 takes it on the tensor cores: each operand split into
    hi = tf32(x) and lo = tf32(x - hi), then lo·hi + hi·lo + hi·hi
    (products=3), or hi·hi alone (products=1)."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _attention_tf32(q, k, v, products=3, kv_chunk=64):
    """B3's arithmetic on the CPU: the online softmax over 64-key tiles with
    q·fp32(1/√D), exp2((s - m)·log2 e), and both products split."""
    B, N, H, D = q.shape
    qs = q.permute(0, 2, 1, 3) * (1.0 / D ** 0.5)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    m = torch.full((B, H, N), TA._NEG_INF)
    l = torch.zeros((B, H, N))
    acc = torch.zeros((B, H, N, D))
    log2e = 1.4426950408889634
    for m0 in range(0, k.shape[1], kv_chunk):
        s = _mm_tf32(qs, kf[:, :, m0:m0 + kv_chunk].transpose(-1, -2), products)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2((s - m_new[..., None]) * log2e)
        corr = torch.exp2((m - m_new) * log2e)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm_tf32(p, vf[:, :, m0:m0 + kv_chunk], products)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("N,D,scale", [(200, 16, 1.0), (256, 64, 1.0), (150, 128, 1.0),
                                       (130, 16, 30.0), (160, 64, 30.0)])
def test_tf32_split_keeps_fp32_accuracy(N, D, scale):
    """The precision B3's tensor-core path rests on. At scale 1 the 3xTF32
    split stays within the card gate, 1e-4·max|plain| of chunked_attention,
    where one TF32 product per fp32 product does not. At ±30 logits it is
    graded against float64, with the fp32 plain version's own distance from
    float64 (×1.5) as the yardstick, as the card tests grade B3 there."""
    q, k, v = t(*qkv(1, N, N, 2, D, N + D, scale=scale))
    plain = TA.chunked_attention(q, k, v)
    got = _attention_tf32(q, k, v)
    if scale == 1.0:
        tol = 1e-4 * float(plain.abs().max())
        assert float((got - plain).abs().max()) <= tol
        assert float((_attention_tf32(q, k, v, products=1) - plain).abs().max()) > tol
    else:
        s = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) / D ** 0.5
        ref = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.double())
        tol = max(1e-4 * float(ref.abs().max()), 1.5 * float((plain - ref).abs().max()))
        assert float((got - ref).abs().max()) <= tol
