"""Parity of the port's See3D MV-UNet, DDIM sampler and inpainting pipeline
(`g4splat_torch.priors.see3d`) with `g4splat_tpu.priors.see3d` on the CPU.

The TINY_UNET runs in both packages on the same weights (the JAX init, with
the zero-init layers perturbed as tests/test_see3d.py does, carried across
by `convert.flax_state_dict`), to 1e-4 relative. The port loads the
reference fixture `see3d_tiny_ref.npz` with `load_state_dict` and no
converter, at the JAX package's 5e-4 gate (the reference torch LayerNorms
use ε = 1e-5, the JAX ones 1e-6: ROADMAP C6). The pipeline replays the JAX
package's `jax.random` stream as explicit noise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.priors.see3d as J
from g4splat_torch.convert import flax_state_dict
from g4splat_torch.ops.attention import chunked_attention
from g4splat_torch.priors import see3d as T

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
F_, H_, W_ = 3, 8, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def tiny():
    """The JAX TINY_UNET and its params (zero-init layers perturbed), and the
    port's UNet on the same weights."""
    net = J.MultiViewUNet(J.TINY_UNET)
    x = jnp.zeros((F_, H_, W_, J.TINY_UNET.in_channels))
    params = net.init(jax.random.PRNGKey(0), x, jnp.zeros(F_, jnp.int32),
                      jnp.zeros((F_, 4, J.TINY_UNET.context_dim)), num_frames=F_)
    params = jax.tree.map(lambda p: p if p.ndim < 2 else p + 0.01, params)
    port = T.MultiViewUNet(T.TINY_UNET)
    port.load_state_dict(flax_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return net, params, port.eval()


@pytest.mark.parametrize("F,t", [(3, [999, 500, 10]), (2, [17, 981])])
def test_unet_matches_jax(tiny, F, t):
    net, params, port = tiny
    rng = np.random.RandomState(F)
    x = rng.randn(F, H_, W_, 9).astype(np.float32)
    ctx = rng.randn(F, 5, 16).astype(np.float32)
    t = np.asarray(t, np.int32)
    ref = np.asarray(net.apply(params, x, t, ctx, num_frames=F))
    with torch.no_grad():
        got = nhwc(port(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), num_frames=F))
    assert rel(got, ref) <= 1e-4
    assert np.abs(ref).max() > 1e-3       # the perturbed output layers pass information


def test_unet_attention_argument(tiny):
    """An explicit attention function replaces the default route."""
    _, _, port = tiny
    rng = np.random.RandomState(5)
    x, ctx = torch.from_numpy(rng.randn(2, 9, 8, 8).astype(np.float32)), \
        torch.from_numpy(rng.randn(2, 5, 16).astype(np.float32))
    t = torch.tensor([10, 700])
    calls = []

    def spy(q, k, v):
        calls.append(q.shape)
        return chunked_attention(q, k, v, q_chunk=16, kv_chunk=32)

    with torch.no_grad():
        a = port(x, t, ctx, num_frames=2)
        b = port(x, t, ctx, num_frames=2, attention=spy)
    assert len(calls) == 2 * T.TINY_UNET.n_transformer_blocks()
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)


def test_fixture_loads_without_converter():
    fx = np.load(os.path.join(FIXTURES, "see3d_tiny_ref.npz"))
    port = T.MultiViewUNet(T.TINY_UNET)
    port.load_state_dict({k[3:]: torch.from_numpy(fx[k]) for k in fx.files
                          if k.startswith("sd.")}, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(fx["in.x"]), torch.from_numpy(fx["in.t"]),
                   torch.from_numpy(fx["in.ctx"]), num_frames=fx["in.x"].shape[0]).numpy()
    assert out.shape == fx["out.eps"].shape
    assert rel(out, fx["out.eps"]) < 5e-4


def test_full_config_keys_and_shapes():
    with open(os.path.join(FIXTURES, "see3d_full_keys.json")) as f:
        shapes = json.load(f)
    with torch.device("meta"):
        port = T.MultiViewUNet(T.UNetConfig())
    assert {k: list(v.shape) for k, v in port.state_dict().items()} == shapes
    n_attn = sum(isinstance(m, T.CrossAttention) for m in port.modules())
    assert n_attn == 2 * T.UNetConfig().n_transformer_blocks() == 32


def test_zero_init_layers_stay_zero():
    port = T.MultiViewUNet(T.TINY_UNET)
    zero = [k for k, v in port.state_dict().items() if v.ndim and not v.any()]
    assert "out.2.weight" in zero
    assert any(k.endswith("proj_out.weight") for k in zero)
    assert any(k.endswith("out_layers.3.weight") for k in zero)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 3, 500, 999], np.int32)
    ref = np.asarray(J.timestep_embedding(jnp.asarray(t), 32))
    np.testing.assert_allclose(T.timestep_embedding(torch.from_numpy(t), 32).numpy(), ref,
                               atol=1e-5, rtol=1e-5)


def test_decay_weight_matches_jax():
    t = np.array([0, 30, 59, 60, 61, 130, 199, 200, 250], np.int32)
    np.testing.assert_allclose(
        T.custom_decay_function_weight(torch.from_numpy(t)).numpy(),
        np.asarray(J.custom_decay_function_weight(jnp.asarray(t))), atol=1e-6)


@pytest.mark.parametrize("kw", [dict(num_steps=50), dict(num_steps=4), dict(num_steps=3),
                                dict(num_steps=10, timestep_spacing="leading",
                                     rescale_zero_snr=False)])
def test_ddim_schedule_matches_jax(kw):
    js, ts = J.DDIMSampler(J.DDIMConfig(**kw)), T.DDIMSampler(T.DDIMConfig(**kw))
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.step_size == js.step_size
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))


@pytest.mark.parametrize("pred", ["v", "epsilon"])
def test_ddim_math_matches_jax(pred):
    kw = dict(num_steps=10, prediction_type=pred)
    js, ts = J.DDIMSampler(J.DDIMConfig(**kw)), T.DDIMSampler(T.DDIMConfig(**kw))
    rng = np.random.RandomState(2)
    x0, eps, out = (rng.randn(3, 4, 4, 4).astype(np.float32) for _ in range(3))
    tv = np.array([999, 400, 3], np.int32)
    tt = torch.from_numpy
    np.testing.assert_allclose(ts.add_noise(tt(x0), tt(eps), tt(tv)).numpy(),
                               np.asarray(js.add_noise(x0, eps, jnp.asarray(tv))), atol=1e-6)
    for a, b in zip(ts.to_eps_x0(tt(out), tt(tv), tt(x0)),
                    js.to_eps_x0(out, jnp.asarray(tv), x0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    for t in (999, 50, 3):
        np.testing.assert_allclose(ts.step(tt(out), t, tt(x0)).numpy(),
                                   np.asarray(js.step(out, t, x0)), atol=1e-5, rtol=1e-5)


def jax_noise(seed, shape_nhwc, n_steps):
    """The draws of `J.See3DPipeline.inpaint_latents(PRNGKey(seed), …)`, as
    (x_T, [one per step]) NCHW tensors."""
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    draws = [jax.random.normal(k0, shape_nhwc)]
    for _ in range(n_steps):
        key, kw = jax.random.split(key)
        draws.append(jax.random.normal(kw, shape_nhwc))
    draws = [nchw(d) for d in draws]
    return draws[0], draws[1:]


@pytest.mark.parametrize("gr", [0.0, 0.7])
def test_inpaint_latents_matches_jax(tiny, gr):
    net, params, port = tiny
    ddim = dict(num_steps=3, guidance_rescale=gr)
    jpipe = J.See3DPipeline(net, params, J.DDIMConfig(**ddim))
    tpipe = T.See3DPipeline(port, T.DDIMConfig(**ddim))
    rng = np.random.RandomState(11)
    lat = rng.randn(F_, H_, W_, 4).astype(np.float32)
    masks = np.zeros((F_, H_, W_, 1), np.float32)
    masks[:, :4] = 1.0
    ctx = rng.randn(F_, 4, 16).astype(np.float32)
    ref = np.asarray(jpipe.inpaint_latents(jax.random.PRNGKey(3), lat, masks, ctx, gt_num=1))
    got = tpipe.inpaint_latents(nchw(lat), nchw(masks), torch.from_numpy(ctx), gt_num=1,
                                noise=jax_noise(3, lat.shape, len(tpipe.sampler.timesteps)))
    got = nhwc(got)
    np.testing.assert_array_equal(got[0], lat[0])            # the reference frame is pinned
    assert rel(got, ref) <= 1e-4
    assert np.abs(got[1:] - lat[1:]).mean() > 0.05            # the others are generated


def test_generator_noise_is_seeded(tiny):
    _, _, port = tiny
    pipe = T.See3DPipeline(port, T.DDIMConfig(num_steps=2))
    rng = np.random.RandomState(4)
    lat = torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32))
    m = torch.ones((2, 1, 8, 8))
    ctx = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    a, b, c = (pipe.inpaint_latents(lat, m, ctx, gt_num=1,
                                    generator=torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="step noises"):
        pipe.inpaint_latents(lat, m, ctx, noise=(lat, [lat]))
