"""Parity of the port's See3D stage (`g4splat_torch.pipeline.see3d_stage
.run_see3d_inpaint`) with `G4SplatPipeline._run_see3d_inpaint` on the CPU.

Tiny priors (TINY_UNET, a two-level VAE, small CLIP towers) hold the same
weights in both packages; the JAX method is called unbound on a namespace
carrying `state`, `cfg` and `priors`. Two references and three warps at
12×12 run at a 16² MVD resolution in groups of two warps, so the second
group chains the first's last prediction, then the 2× SR pass. Each group's
noise replays the JAX key stream. Images agree to 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.priors.clip_text as JT
import g4splat_tpu.priors.clip_vision as JV
import g4splat_tpu.priors.see3d as J
import g4splat_tpu.priors.vae as JVAE
from g4splat_torch.convert import flax_state_dict
from g4splat_torch.pipeline.orchestrator import Priors
from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint
from g4splat_torch.priors import clip_text as TT
from g4splat_torch.priors import clip_vision as TV
from g4splat_torch.priors import see3d as T
from g4splat_torch.priors import vae as TVAE
from g4splat_tpu.pipeline.orchestrator import G4SplatPipeline

VISION = dict(embed_dim=32, depth=1, num_heads=2, patch_size=56, projection_dim=16)
TEXT = dict(width=16, depth=1, num_heads=2)
VAE = dict(base_ch=16, ch_mult=(1, 2), z_ch=4)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(cls, kw, params):
    m = cls(**kw)
    m.load_state_dict(flax_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def priors():
    """(JAX priors, port priors) on the same weights."""
    unet = J.MultiViewUNet(J.TINY_UNET)
    up = unet.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 9)), jnp.zeros(2, jnp.int32),
                   jnp.zeros((2, 4, 16)), num_frames=2)
    up = jax.tree.map(lambda p: p if p.ndim < 2 else p + 0.01, up)
    vae = JVAE.AutoencoderKL(**VAE)
    vp = vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    cv = JV.CLIPVision(**VISION)
    cvp = cv.init(jax.random.PRNGKey(2), jnp.zeros((1, 224, 224, 3)))
    ct = JT.CLIPText(**TEXT)
    ctp = ct.init(jax.random.PRNGKey(3), jnp.zeros((1, 77), jnp.int32))
    jp = types.SimpleNamespace(
        see3d=J.See3DPipeline(unet, up, J.DDIMConfig(num_steps=STEPS)), see3d_sr=None,
        vae=(vae, vp), image_embedder=JV.CLIPImageEmbedder(cv, cvp),
        text_embedder=JT.CLIPTextEmbedder(ct, ctp))
    tp = Priors(
        see3d=T.See3DPipeline(carried(T.MultiViewUNet, dict(cfg=T.TINY_UNET), up),
                              T.DDIMConfig(num_steps=STEPS)),
        vae=carried(TVAE.AutoencoderKL, VAE, vp),
        image_embedder=TV.CLIPImageEmbedder(carried(TV.CLIPVision, VISION, cvp)),
        text_embedder=TT.CLIPTextEmbedder(carried(TT.CLIPText, TEXT, ctp)))
    return jp, tp


def replay(seed, shape, n_steps):
    """The JAX pipeline's draws for PRNGKey(seed), as NCHW tensors."""
    F, C, h, w = shape
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    draws = [jax.random.normal(k0, (F, h, w, C))]
    for _ in range(n_steps):
        key, kw = jax.random.split(key)
        draws.append(jax.random.normal(kw, (F, h, w, C)))
    draws = [torch.from_numpy(np.array(d)).permute(0, 3, 1, 2) for d in draws]
    return draws[0], draws[1:]


def scene(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(2, 12, 12, 3).astype(np.float32)
    warps = [rng.rand(12, 12, 3).astype(np.float32) for _ in range(3)]
    masks = [(rng.rand(12, 12) > 0.4).astype(np.float32) for _ in range(3)]
    return images, warps, masks


def test_stage_matches_jax(priors):
    jp, tp = priors
    images, warps, masks = scene()
    ns = types.SimpleNamespace(
        state=types.SimpleNamespace(images=images, input_view_num=2),
        cfg=types.SimpleNamespace(mvd_resolution=16, see3d_group_size=2,
                                  see3d_super_resolution=True),
        priors=jp)
    ref = G4SplatPipeline._run_see3d_inpaint(ns, warps, masks, 1)
    got, sr = run_see3d_inpaint(tp, images, 2, warps, masks, 1, mvd_resolution=16,
                                group_size=2, super_resolution=True, noise_fn=replay,
                                device="cpu")
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == (12, 12, 3)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4)
    assert len(sr) == len(ns._last_sr_preds) == 3
    for g, r in zip(sr, ns._last_sr_preds):
        assert g.shape == (32, 32, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    # the output is not a copy of the warps: the stage generated it
    assert max(float(np.abs(g.numpy() - w).mean()) for g, w in zip(got, warps)) > 1e-2


def test_stage_seeds_its_own_noise(priors):
    _, tp = priors
    images, warps, masks = scene(1)
    a, sr = run_see3d_inpaint(tp, images, 2, warps, masks, 2, mvd_resolution=None, device="cpu")
    b, _ = run_see3d_inpaint(tp, images, 2, warps, masks, 2, mvd_resolution=None, device="cpu")
    c, _ = run_see3d_inpaint(tp, images, 2, warps, masks, 3, mvd_resolution=None, device="cpu")
    assert sr is None
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(bool(((x >= 0) & (x <= 1)).all()) for x in a)


def test_context_rule(priors):
    """Text + image when both towers are wired, either alone, zeros when
    neither is; the widths must agree."""
    from g4splat_torch.pipeline.see3d_stage import _context

    _, tp = priors
    ref0 = torch.rand(16, 16, 3)
    both = _context(tp, ref0)
    img = _context(Priors(see3d=tp.see3d, image_embedder=tp.image_embedder), ref0)
    txt = _context(Priors(see3d=tp.see3d, text_embedder=tp.text_embedder), ref0)
    torch.testing.assert_close(both, img + txt)
    assert both.shape == (1, 77, 16)
    assert torch.equal(_context(Priors(see3d=tp.see3d), ref0), torch.zeros((1, 4, 16)))
    wide = TT.CLIPTextEmbedder(TT.CLIPText(width=24, depth=1, num_heads=2))
    with pytest.raises(ValueError, match="width mismatch"):
        _context(Priors(see3d=tp.see3d, image_embedder=tp.image_embedder,
                        text_embedder=wide), ref0)


def test_stage_device_is_explicit(priors, monkeypatch):
    """The stage runs on the card unless asked for the CPU; a tensor input or
    a prior network on another device than the stage's is refused, never
    moved; the networks run with TF32 off and the caller's flags come back."""
    _, tp = priors
    images, warps, masks = scene(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_see3d_inpaint(tp, images, 2, warps, masks, 1, mvd_resolution=None)
    meta = [torch.zeros(12, 12, 3, device="meta")] + warps[1:]
    with pytest.raises(ValueError, match="input lies on meta"):
        run_see3d_inpaint(tp, images, 2, meta, masks, 1, mvd_resolution=None, device="cpu")
    with torch.device("meta"):
        vae_meta = TVAE.AutoencoderKL(**VAE)
    with pytest.raises(ValueError, match="priors.vae lies on"):
        run_see3d_inpaint(Priors(see3d=tp.see3d, vae=vae_meta), images, 2, warps, masks, 1,
                          mvd_resolution=None, device="cpu")
    seen = set()
    hook = tp.see3d.unet.register_forward_pre_hook(lambda *_: seen.add(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    try:
        run_see3d_inpaint(tp, images, 2, [torch.from_numpy(w) for w in warps], masks, 1,
                          mvd_resolution=None, device="cpu")
    finally:
        hook.remove()
    assert seen == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
