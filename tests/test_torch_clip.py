"""Parity of the port's CLIP towers and embedders
(`g4splat_torch.priors.clip_vision`, `clip_text`, `vit`) and of its resize
(`g4splat_torch.core.resize`) with the JAX package on the CPU.

Small towers run in both packages on the same weights (the JAX init carried
across by `convert.flax_state_dict`), to 2e-5 as tests/test_clip_text.py
holds the JAX towers; the resize is held against ``jax.image.resize``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.priors.clip_text as JT
import g4splat_tpu.priors.clip_vision as JV
import g4splat_tpu.priors.vit as JVit
from g4splat_torch.convert import flax_state_dict
from g4splat_torch.core.resize import resize_bilinear
from g4splat_torch.priors import clip_text as TT
from g4splat_torch.priors import clip_vision as TV
from g4splat_torch.priors import vit as TVit

TOL = 2e-5
VISION = dict(embed_dim=32, depth=2, num_heads=2, patch_size=28, image_size=224,
              projection_dim=24)
TEXT = dict(width=32, depth=2, num_heads=2)


def port_of(cls, kw, params):
    m = cls(**kw)
    m.load_state_dict(flax_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def vision():
    jm = JV.CLIPVision(**VISION)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    return jm, params, port_of(TV.CLIPVision, VISION, params)


@pytest.fixture(scope="module")
def text():
    jm = JT.CLIPText(**TEXT)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 77), jnp.int32))
    return jm, params, port_of(TT.CLIPText, TEXT, params)


@pytest.mark.parametrize("size", [224, 168])
def test_vision_tower_matches_jax(vision, size):
    """224 uses the learned positions as they are; 168 interpolates them."""
    jm, params, tm = vision
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    ref_proj, ref_tok = jm.apply(params, x)
    with torch.no_grad():
        proj, tok = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(proj.numpy(), np.asarray(ref_proj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(ref_tok), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("image", ["unit", "bytes"])
def test_image_embedder_matches_jax(vision, image):
    jm, params, tm = vision
    img = np.random.RandomState(3).rand(300, 400, 3).astype(np.float32)
    if image == "bytes":
        img = img * 255.0
    ref = np.asarray(JV.CLIPImageEmbedder(jm, params)(img))
    got = TV.CLIPImageEmbedder(tm)(img).numpy()
    assert got.shape == ref.shape == (1, 77, VISION["projection_dim"])
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_text_tower_matches_jax(text):
    jm, params, tm = text
    ids = np.random.RandomState(4).randint(0, 49408, (2, 77)).astype(np.int32)
    ref = np.asarray(jm.apply(params, ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_text_embedder_matches_jax(text):
    jm, params, tm = text
    jemb, temb = JT.CLIPTextEmbedder(jm, params), TT.CLIPTextEmbedder(tm)
    np.testing.assert_allclose(temb().numpy(), np.asarray(jemb()), atol=TOL, rtol=TOL)
    assert temb() is temb()                  # the empty prompt is cached
    ids = JT.empty_prompt_ids(77, pad_id=JT.EOS_ID)
    np.testing.assert_array_equal(TT.empty_prompt_ids(77, pad_id=TT.EOS_ID), ids)
    np.testing.assert_allclose(temb(ids).numpy(), np.asarray(jemb(ids)), atol=TOL, rtol=TOL)


def test_vit_block_matches_jax():
    jb = JVit.Block(num_heads=4)
    x = np.random.RandomState(5).randn(2, 10, 32).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(2), x)
    tb = TVit.Block(32, 4)
    tb.load_state_dict(flax_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.apply(params, x)), atol=TOL, rtol=TOL)


def test_interpolate_pos_embed_matches_jax():
    pos = np.random.RandomState(6).randn(64, 8).astype(np.float32)
    for gh, gw in ((4, 6), (12, 12)):
        np.testing.assert_allclose(
            TVit.interpolate_pos_embed(torch.from_numpy(pos), gh, gw).numpy(),
            np.asarray(JVit.interpolate_pos_embed(jnp.asarray(pos), gh, gw)), atol=TOL)


@pytest.mark.parametrize("src,dst", [((512, 512), (224, 224)), ((300, 400), (224, 224)),
                                     ((16, 16), (32, 32)), ((12, 12), (16, 16)),
                                     ((24, 20), (12, 18))])
def test_resize_matches_jax(src, dst):
    img = np.random.RandomState(sum(src)).rand(*src, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), dst + (3,), "bilinear"))
    got = resize_bilinear(torch.from_numpy(img), dst).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    batched = resize_bilinear(torch.from_numpy(np.stack([img, img])), dst).numpy()
    np.testing.assert_allclose(batched[1], got, atol=1e-7)
