"""Parity of the port's DepthAnything V2 (`priors.dinov2`, `priors.dpt`,
`priors.depth_anything`, `convert.depth_anything_state_dict`) with the JAX
package's on the CPU, on carried-over weights and seeded numpy inputs:
- `resize_bilinear_ac` within 1e-6, including 1- and 2-pixel sources;
- DINOv2 at embed 64, depth 4, 4 heads: every tap within 1e-5;
- the DPT head within 1e-5 relative to max|out|;
- `DepthAnything("vits", input_size=56)`: `infer_images` (slabs, the last
  one short: the port runs it at its own size where JAX pads it), `infer_image` and `infer_batch` within 1e-4 relative;
- names: the JAX package's `convert_torch_checkpoint` of the port's state
  dict gives back the flax params exactly, and ViT-L's key set and size are
  the official checkpoint's layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.priors.depth_anything as JD
import g4splat_tpu.priors.dinov2 as JV
import g4splat_tpu.priors.dpt as JP
import g4splat_torch.priors.depth_anything as TD
import g4splat_torch.priors.dinov2 as TV
import g4splat_torch.priors.dpt as TP
from g4splat_torch.convert import depth_anything_state_dict, flax_state_dict


def jittered(params, seed):
    """Flax params with every leaf moved by seeded noise (LayerScale's 1e-5
    and the zero class token would otherwise hide their paths)."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tree, [np.asarray(l + 0.05 * jax.random.normal(k, l.shape))
                                     for l, k in zip(leaves, keys)])


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


@pytest.mark.parametrize("shape, size", [((2, 5, 7, 3), (11, 4)), ((1, 1, 2, 2), (3, 5)),
                                         ((1, 2, 1, 1), (6, 6))])
def test_resize_bilinear_ac(shape, size):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    j = JP.resize_bilinear_ac(jnp.asarray(x), size)
    t = TP.resize_bilinear_ac(torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_dinov2_small():
    kw = dict(embed_dim=64, depth=4, num_heads=4)
    jm = JV.DINOv2(**kw)
    x = np.random.default_rng(1).normal(size=(2, 28, 42, 3)).astype(np.float32)
    params = jittered(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)),
                              out_indices=(1, 3)), 1)
    jout, jgrid = jm.apply(params, jnp.asarray(x), out_indices=(1, 3))
    tm = TV.DINOv2(**kw)
    sd = flax_state_dict(params)
    sd["mask_token"] = torch.zeros(1, 64)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        tout, tgrid = tm(torch.from_numpy(x), out_indices=(1, 3))
    assert tuple(jgrid) == tuple(tgrid) == (2, 3)
    for (jp, jc), (tp, tc) in zip(jout, tout):
        assert rel(jp, tp) < 1e-5 and rel(jc, tc) < 1e-5


def test_dpt_head():
    kw = dict(features=16, out_channels=(8, 16, 24, 24))
    jm = JP.DPTHead(**kw)
    rng = np.random.default_rng(2)
    taps = [rng.normal(size=(2, 12, 32)).astype(np.float32) for _ in range(4)]
    params = jittered(jm.init(jax.random.PRNGKey(0), [jnp.asarray(t) for t in taps], (3, 4)), 2)
    j = jm.apply(params, [jnp.asarray(t) for t in taps], (3, 4))[..., 0]
    tm = TP.DPTHead(32, **kw)
    sd = depth_anything_state_dict({"pretrained": {}, "depth_head": params["params"]}, "vits")
    sd = {k[len("depth_head."):]: v for k, v in sd.items() if k.startswith("depth_head.")}
    for conv in ("conv1", "conv2"):
        sd[f"scratch.refinenet4.resConfUnit1.{conv}.weight"] = torch.zeros(16, 16, 3, 3)
        sd[f"scratch.refinenet4.resConfUnit1.{conv}.bias"] = torch.zeros(16)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        t = tm([torch.from_numpy(x) for x in taps], (3, 4))[:, 0]
    assert t.shape == (2, 42, 56)
    assert rel(j, t.numpy()) < 1e-5


@pytest.fixture(scope="module")
def models():
    jm = JD.DepthAnything("vits", seed=0, input_size=56)
    jm.params = jittered(jm.params, 3)
    tm = TD.DepthAnythingV2("vits")
    tm.load_state_dict(depth_anything_state_dict(jm.params, "vits"), strict=True)
    return jm, TD.DepthAnything("vits", model=tm, input_size=56)


def test_depth_anything_infer(models):
    jm, tm = models
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(3, 40, 52, 3)).astype(np.float32)
    j = jm.infer_images(imgs, max_batch=2)
    t = tm.infer_images(torch.from_numpy(imgs), max_batch=2)
    assert t.shape == (3, 40, 52) and np.abs(j).max() > 0
    assert rel(j, t.numpy()) < 1e-4
    u8 = (imgs[0] * 255).astype(np.uint8)
    assert rel(jm.infer_image(u8), tm.infer_image(torch.from_numpy(u8)).numpy()) < 1e-4
    x = rng.uniform(size=(2, 56, 70, 3)).astype(np.float32)
    assert rel(jm.infer_batch(jnp.asarray(x)), tm.infer_batch(torch.from_numpy(x)).numpy()) < 1e-4
    assert TD.DepthAnything._target_size(384, 512, 518) == JD.DepthAnything._target_size(
        384, 512, 518) == (518, 686)


def test_checkpoint_names_round_trip(models):
    """The port's state dict, read by the JAX package's converter of the
    official torch checkpoint, is the flax params it came from."""
    jm, tm = models
    back = JD.convert_torch_checkpoint(
        {k: v.numpy() for k, v in tm.model.state_dict().items()}, "vits")
    want = dict(jax.tree_util.tree_flatten_with_path(jm.params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    unused = {k for k in got if "refinenet4" in jax.tree_util.keystr(k)
              and "resConfUnit1" in jax.tree_util.keystr(k)}
    assert set(got) - unused == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))


def test_vitl_layout():
    """ViT-L at full width on the meta device: the official key layout
    (`pretrained.*`, `depth_head.projects.i`, `depth_head.resize_layers.i`,
    `depth_head.scratch.*`), DA2-Large's 335.3M parameters, and every
    LayerNorm at eps 1e-6 (the flax default; DINOv2's reference too)."""
    with torch.device("meta"):
        m = TD.DepthAnythingV2("vitl")
    keys = set(m.state_dict())
    for k in ("pretrained.cls_token", "pretrained.pos_embed", "pretrained.mask_token",
              "pretrained.patch_embed.proj.weight", "pretrained.blocks.23.ls2.gamma",
              "pretrained.norm.weight", "depth_head.projects.3.weight",
              "depth_head.resize_layers.0.weight", "depth_head.resize_layers.3.bias",
              "depth_head.scratch.layer4_rn.weight",
              "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight",
              "depth_head.scratch.output_conv2.2.bias"):
        assert k in keys, k
    assert all(k.startswith(("pretrained.", "depth_head.")) for k in keys)
    assert abs(sum(p.numel() for p in m.parameters()) / 1e6 - 335.3) < 0.1
    norms = [mod for mod in m.modules() if isinstance(mod, torch.nn.LayerNorm)]
    assert len(norms) == 49 and all(n.eps == 1e-6 for n in norms)
