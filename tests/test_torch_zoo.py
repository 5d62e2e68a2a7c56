"""`g4splat_torch.zoo` (the npz prior-zoo writer and its converters) against
the JAX package's converters and `scripts/convert_checkpoints.py`, on the CPU.

- Each converter on seeded state dicts under the official names gives the
  JAX one's tree: the same nested keys, dtypes and values, exactly (both
  only transpose, flip and concatenate). The names come from the JAX tests'
  fixtures and oracles: the full SD-2.1 VAE (in both attention layouts),
  MVDream UNet and MASt3R ViT-L key maps (tests/fixtures/*_keys.json, each
  array shrunk to 2 per axis), the tiny VAE and UNet reference state dicts,
  huggingface CLIP text and vision towers (test_clip.py's names, width
  32), the port's DepthAnythingV2("vits") and DINOv2, SAM's
  TINY_SAM, and torchvision VGG16 / LPIPS heads.
- ROADMAP C3: the CLIP vision head count comes from config.json where given,
  else from the table of known widths (16 at 1024, where the JAX script's
  `embed_dim // 80` fallback gives 12); an unknown width is refused.
- `python -m g4splat_torch.zoo` (its `main`) on a source tree holding
  depth_anything_v2_vits.pth, MVD_weights/image_encoder and text_encoder
  (an SD-1.x quick_gelu tower), vgg16 and the LPIPS heads writes the npz
  files that the JAX script writes from the same tree, tree for tree; the
  port's `build_priors` reads them back: DA2's weights equal the source's,
  the quick_gelu text tower's output equals the JAX package's
  CLIPText(act="quick_gelu", max_positions=…) on the same params (within
  1e-5 of max), the CLIP vision tower and LPIPS load.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch import cli as TC
from g4splat_torch import zoo as Z
from g4splat_torch.priors.depth_anything import DepthAnythingV2
from g4splat_torch.priors.mast3r import AsymmetricMASt3R, MASt3RConfig
from g4splat_torch.priors.mast3r import TINY_CONFIG as TINY_MAST3R
from g4splat_torch.priors.sam import TINY_SAM, SAMPredictor, convert_torch_sam
from g4splat_tpu.eval.image_metrics import load_torch_lpips_weights
from g4splat_tpu.priors.clip_text import CLIPText as JCLIPText
from g4splat_tpu.priors.clip_text import convert_torch_clip_text
from g4splat_tpu.priors.clip_vision import convert_torch_clip_vision
from g4splat_tpu.priors.depth_anything import convert_torch_checkpoint
from g4splat_tpu.priors.dinov2 import convert_torch_dinov2
from g4splat_tpu.priors.mast3r import MASt3RConfig as JMASt3RConfig
from g4splat_tpu.priors.mast3r import convert_torch_mast3r
from g4splat_tpu.priors.sam import TINY_SAM as JTINY_SAM
from g4splat_tpu.priors.sam import convert_torch_sam as jconvert_torch_sam
from g4splat_tpu.priors.see3d import convert_torch_see3d
from g4splat_tpu.priors.vae import convert_torch_vae

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's fixtures and tests: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got),
                                                                        sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_tree(a, b, f"{path}[{i}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def shrunk(key_map, seed):
    """A {name: shape} map → seeded float32 arrays of the same rank, 2 per axis."""
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*([2] * len(s))).astype(np.float32) for k, s in key_map.items()}


def key_map(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def fixture_state(name):
    fx = np.load(os.path.join(FIXTURES, name))
    return {k[3:]: fx[k] for k in fx.files if k.startswith("sd.")}


def legacy_vae(state):
    """The diffusers VAE's older attention names, projections as 1x1 convs."""
    out = {}
    for k, v in state.items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if f".{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                v = v[..., None, None] if k.endswith("weight") else v
        out[k] = v
    return out


def hf_clip(kind, width=32, depth=2, seed=0):
    """A huggingface CLIPTextModel / CLIPVisionModelWithProjection state
    dict under its official names (test_clip.py's layout): 96 tokens and 16
    positions, or 14-pixel patches of a 56² image and a projection to 16."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    pre = f"{kind}_model."
    if kind == "text":
        state = {pre + "embeddings.token_embedding.weight": r(96, width),
                 pre + "embeddings.position_embedding.weight": r(16, width),
                 pre + "final_layer_norm.weight": 1 + r(width),
                 pre + "final_layer_norm.bias": r(width)}
    else:
        state = {pre + "embeddings.patch_embedding.weight": r(width, 3, 14, 14),
                 pre + "embeddings.class_embedding": r(width),
                 pre + "embeddings.position_embedding.weight": r(17, width),
                 pre + "pre_layrnorm.weight": 1 + r(width), pre + "pre_layrnorm.bias": r(width),
                 pre + "post_layernorm.weight": 1 + r(width),
                 pre + "post_layernorm.bias": r(width),
                 "visual_projection.weight": r(16, width)}
    for i in range(depth):
        b = pre + f"encoder.layers.{i}."
        for nm, (o, n) in (("self_attn.q_proj", (width, width)),
                           ("self_attn.k_proj", (width, width)),
                           ("self_attn.v_proj", (width, width)),
                           ("self_attn.out_proj", (width, width)),
                           ("mlp.fc1", (4 * width, width)), ("mlp.fc2", (width, 4 * width))):
            state[b + nm + ".weight"], state[b + nm + ".bias"] = r(o, n), r(o)
        for ln in ("layer_norm1", "layer_norm2"):
            state[b + ln + ".weight"], state[b + ln + ".bias"] = 1 + r(width), r(width)
    return state


def vgg_and_heads(seed=0):
    rng = np.random.RandomState(seed)
    chans = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    vgg = {}
    for n, i in enumerate(Z.VGG16_CONVS):
        vgg[f"features.{i}.weight"] = (0.05 * rng.randn(chans[n + 1], chans[n], 3, 3)
                                       ).astype(np.float32)
        vgg[f"features.{i}.bias"] = (0.01 * rng.randn(chans[n + 1])).astype(np.float32)
    heads = {f"lin{i}.model.1.weight": np.abs(rng.randn(1, c, 1, 1)).astype(np.float32)
             for i, c in enumerate((64, 128, 256, 512, 512))}
    return vgg, heads


def test_vae_matches_jax():
    for state in (fixture_state("vae_tiny_ref.npz"), shrunk(key_map("vae_full_keys.json"), 1)):
        for s in (state, legacy_vae(state)):
            assert_same_tree(Z.convert_torch_vae(s), convert_torch_vae(s))


def test_see3d_matches_jax():
    for state in (fixture_state("see3d_tiny_ref.npz"),
                  shrunk(key_map("see3d_full_keys.json"), 2)):
        assert_same_tree(Z.convert_torch_see3d(state), convert_torch_see3d(state))


def test_mast3r_matches_jax():
    full = shrunk(key_map("mast3r_vitl_keys.json"), 3)
    assert_same_tree(Z.convert_torch_mast3r(full), convert_torch_mast3r(full))
    torch.manual_seed(0)
    tiny = {k: v.numpy() for k, v in AsymmetricMASt3R(TINY_MAST3R).state_dict().items()}
    assert_same_tree(Z.convert_torch_mast3r(tiny),
                     convert_torch_mast3r(tiny, JMASt3RConfig(*TINY_MAST3R)))
    assert MASt3RConfig()._asdict() == JMASt3RConfig()._asdict()


def test_depth_anything_and_dinov2_match_jax():
    torch.manual_seed(1)
    state = {k: v.numpy() for k, v in DepthAnythingV2("vits").state_dict().items()}
    assert_same_tree(Z.convert_torch_depth_anything(state),
                     convert_torch_checkpoint(state, encoder="vits"))
    vit = {k[len("pretrained."):]: v for k, v in state.items() if k.startswith("pretrained.")}
    assert_same_tree(Z.convert_torch_dinov2(vit), convert_torch_dinov2(vit, 12))


def test_clip_text_matches_jax():
    state = hf_clip("text", depth=3)
    for depth in (2, 3):
        assert_same_tree(Z.convert_torch_clip_text(state, depth),
                         convert_torch_clip_text(state, depth))


def test_clip_vision_matches_jax():
    state = hf_clip("vision", depth=2)
    assert_same_tree(Z.convert_torch_clip_vision(state), convert_torch_clip_vision(state))


def test_sam_and_lpips_match_jax():
    sd = {k: v.numpy() for k, v in SAMPredictor(TINY_SAM, seed=0, device="cpu")
          .model.state_dict().items()}
    assert_same_tree(convert_torch_sam(sd, TINY_SAM), jconvert_torch_sam(sd, JTINY_SAM))
    vgg, heads = vgg_and_heads()
    assert_same_tree(Z.load_torch_lpips_weights(vgg, heads),
                     load_torch_lpips_weights(vgg, heads))


def test_clip_vision_heads_c3():
    """config.json's count wins; else the table; an unknown width refuses."""
    assert Z.clip_vision_heads(1024, {}) == 16       # the JAX script: 1024 // 80 = 12
    assert Z.clip_vision_heads(1280, {}) == 16 and Z.clip_vision_heads(1664, {}) == 20
    assert Z.clip_vision_heads(768, {"num_attention_heads": 12}) == 12
    assert Z.clip_vision_heads(32, {"num_attention_heads": 4}) == 4
    with pytest.raises(ValueError, match="unknown CLIP vision width 32"):
        Z.clip_vision_heads(32, {})


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoints", os.path.join(REPO, "scripts", "convert_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_entry(path):
    data = np.load(path, allow_pickle=True)
    return data["params"].item(), (data["cfg"].item() if "cfg" in data.files else None)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A reference checkpoint tree at reduced widths."""
    src = tmp_path_factory.mktemp("src")
    torch.manual_seed(2)
    da2 = DepthAnythingV2("vits")
    os.makedirs(src / "Depth-Anything-V2" / "checkpoints")
    torch.save(da2.state_dict(),
               src / "Depth-Anything-V2" / "checkpoints" / "depth_anything_v2_vits.pth")
    mvd = src / "checkpoint" / "MVD_weights"
    # The text tower at width 64: the writer gives it width // 64 heads.
    for sub, kw, cfg in (
            ("image_encoder", dict(kind="vision"), {"num_attention_heads": 4}),
            ("text_encoder", dict(kind="text", width=64, depth=3),
             {"num_hidden_layers": 2, "hidden_act": "quick_gelu"})):
        os.makedirs(mvd / sub)
        state = hf_clip(seed=3, **kw)
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   mvd / sub / "pytorch_model.bin")
        (mvd / sub / "config.json").write_text(json.dumps(cfg))
    vgg, heads = vgg_and_heads(1)
    os.makedirs(src / "lpips" / "weights" / "v0.1")
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, src / "lpips" / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in heads.items()},
               src / "lpips" / "weights" / "v0.1" / "vgg.pth")
    return str(src), da2


def test_zoo_matches_jax_script_and_loads(source, tmp_path, capsys):
    src, da2 = source
    port, jax_dst = str(tmp_path / "port"), str(tmp_path / "jax")
    only = "depth_anything_v2,mast3r,sam,see3d,lpips"
    assert Z.main(["--src", src, "--dst", port, "--only", only]) == 0
    assert jax_script().main(["--src", src, "--dst", jax_dst, "--only", only]) == 0
    out = capsys.readouterr().out
    assert "[skip] mast3r: no checkpoint found" in out and "[skip] sam" in out
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_dst)) == [
        "clip.npz", "clip_text.npz", "depth_anything_v2.npz", "lpips.npz"]
    for n in names:
        (tp, tc), (jp, jc) = read_entry(os.path.join(port, n)), read_entry(
            os.path.join(jax_dst, n))
        assert_same_tree(tp, jax_tree(jp), n)
        assert tc == jc, n
    params, cfg = read_entry(os.path.join(port, "clip_text.npz"))
    assert cfg == {"depth": 2, "width": 64, "act": "quick_gelu", "num_heads": 1,
                   "pad_id": 49407}

    args = TC.build_parser().parse_args(["-s", "x", "--checkpoint_dir", port])
    p = TC.build_priors(args, device="cpu")
    got = p.depth_model.model.state_dict()
    for k, v in da2.state_dict().items():
        if k != "pretrained.mask_token":      # not in the zoo (unused at inference)
            assert torch.equal(got[k], v), k
    assert p.lpips.calibrated and p.image_embedder is not None
    # The SD-1.x tower: quick_gelu, the checkpoint's 16 positions, EOS padding.
    text = p.text_embedder.model
    assert text.pos_embed.shape[0] == 16 and p.text_embedder.pad_id == 49407
    ids = np.array([[3, 5, 9, 11, 49407 % 96, 0, 0, 0]], np.int32)
    want = np.asarray(JCLIPText(vocab_size=96, width=64, depth=2, num_heads=1, n_ctx=8,
                                max_positions=16, act="quick_gelu").apply(
        jax_tree(params), jnp.asarray(ids)))
    with torch.no_grad():
        out = text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree(v) for v in tree]
    return np.asarray(tree)


def test_zoo_refuses_unknown_entry(tmp_path):
    with pytest.raises(SystemExit):
        Z.main(["--src", str(tmp_path), "--dst", str(tmp_path / "z"), "--only", "nope"])
