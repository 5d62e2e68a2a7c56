"""Write the npz prior zoo from the reference's torch checkpoints.

    python -m g4splat_torch.zoo --src /path/to/reference/ckpts \\
        --dst /path/to/npz_zoo [--only depth_anything_v2,sam]

The counterpart of the JAX package's `scripts/convert_checkpoints.py`, with
the port's own numpy copies of the converters (the official state dicts'
names → the flax param trees the zoo holds), so that it runs where JAX is
not installed. `python -m g4splat_torch.cli --checkpoint_dir` and the JAX
package's CLI read what it writes: one npz per prior holding a pickled
`params` tree and, where the architecture is not the default, a pickled
`cfg` dict of constructor arguments.

The reference's layout (reference README.md:108-139), searched recursively
under `--src`:

    Depth-Anything-V2/checkpoints/depth_anything_v2_vit{s,b,l,g}.pth
    mast3r/checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth
    checkpoint/segment-anything/sam_vit_h_4b8939.pth
    checkpoint/MVD_weights/   (diffusers layout: unet/sparse/ema-checkpoint,
                               unet/single/ema-checkpoint, vae/,
                               image_encoder/, text_encoder/)
    torchvision vgg16*.pth and the LPIPS heads (lpips*vgg*.pth or
    weights/v0.1/vgg.pth) for calibrated LPIPS

and written as depth_anything_v2.npz, mast3r.npz, sam.npz, see3d.npz,
see3d_sr.npz, vae.npz, clip.npz, clip_text.npz and lpips.npz. A checkpoint
that is not found is skipped with a warning: the CLI runs without that
prior, so a partial zoo is usable.

`.pth`, `.bin` and `.ckpt` files are read with `torch.load(...,
weights_only=True)` (`argparse.Namespace`, which MASt3R's checkpoint holds
beside its weights, is allowed); `.safetensors` files only where the
`safetensors` package imports, and a directory that holds nothing else is
then skipped with a warning.

Variant detection follows the JAX script, except the CLIP vision tower's
head count (ROADMAP C3): `config.json`'s `num_attention_heads` where given,
else the table of known widths; an unknown width is refused, never guessed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from g4splat_torch.priors.sam import _conv, _lin, _ln

# CLIP vision width → heads: ViT-B/16 768, ViT-L/14 1024, OpenCLIP ViT-H/14
# 1280, ViT-bigG/14 1664.
CLIP_VISION_HEADS = {768: 12, 1024: 16, 1280: 16, 1664: 20}


# ------------------------------------------------------------- converters
def _layer_count(state, prefix) -> int:
    return 1 + max(int(k[len(prefix):].split(".")[0]) for k in state if k.startswith(prefix))


def convert_torch_dinov2(state: Dict) -> Dict:
    """DINOv2 state dict (numpy values) → flax params, every block."""
    p = {
        "patch_embed": {"proj": _conv(state, "patch_embed.proj")},
        "cls_token": np.asarray(state["cls_token"]),
        "pos_embed": np.asarray(state["pos_embed"]),
    }
    for i in range(_layer_count(state, "blocks.")):
        pre = f"blocks.{i}."
        p[f"blocks_{i}"] = {
            "norm1": _ln(state, pre + "norm1"),
            "norm2": _ln(state, pre + "norm2"),
            "attn": {"qkv": _lin(state, pre + "attn.qkv"),
                     "proj": _lin(state, pre + "attn.proj")},
            "mlp": {"fc1": _lin(state, pre + "mlp.fc1"), "fc2": _lin(state, pre + "mlp.fc2")},
            "ls1": {"gamma": np.asarray(state[pre + "ls1.gamma"])},
            "ls2": {"gamma": np.asarray(state[pre + "ls2.gamma"])},
        }
    p["norm"] = _ln(state, "norm")
    return {"params": p}


def _transposed_conv(state, prefix):
    """torch ConvTranspose2d (in, out, kh, kw) → flax (kh, kw, in, out) with
    the taps mirrored: torch's transposed convolution is the gradient of a
    convolution, flax's a direct lhs-dilated one."""
    w = np.asarray(state[prefix + ".weight"])
    return {"kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1].copy(),
            "bias": np.asarray(state[prefix + ".bias"])}


def convert_torch_depth_anything(state: Dict) -> Dict:
    """Official DepthAnythingV2 state dict → flax params (the JAX package's
    `convert_torch_checkpoint`)."""
    vit = {k[len("pretrained."):]: v for k, v in state.items() if k.startswith("pretrained.")}
    params = {"pretrained": convert_torch_dinov2(vit)["params"]}
    dh = "depth_head."
    head = {f"projects_{i}": _conv(state, dh + f"projects.{i}") for i in range(4)}
    for i in (0, 1):
        head[f"resize_{i}"] = _transposed_conv(state, dh + f"resize_layers.{i}")
    head["resize_3"] = _conv(state, dh + "resize_layers.3")
    for i in range(4):
        head[f"layer{i + 1}_rn"] = _conv(state, dh + f"scratch.layer{i + 1}_rn", bias=False)
    for r in range(1, 5):
        pre = dh + f"scratch.refinenet{r}."
        blk = {f"resConfUnit{u}": {c: _conv(state, pre + f"resConfUnit{u}.{c}")
                                   for c in ("conv1", "conv2")} for u in (1, 2)}
        blk["out_conv"] = _conv(state, pre + "out_conv")
        head[f"refinenet{r}"] = blk
    head["output_conv1"] = _conv(state, dh + "scratch.output_conv1")
    head["output_conv2_0"] = _conv(state, dh + "scratch.output_conv2.0")
    head["output_conv2_2"] = _conv(state, dh + "scratch.output_conv2.2")
    params["depth_head"] = head
    return {"params": params}


def _mast3r_block(state, pre, decoder=False):
    blk = {
        "norm1": _ln(state, pre + "norm1"),
        "norm2": _ln(state, pre + "norm2"),
        "attn": {"qkv": _lin(state, pre + "attn.qkv"), "proj": _lin(state, pre + "attn.proj")},
        "mlp": {"fc1": _lin(state, pre + "mlp.fc1"), "fc2": _lin(state, pre + "mlp.fc2")},
    }
    if decoder:
        blk["norm3"] = _ln(state, pre + "norm3")
        blk["norm_y"] = _ln(state, pre + "norm_y")
        blk["cross_attn"] = {k: _lin(state, pre + f"cross_attn.{k}")
                             for k in ("projq", "projk", "projv", "proj")}
    return blk


def _mast3r_head(state, h):
    """downstream_head{k}.* → the CatMLPDPTHead params (croco dpt_block.py
    DPTOutputAdapter + catmlp_dpt_head.py)."""
    dpt = {f"projects_{i}": _conv(state, h + f".dpt.act_postprocess.{i}.0") for i in range(4)}
    for i in (0, 1):
        dpt[f"resize_{i}"] = _transposed_conv(state, h + f".dpt.act_postprocess.{i}.1")
    dpt["resize_3"] = _conv(state, h + ".dpt.act_postprocess.3.1")
    for i in range(4):
        dpt[f"layer{i + 1}_rn"] = _conv(state, h + f".dpt.scratch.layer{i + 1}_rn", bias=False)
    for r in range(1, 5):
        pre = h + f".dpt.scratch.refinenet{r}."
        # refinenet4 has no skip input: its resConfUnit1 is never called.
        blk = {f"resConfUnit{u}": {c: _conv(state, pre + f"resConfUnit{u}.{c}")
                                   for c in ("conv1", "conv2")}
               for u in (1, 2) if not (r == 4 and u == 1)}
        blk["out_conv"] = _conv(state, pre + "out_conv")
        dpt[f"refinenet{r}"] = blk
    dpt["output_conv1"] = _conv(state, h + ".dpt.head.0")
    dpt["output_conv2_0"] = _conv(state, h + ".dpt.head.2")
    dpt["output_conv2_2"] = _conv(state, h + ".dpt.head.4")
    return {"dpt": dpt, "head_local_features": {
        "fc1": _lin(state, h + ".head_local_features.fc1"),
        "fc2": _lin(state, h + ".head_local_features.fc2")}}


def convert_torch_mast3r(state: Dict) -> Dict:
    """AsymmetricMASt3R checkpoint (`ckpt["model"]`, numpy values) → flax
    params, every encoder and decoder block. The croco `mask_token` and the
    `scratch.layer_rn.*` aliases are not read."""
    p = {
        "patch_embed": {"proj": _conv(state, "patch_embed.proj")},
        "enc_norm": _ln(state, "enc_norm"),
        "decoder_embed": _lin(state, "decoder_embed"),
        "dec_norm": _ln(state, "dec_norm"),
    }
    for i in range(_layer_count(state, "enc_blocks.")):
        p[f"enc_blocks_{i}"] = _mast3r_block(state, f"enc_blocks.{i}.")
    for i in range(_layer_count(state, "dec_blocks.")):
        p[f"dec_blocks_{i}"] = _mast3r_block(state, f"dec_blocks.{i}.", decoder=True)
        p[f"dec_blocks2_{i}"] = _mast3r_block(state, f"dec_blocks2.{i}.", decoder=True)
    p["head1"] = _mast3r_head(state, "downstream_head1")
    p["head2"] = _mast3r_head(state, "downstream_head2")
    return {"params": p}


def _clip_layer(state, b):
    """One huggingface CLIP encoder layer (q, k, v fused into qkv)."""
    attn = b + "self_attn."
    return {
        "norm1": _ln(state, b + "layer_norm1"),
        "norm2": _ln(state, b + "layer_norm2"),
        "attn": {
            "qkv": {"kernel": np.concatenate([np.asarray(state[attn + f"{x}_proj.weight"])
                                              for x in "qkv"], 0).T,
                    "bias": np.concatenate([np.asarray(state[attn + f"{x}_proj.bias"])
                                            for x in "qkv"], 0)},
            "proj": _lin(state, attn + "out_proj"),
        },
        "fc1": _lin(state, b + "mlp.fc1"),
        "fc2": _lin(state, b + "mlp.fc2"),
    }


def convert_torch_clip_text(state: Dict, depth: int = 23) -> Dict:
    """huggingface CLIPTextModel state dict → flax params, the first `depth`
    transformer layers (SD-2.x reads the penultimate hidden state)."""
    pre = "text_model."
    p = {
        "token_embedding": np.asarray(state[pre + "embeddings.token_embedding.weight"]),
        "pos_embed": np.asarray(state[pre + "embeddings.position_embedding.weight"]),
        "final_ln": _ln(state, pre + "final_layer_norm"),
    }
    for i in range(depth):
        p[f"blocks_{i}"] = _clip_layer(state, pre + f"encoder.layers.{i}.")
    return {"params": p}


def convert_torch_clip_vision(state: Dict) -> Dict:
    """huggingface CLIPVisionModel(+projection) state dict → flax params,
    every layer."""
    pre = "vision_model."
    p = {
        "patch_embed": {"kernel": np.asarray(
            state[pre + "embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": np.asarray(state[pre + "embeddings.class_embedding"]).reshape(-1),
        "pos_embed": np.asarray(state[pre + "embeddings.position_embedding.weight"]),
        "pre_ln": _ln(state, pre + "pre_layrnorm"),
        "post_ln": _ln(state, pre + "post_layernorm"),
        "visual_projection": {"kernel": np.asarray(state["visual_projection.weight"]).T},
    }
    for i in range(_layer_count(state, pre + "encoder.layers.")):
        blk = _clip_layer(state, pre + f"encoder.layers.{i}.")
        blk["mlp"] = {"fc1": blk.pop("fc1"), "fc2": blk.pop("fc2")}
        p[f"blocks_{i}"] = blk
    return {"params": p}


def _assign(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _leaf(path: Tuple[str, ...], value):
    """torch leaf → flax leaf by rank: conv (O, I, kh, kw) → (kh, kw, I, O),
    linear (O, I) → (I, O), a norm's weight → scale; float32."""
    leaf, v = path[-1], np.asarray(value, np.float32)
    if leaf == "bias":
        return path, v
    if leaf != "weight":
        return None
    if v.ndim == 4:
        return path[:-1] + ("kernel",), v.transpose(2, 3, 1, 0)
    if v.ndim == 2:
        return path[:-1] + ("kernel",), v.T
    return path[:-1] + ("scale",), v


_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def convert_torch_vae(state_dict: Dict) -> Dict:
    """diffusers AutoencoderKL state dict → flax params; the legacy attention
    names (query/key/value/proj_attn, possibly 1x1 convolutions) too."""
    params: dict = {}
    for key in state_dict:
        k = key
        for old, new in _LEGACY_ATTN.items():
            k = k.replace(f".{old}.", f".{new}.")
        *mods, leaf = k.split(".")
        out, i = [], 0
        while i < len(mods):
            p = mods[i]
            if p in ("down_blocks", "up_blocks"):
                blk, sub = f"{p}_{mods[i + 1]}", mods[i + 2]
                if sub == "resnets":
                    out.append(f"{blk}_resnets_{mods[i + 3]}")
                    i += 4
                elif sub in ("downsamplers", "upsamplers"):
                    out.append(f"{blk}_{sub}_{mods[i + 3]}_{mods[i + 4]}")
                    i += 5
                else:
                    out.append(f"{blk}_{sub}")
                    i += 3
            elif p in ("resnets", "attentions", "to_out"):
                out.append(f"{p}_{mods[i + 1]}")
                i += 2
            else:
                out.append(p)
                i += 1
        v = np.asarray(state_dict[key], np.float32)
        if leaf == "weight":
            if v.ndim == 4 and out[-1] in ("to_q", "to_k", "to_v", "to_out_0"):
                v = v[..., 0, 0]            # a legacy 1x1-conv projection
            if v.ndim == 4:
                leaf, v = "kernel", v.transpose(2, 3, 1, 0)
            elif v.ndim == 2:
                leaf, v = "kernel", v.T
            else:
                leaf = "scale"
        _assign(params, tuple(out) + (leaf,), v)
    return {"params": params}


_UNET_REWRITES = (
    ("in_layers.0", "in_layers_0"), ("in_layers.2", "in_layers_2"),
    ("emb_layers.1", "emb_layers_1"), ("out_layers.0", "out_layers_0"),
    ("out_layers.3", "out_layers_3"),
    ("ff.net.0.proj", "ff_net_0_proj"), ("ff.net.2", "ff_net_2"),
    ("to_out.0", "to_out_0"),
    ("time_embed.0", "time_embed_0"), ("time_embed.2", "time_embed_2"),
    ("camera_embed.0", "camera_embed_0"), ("camera_embed.2", "camera_embed_2"),
)


def _unet_path(key: str) -> Tuple[str, ...]:
    for old, new in _UNET_REWRITES:
        key = key.replace(old + ".", new + ".")
    parts = key.split(".")
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p in ("input_blocks", "output_blocks"):
            out.append(f"{p}_{parts[i + 1]}_{parts[i + 2]}")
            i += 3
        elif p in ("middle_block", "transformer_blocks") or (
                p == "out" and parts[i + 1] in ("0", "2")):
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return tuple(out)


def convert_torch_see3d(state_dict: Dict) -> Dict:
    """MVDream MultiViewUNetModel state dict (the MVD `unet` checkpoint,
    mv_diffusion.py:29-33, camera embedding included) → flax params."""
    params: dict = {}
    for k in state_dict:
        converted = _leaf(_unet_path(k), state_dict[k])
        if converted is not None:
            _assign(params, *converted)
    return {"params": params}


# torchvision vgg16.features indices of the 13 convolutions.
VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def load_torch_lpips_weights(vgg_state: Dict, lpips_state: Dict) -> Dict:
    """torchvision VGG16 `features.{i}` and the LPIPS `lin{i}.model.1`
    heads → the LPIPS param tree ({"conv": [{"w" HWIO, "b"}], "lin": [...]})."""
    return {
        "conv": [{"w": np.asarray(vgg_state[f"features.{i}.weight"]).transpose(2, 3, 1, 0),
                  "b": np.asarray(vgg_state[f"features.{i}.bias"])} for i in VGG16_CONVS],
        "lin": [np.asarray(lpips_state[f"lin{i}.model.1.weight"]).reshape(-1)
                for i in range(5)],
    }


# ------------------------------------------------------------- the writer
def _have_safetensors() -> bool:
    try:
        import safetensors  # noqa: F401
    except ImportError:
        return False
    return True


def _find(src: str, patterns) -> Optional[str]:
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(src, pat), recursive=True))
        if hits:
            return hits[0]
    return None


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file → flat {name: numpy array}; a `model`,
    `state_dict` or `params` entry holding the weights is unwrapped."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    import torch

    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "params"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in obj.items() if hasattr(v, "shape")}


def save_entry(dst: str, name: str, params, cfg=None) -> None:
    out = os.path.join(dst, name + ".npz")
    payload = {"params": np.array(params, dtype=object)}
    if cfg is not None:
        payload["cfg"] = np.array(cfg, dtype=object)
    np.savez(out, **payload)
    print(f"  wrote {out}")


def convert_da2(src, dst, encoder="vitl"):
    p = _find(src, ["**/depth_anything_v2_*.pth", "depth_anything_v2*.pth"])
    if not p:
        return print("  [skip] depth_anything_v2: no checkpoint found")
    for enc in ("vits", "vitb", "vitl", "vitg"):
        if enc in os.path.basename(p):
            encoder = enc
    save_entry(dst, "depth_anything_v2",
               convert_torch_depth_anything(load_torch_state(p)),
               {"encoder": encoder})


def convert_mast3r(src, dst):
    p = _find(src, ["**/MASt3R_ViTLarge*metric.pth", "**/mast3r*.pth"])
    if not p:
        return print("  [skip] mast3r: no checkpoint found")
    save_entry(dst, "mast3r", convert_torch_mast3r(load_torch_state(p)))


def convert_sam(src, dst):
    from g4splat_torch.priors.sam import convert_torch_sam

    p = _find(src, ["**/sam_vit_h*.pth", "**/sam_*.pth"])
    if not p:
        return print("  [skip] sam: no checkpoint found")
    save_entry(dst, "sam", convert_torch_sam(load_torch_state(p)))


def _diffusers_state(root: str, name: str) -> Optional[Dict[str, np.ndarray]]:
    pats = ["diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
            "*.safetensors", "*.bin", "*.pth", "*.ckpt"]
    if not _have_safetensors():
        pats = [p for p in pats if not p.endswith(".safetensors")]
    p = _find(root, pats)
    if p is None:
        why = (" (its .safetensors files need the safetensors package)"
               if glob.glob(os.path.join(root, "*.safetensors")) else "")
        print(f"  [skip] {name}: no weight file under {root}{why}")
        return None
    return load_torch_state(p)


def _config_json(root: str) -> dict:
    path = os.path.join(root, "config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def clip_vision_heads(embed_dim: int, config: dict) -> int:
    """config.json's head count where given, else the known widths' (C3)."""
    if "num_attention_heads" in config:
        return int(config["num_attention_heads"])
    if embed_dim not in CLIP_VISION_HEADS:
        raise ValueError(f"unknown CLIP vision width {embed_dim} and no num_attention_heads "
                         f"in config.json: refusing to guess its head count")
    return CLIP_VISION_HEADS[embed_dim]


def clip_vision_config(state: Dict, config: dict) -> dict:
    """The CLIPVision constructor arguments the state dict implies."""
    pre = "vision_model."
    pe = np.asarray(state[pre + "embeddings.patch_embedding.weight"])
    npos = int(np.asarray(state[pre + "embeddings.position_embedding.weight"]).shape[0])
    patch = int(pe.shape[-1])
    return {
        "embed_dim": int(pe.shape[0]),
        "depth": _layer_count(state, pre + "encoder.layers."),
        "patch_size": patch,
        "image_size": int(round((npos - 1) ** 0.5)) * patch,
        "projection_dim": int(np.asarray(state["visual_projection.weight"]).shape[0]),
        "num_heads": clip_vision_heads(int(pe.shape[0]), config),
    }


def clip_text_config(state: Dict, config: dict) -> dict:
    """The CLIPText constructor arguments: every layer the config
    instantiates (SD-2.x's config already says 23 of the 24 shipped), the
    activation (config.json's `hidden_act`, else quick_gelu for the SD-1.x
    width 768), 64-wide heads and the padding id (EOS for SD-1.x, 0 for
    SD-2.x)."""
    n_layers = len({k.split(".")[3] for k in state if k.startswith("text_model.encoder.layers.")})
    depth = min(n_layers, int(config.get("num_hidden_layers", n_layers)))
    width = int(np.asarray(state["text_model.embeddings.token_embedding.weight"]).shape[1])
    hidden_act = config.get("hidden_act")
    sd1 = hidden_act == "quick_gelu" or (hidden_act is None and width == 768)
    return {"depth": depth, "width": width, "act": "quick_gelu" if sd1 else "gelu",
            "num_heads": width // 64, "pad_id": 49407 if sd1 else 0}


def convert_see3d(src, dst):
    base = _find(src, ["**/MVD_weights"]) or src
    for sub, name in (("unet/sparse/ema-checkpoint", "see3d"),
                      ("unet/single/ema-checkpoint", "see3d_sr")):
        root = os.path.join(base, sub)
        if not os.path.isdir(root):
            print(f"  [skip] {name}: {root} not found")
            continue
        state = _diffusers_state(root, name)
        if state is not None:
            save_entry(dst, name, convert_torch_see3d(state))

    vroot = os.path.join(base, "vae")
    if os.path.isdir(vroot):
        state = _diffusers_state(vroot, "vae")
        if state is not None:
            save_entry(dst, "vae", convert_torch_vae(state))
    else:
        print(f"  [skip] vae: {vroot} not found")

    croot = os.path.join(base, "image_encoder")
    state = _diffusers_state(croot, "clip") if os.path.isdir(croot) else None
    if state is not None:
        save_entry(dst, "clip", convert_torch_clip_vision(state),
                   clip_vision_config(state, _config_json(croot)))
    elif not os.path.isdir(croot):
        print(f"  [skip] clip: {croot} not found")

    troot = os.path.join(base, "text_encoder")
    state = _diffusers_state(troot, "clip_text") if os.path.isdir(troot) else None
    if state is not None:
        cfg = clip_text_config(state, _config_json(troot))
        save_entry(dst, "clip_text", convert_torch_clip_text(state, depth=cfg["depth"]), cfg)
    elif not os.path.isdir(troot):
        print(f"  [skip] clip_text: {troot} not found")


def convert_lpips(src, dst):
    vgg = _find(src, ["**/vgg16*.pth", "**/vgg16*.bin"])
    lin = _find(src, ["**/lpips*vgg*.pth", "**/weights/v0.1/vgg.pth"])
    if not vgg or not lin:
        return print("  [skip] lpips: need torchvision vgg16 + LPIPS heads")
    save_entry(dst, "lpips", load_torch_lpips_weights(load_torch_state(vgg),
                                                      load_torch_state(lin)))


CONVERTERS = {
    "depth_anything_v2": convert_da2,
    "mast3r": convert_mast3r,
    "sam": convert_sam,
    "see3d": convert_see3d,
    "lpips": convert_lpips,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the npz prior zoo from the reference's "
                                             "torch checkpoints.")
    ap.add_argument("--src", required=True, help="reference checkpoint root (searched "
                                                 "recursively)")
    ap.add_argument("--dst", required=True, help="npz zoo output dir")
    ap.add_argument("--only", default=None, help=f"comma list from {sorted(CONVERTERS)}")
    args = ap.parse_args(argv)
    os.makedirs(args.dst, exist_ok=True)
    names = args.only.split(",") if args.only else list(CONVERTERS)
    unknown = sorted(set(names) - set(CONVERTERS))
    if unknown:
        ap.error(f"unknown --only entries {unknown}; choose from {sorted(CONVERTERS)}")
    for name in names:
        print(f"[{name}]")
        CONVERTERS[name](args.src, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
