"""Carry a scene, cameras and training inputs across from the JAX package as
numpy arrays.

`scene_from_arrays` / `camera_from_arrays` take the fields of
`g4splat_tpu`'s `GaussianScene` and `Camera` as array-likes;
`scene_from` / `camera_from` read those fields off any object that has them
(through ``np.asarray``), and `train_config_from` / `views_from` do the same
for `TrainConfig` and `ViewData`, so the port never imports the JAX package.

`lpips_params_from` turns the JAX package's LPIPS params (HWIO
convolutions) into the port's (OIHW). `flax_state_dict` turns the flax params of the JAX package's prior networks
(`MultiViewUNet`, `AutoencoderKL`, `CLIPVision`, `CLIPText`) into the state
dicts of the port's modules of the same names; `depth_anything_state_dict`
does the same for `DepthAnythingV2`, and `mast3r_state_dict` for
`AsymmetricMASt3R`, whose names follow the reference torch checkpoints
instead. `chart_params_from` carries the chart-alignment init.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

import numpy as np
import torch

from g4splat_torch.core.cameras import Camera, make_camera
from g4splat_torch.device import DeviceLike, resolve_device
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.train.trainer import TrainConfig, ViewData

SCENE_ARRAYS = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw",
                "rotation_raw", "alive", "mip_filter")
CAMERA_ARRAYS = ("w2c", "fx", "fy", "cx", "cy")


def scene_from_arrays(xyz, f_dc, f_rest, opacity_raw, scaling_raw, rotation_raw,
                      alive, mip_filter, max_sh_degree: int = 3,
                      active_sh_degree: int = 0, use_mip_filter: bool = False,
                      device: DeviceLike = None) -> GaussianScene:
    dev = resolve_device(device)

    def f32(x):     # a copy: arrays handed over from JAX are read-only
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    return GaussianScene(
        xyz=f32(xyz), f_dc=f32(f_dc), f_rest=f32(f_rest),
        opacity_raw=f32(opacity_raw), scaling_raw=f32(scaling_raw),
        rotation_raw=f32(rotation_raw),
        alive=torch.as_tensor(np.array(alive, bool), device=dev),
        mip_filter=f32(mip_filter), max_sh_degree=int(max_sh_degree),
        active_sh_degree=int(active_sh_degree),
        use_mip_filter=bool(use_mip_filter))


def camera_from_arrays(w2c, fx, fy, cx, cy, width: int, height: int,
                       znear: float = 0.01, zfar: float = 100.0,
                       device: DeviceLike = None) -> Camera:
    return make_camera(*(np.array(x, np.float32) for x in (w2c, fx, fy, cx, cy)), width, height,
                       znear=znear, zfar=zfar, device=device)


def scene_from(obj, device: DeviceLike = None) -> GaussianScene:
    """Port scene from an object with GaussianScene's fields (e.g. the JAX one)."""
    return scene_from_arrays(
        *(np.asarray(getattr(obj, k)) for k in SCENE_ARRAYS),
        max_sh_degree=obj.max_sh_degree, active_sh_degree=obj.active_sh_degree,
        use_mip_filter=obj.use_mip_filter, device=device)


def camera_from(obj, device: DeviceLike = None) -> Camera:
    """Port camera from an object with Camera's fields (e.g. the JAX one)."""
    return camera_from_arrays(
        *(np.asarray(getattr(obj, k)) for k in CAMERA_ARRAYS),
        width=obj.width, height=obj.height, znear=obj.znear, zfar=obj.zfar,
        device=device)


def train_config_from(obj) -> TrainConfig:
    """Port TrainConfig from an object with TrainConfig's fields; fields it
    lacks keep the port's defaults."""
    return TrainConfig(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(TrainConfig) if hasattr(obj, f.name)})


def views_from(obj, device: DeviceLike = None) -> ViewData:
    """Port ViewData from an object with ViewData's fields (e.g. the JAX one)."""
    dev = resolve_device(device)
    return ViewData(*(torch.as_tensor(np.array(getattr(obj, k), np.float32), device=dev)
                      for k in ViewData._fields))


def _torch_name(segment: str) -> str:
    """A flax module name as a torch state-dict path: indices become path
    parts (``input_blocks_1_1`` → ``input_blocks.1.1``,
    ``down_blocks_0_downsamplers_0_conv`` → ``down_blocks.0.downsamplers.0.conv``,
    ``ff_net_0_proj`` → ``ff.net.0.proj``)."""
    segment = re.sub(r"(\d)_", r"\1.", re.sub(r"_(\d+)", r".\1", segment))
    return segment.replace("ff_net", "ff.net")


def flax_state_dict(params) -> Dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays, with or without the top-level
    ``"params"``) → a torch state dict. Each inverts the JAX converters'
    layout rule: a conv kernel (kh, kw, I, O) → weight (O, I, kh, kw), a dense
    kernel (I, O) → weight (O, I), a norm's scale → weight; biases and bare
    parameters (embeddings) keep their names and layout."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [_torch_name(name)])
                continue
            v = np.array(value, np.float32)
            if name == "kernel":
                name, v = "weight", v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            elif name == "scale":
                name = "weight"
            out[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(v))

    walk(params, [])
    return out


def lpips_params_from(params, device: DeviceLike = None) -> Dict:
    """The JAX package's LPIPS params ({"conv": [{"w": (3, 3, I, O), "b"}],
    "lin": [(C,)] * 5}) → the port's (`eval.image_metrics`): convolutions
    (O, I, 3, 3), biases and the five heads copied."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    return {"conv": [{"w": f32(np.asarray(c["w"]).transpose(3, 2, 0, 1)), "b": f32(c["b"])}
                     for c in params["conv"]],
            "lin": [f32(w) for w in params["lin"]]}


def depth_anything_state_dict(params, encoder: str = "vitl") -> Dict[str, torch.Tensor]:
    """The JAX package's `DepthAnythingV2` flax params → the port's state dict
    (the official checkpoint's names). The inverse of the JAX package's
    `convert_torch_checkpoint`: DINOv2's ``blocks_i`` become ``blocks.i``, the
    head's ``projects_i`` / ``resize_i`` / ``layerN_rn`` / ``refinenetN`` /
    ``output_conv2_i`` become ``projects.i`` / ``resize_layers.i`` /
    ``scratch.*`` / ``scratch.output_conv2.i``, and the two transposed
    convolutions flip their taps back: flax (kh, kw, in, out) mirrored in kh
    and kw → torch (in, out, kh, kw). The parameters the JAX model does not
    create (`pretrained.mask_token`, unused at inference, and refinenet4's
    `resConfUnit1`, which the reference creates and never calls) are
    zero-filled."""
    from g4splat_torch.priors.depth_anything import DPT_FEATURES
    from g4splat_torch.priors.dinov2 import VIT_CONFIGS

    params = params.get("params", params)
    out = {"pretrained." + k: v for k, v in flax_state_dict(params["pretrained"]).items()}
    head = dict(params["depth_head"])
    for i in (0, 1):
        layer = head.pop(f"resize_{i}")
        w = np.array(layer["kernel"], np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
        out[f"depth_head.resize_layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"depth_head.resize_layers.{i}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32))
    renamed = {"resize_3": "resize_layers_3"}
    for name, layer in head.items():
        if name.startswith("layer"):            # layerN_rn keeps its name
            out.update({f"depth_head.scratch.{name}.{k}": v
                        for k, v in flax_state_dict(layer).items()})
            continue
        prefix = ("depth_head." if name.startswith("projects_") or name in renamed
                  else "depth_head.scratch.")
        for k, v in flax_state_dict({renamed.get(name, name): layer}).items():
            out[prefix + k] = v
    dim, f = VIT_CONFIGS[encoder]["embed_dim"], DPT_FEATURES[encoder]
    out.setdefault("pretrained.mask_token", torch.zeros(1, dim))
    for conv in ("conv1", "conv2"):
        out.setdefault(f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.weight",
                       torch.zeros(f, f, 3, 3))
        out.setdefault(f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.bias",
                       torch.zeros(f))
    return out


def mast3r_state_dict(params, cfg=None) -> Dict[str, torch.Tensor]:
    """The JAX package's `MASt3RModel.params` → the port's `AsymmetricMASt3R`
    state dict (the reference checkpoint's names). The inverse of the JAX
    package's `convert_torch_mast3r`: ``headK`` becomes
    ``downstream_headK``; its DPT's ``projects_i`` / ``resize_i`` become
    ``act_postprocess.i.0`` / ``.1`` (the transposed convolutions flip
    their taps back), ``layerN_rn`` and ``refinenetN`` go under ``scratch``
    (``layer_rn.{N-1}`` names the same convolution), and ``output_conv1`` /
    ``output_conv2_0`` / ``output_conv2_2`` become ``head.0`` / ``.2`` /
    ``.4``. The parameters the JAX model does not create (`mask_token`,
    unused, and refinenet4's `resConfUnit1`, created and never called by the
    reference) are zero-filled."""
    from g4splat_torch.priors.mast3r import MASt3RConfig

    cfg = cfg or MASt3RConfig()
    params = dict(params.get("params", params))
    heads = {k: params.pop(k) for k in ("head1", "head2")}
    out = flax_state_dict(params)
    out["mask_token"] = torch.zeros(1, 1, cfg.dec_embed_dim)
    f = cfg.dpt_features
    for k, head in heads.items():
        pre = f"downstream_{k}."
        out.update({pre + "head_local_features." + n: v for n, v in
                    flax_state_dict(head["head_local_features"]).items()})
        dpt = dict(head["dpt"])
        for i in (0, 1):
            layer = dpt.pop(f"resize_{i}")
            w = np.array(layer["kernel"], np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
            out[f"{pre}dpt.act_postprocess.{i}.1.weight"] = torch.from_numpy(
                np.ascontiguousarray(w))
            out[f"{pre}dpt.act_postprocess.{i}.1.bias"] = torch.from_numpy(
                np.array(layer["bias"], np.float32))
        names = {"resize_3": "act_postprocess.3.1", "output_conv1": "head.0",
                 "output_conv2_0": "head.2", "output_conv2_2": "head.4"}
        names.update({f"projects_{i}": f"act_postprocess.{i}.0" for i in range(4)})
        for name, layer in dpt.items():
            target = names.get(name, "scratch." + name)
            out.update({f"{pre}dpt.{target}.{n}": v
                        for n, v in flax_state_dict(layer).items()})
        for i in range(4):
            out[f"{pre}dpt.scratch.layer_rn.{i}.weight"] = out[
                f"{pre}dpt.scratch.layer{i + 1}_rn.weight"]
        for conv in ("conv1", "conv2"):
            out[f"{pre}dpt.scratch.refinenet4.resConfUnit1.{conv}.weight"] = torch.zeros(
                f, f, 3, 3)
            out[f"{pre}dpt.scratch.refinenet4.resConfUnit1.{conv}.bias"] = torch.zeros(f)
    return out


def chart_params_from(params, device: DeviceLike = None) -> Dict:
    """The JAX package's chart-alignment `init_params` tree ({"enc": [...],
    "denc", "mlp": [{"w", "b"}], "conf_raw"}) → the port's, as float32
    tensors."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    return {"enc": [f32(g) for g in params["enc"]], "denc": f32(params["denc"]),
            "mlp": [{"w": f32(l["w"]), "b": f32(l["b"])} for l in params["mlp"]],
            "conf_raw": f32(params["conf_raw"])}
