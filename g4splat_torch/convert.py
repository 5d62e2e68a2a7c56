"""Carry a scene, cameras and training inputs across from the JAX package as
numpy arrays.

`scene_from_arrays` / `camera_from_arrays` take the fields of
`g4splat_tpu`'s `GaussianScene` and `Camera` as array-likes;
`scene_from` / `camera_from` read those fields off any object that has them
(through ``np.asarray``), and `train_config_from` / `views_from` do the same
for `TrainConfig` and `ViewData`, so the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses

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
    return make_camera(np.array(w2c, np.float32), np.float32(fx), np.float32(fy),
                       np.float32(cx), np.float32(cy), width, height,
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
