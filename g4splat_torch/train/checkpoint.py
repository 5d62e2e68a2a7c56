"""Trainer checkpoint and exact resume (counterpart of
`g4splat_tpu.train.checkpoint`).

The reference's `gaussians.capture()` / `restore()` flow
(train_with_refine_depth.py:606-608, gaussian_model.py:64-97): the whole
training state goes through one npz, with no pickle:

- the scene buffers (`scene|xyz`, …, `scene|alive`, `scene|mip_filter`);
- Adam's state per parameter group (`adam|{group}|step`, `exp_avg`,
  `exp_avg_sq`) and each group's update count (the xyz schedule's clock);
- the densify statistics (`dstate|grad_accum`, `denom`, `max_radii2d`);
- the view order: the numpy generator's state, the pending permutation
  (`stack`) and the torch generator's state (`generator`, which draws the
  depth-order shifts and the split noise);
- the iteration, SH degrees, `use_mip_filter` and capacity as JSON (`meta`).

The JAX package's file stores no view order (ROADMAP C24): a trainer it
restores draws its views from a fresh permutation. This one restores it, so
on the CPU n steps, save, load and m steps give the bits of n + m steps.
`g4splat_torch.convert.trainer_state_from_jax` reads the JAX package's file.
PLY snapshots are the orchestrator's (`save_gaussian_ply`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from g4splat_torch.train.densify import DensifyState

SCENE_FIELDS = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw",
                "alive", "mip_filter")
ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")
DSTATE_FIELDS = ("grad_accum", "denom", "max_radii2d")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_trainer_state(path: str, trainer) -> None:
    """Write the trainer's whole state to the npz `path`."""
    scene = trainer.scene
    arrays = {f"scene|{k}": _np(getattr(scene, k)) for k in SCENE_FIELDS}
    updates = {}
    for group in trainer.optimizer.param_groups:
        name = group["name"]
        updates[name] = group["updates"]
        state = trainer.optimizer.state.get(group["params"][0], {})
        for k in ADAM_KEYS:
            if k in state:
                arrays[f"adam|{name}|{k}"] = _np(state[k])
    for k in DSTATE_FIELDS:
        arrays[f"dstate|{k}"] = _np(getattr(trainer.dstate, k))
    arrays["stack"] = np.asarray(trainer._stack, np.int64)
    arrays["generator"] = _np(trainer.generator.get_state())
    meta = {
        "iteration": trainer.iteration,
        "active_sh_degree": scene.active_sh_degree,
        "max_sh_degree": scene.max_sh_degree,
        "use_mip_filter": scene.use_mip_filter,
        "capacity": scene.capacity,
        "updates": updates,
        "rng": trainer.rng.bit_generator.state,
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def read_meta(data) -> dict:
    return json.loads(bytes(data["meta"]).decode())


@torch.no_grad()
def restore_trainer(trainer, scene_arrays, adam, updates, dstate, iteration: int,
                    active_sh_degree: int, use_mip_filter: bool):
    """Write host arrays into `trainer` on its device: the scene's parameters
    into the optimizer's leaves, Adam's state per group ({name: {key:
    array}}; a group missing from `adam` keeps no state), the update counts
    and the densify statistics."""
    dev = trainer.scene.device
    for k, p in trainer.params.items():
        p.copy_(torch.from_numpy(np.asarray(scene_arrays[k])).to(dev, p.dtype))
    trainer.scene = trainer.scene.replace(
        **trainer.params,
        alive=torch.from_numpy(np.asarray(scene_arrays["alive"])).to(dev, torch.bool),
        mip_filter=torch.from_numpy(np.asarray(scene_arrays["mip_filter"])).to(
            dev, torch.float32),
        active_sh_degree=int(active_sh_degree), use_mip_filter=bool(use_mip_filter))
    opt = trainer.optimizer
    for group in opt.param_groups:
        name, p = group["name"], group["params"][0]
        group["updates"] = int(updates[name])
        opt.state.pop(p, None)
        if name not in adam:
            continue
        on_device = group.get("capturable") or group.get("fused")
        step = torch.tensor(float(adam[name]["step"]), dtype=torch.float32,
                            device=dev if on_device else "cpu")
        opt.state[p] = {"step": step, **{
            k: torch.from_numpy(np.asarray(adam[name][k])).to(dev, p.dtype).reshape(p.shape)
            for k in ("exp_avg", "exp_avg_sq")}}
    trainer.dstate = DensifyState(*(torch.from_numpy(np.asarray(dstate[k])).to(
        dev, torch.float32) for k in DSTATE_FIELDS))
    trainer.iteration = int(iteration)
    if trainer.slab_mode:
        trainer._refresh_partitions()


def load_trainer_state(path: str, trainer) -> None:
    """Restore `trainer` in place from `path`. The trainer must be built with
    the file's capacity (ValueError otherwise) and config."""
    with np.load(path, allow_pickle=False) as data:
        meta = read_meta(data)
        if meta["capacity"] != trainer.scene.capacity:
            raise ValueError(f"capacity mismatch: checkpoint {meta['capacity']}, "
                             f"trainer {trainer.scene.capacity}")
        adam = {}
        for k in data.files:
            if k.startswith("adam|"):
                _, name, key = k.split("|")
                adam.setdefault(name, {})[key] = data[k]
        restore_trainer(trainer, {k: data[f"scene|{k}"] for k in SCENE_FIELDS}, adam,
                        meta["updates"], {k: data[f"dstate|{k}"] for k in DSTATE_FIELDS},
                        meta["iteration"], meta["active_sh_degree"], meta["use_mip_filter"])
        trainer.rng.bit_generator.state = meta["rng"]
        trainer._stack = [int(v) for v in data["stack"]]
        trainer.generator.set_state(torch.from_numpy(data["generator"].copy()))
