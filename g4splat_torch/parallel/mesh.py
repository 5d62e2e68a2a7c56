"""Device meshes for one controller (counterpart of `g4splat_tpu.parallel.mesh`).

The JAX package is single-controller SPMD: one Python program holds a
`Mesh` of devices with axes ``("data", "model")`` and `shard_map` places the
collectives. This module keeps that model in PyTorch:

- `DeviceMesh` is an (n_data, n_model) grid of `torch.device`s whose entry
  [0, 0] is the home device. Entries may repeat a device: a mesh of four
  entries of ``cuda:0`` (or of ``cpu``) runs every shard, strip and slab
  through the same kernels as four cards would, which is how the tests and
  chip_smoke run the mesh paths on one device, as the JAX tests run them on
  virtual CPU devices.
- Collectives are explicit copies: all_gather is ``.to(home)`` then a
  concatenation, psum / pmean a sum or mean after it. Autograd
  differentiates ``.to()`` across devices, so a loss computed on the home
  device sends each shard exactly its slice of the cotangent.
- `fan_out` runs one call per mesh entry. Entries on one device run in turn
  on it; distinct devices each get a host thread (as
  `torch.nn.parallel.parallel_apply` does), since the binning syncs the host
  and one thread looping over cards would serialise them.
- `run_spmd` runs one thread per entry for code that meets the other
  entries inside a collective (`Rendezvous.all_gather`), such as the
  See3D UNet's joint attention.

`available_devices` is the one place that lists the devices a pipeline fans
out over. `torch.distributed` is not used: one program per card does not
match the JAX package's single-program semantics, and NCCL refuses two
ranks on one card.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def available_devices(device: torch.device) -> List[torch.device]:
    """The devices a pipeline on `device` fans out over: every visible card
    for a CUDA device, else `device` alone."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def fan_mesh(device: torch.device, n_items: int) -> Optional["DeviceMesh"]:
    """A `data` mesh over the first min(n_items, count) devices that
    `available_devices(device)` lists, or None below two entries (the
    single-device branches)."""
    devs = available_devices(device)[:n_items]
    return make_mesh(n_data=len(devs), devices=devs) if len(devs) > 1 else None


def _check_device(dev: torch.device) -> torch.device:
    """`dev` as a torch.device; an absent card raises (no fallback)."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh entry {dev}: no such CUDA device is present")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"mesh entry {dev}: unsupported device type")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An (n_data, n_model) grid of devices; entries may repeat a device."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each `data` entry (model index 0)."""
        return [row[0] for row in self.devices]

    @property
    def model_devices(self) -> List[torch.device]:
        """The device of each `model` entry (data index 0)."""
        return list(self.devices[0])

    @property
    def distinct(self) -> List[torch.device]:
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """The first n_data·n_model of `devices` (default: the visible cards) as
    an (n_data, n_model) grid, row-major as `jax.sharding.Mesh`."""
    if devices is None:
        devices = available_devices(torch.device("cuda"))
    devices = [_check_device(d) for d in devices]
    n_data = n_data or len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} "
                         f"devices, {len(devices)} given")
    return DeviceMesh(tuple(tuple(devices[d * n_model:(d + 1) * n_model])
                            for d in range(n_data)))


# ------------------------------------------------------------------ trees
def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """Apply `fn` to every tensor of a tree of dicts, lists, tuples,
    NamedTuples and dataclasses (Camera, GaussianScene); other leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def tree_cat(trees: Sequence, device: torch.device):
    """Concatenate same-structure trees along their leading axis on `device`."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees])
    if isinstance(first, dict):
        return {k: tree_cat([t[k] for t in trees], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_cat([t[i] for t in trees], device)
                           for i in range(len(first)))
    raise TypeError(f"cannot concatenate {type(first).__name__}")


def shard_batch(mesh: DeviceMesh, tree) -> List:
    """One tree per `data` entry: every tensor with a leading axis split in
    n_data equal parts, part d on entry d's device; 0-d tensors are copied
    whole. The leading axes must divide over `data`."""
    n = mesh.shape["data"]
    parts = []
    for d, dev in enumerate(mesh.data_devices):
        def take(x, d=d, dev=dev):
            if x.ndim == 0:
                return x.to(dev)
            if x.shape[0] % n:
                raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                                 f"the data axis ({n})")
            b = x.shape[0] // n
            return x[d * b:(d + 1) * b].to(dev)
        parts.append(tree_map(take, tree))
    return parts


def replicate(mesh: DeviceMesh, tree) -> Dict[torch.device, Any]:
    """One copy of `tree` per distinct device of the mesh; entries that
    repeat a device share its copy (the tree itself where it already lies)."""
    return {dev: tree_map(lambda x, dev=dev: x.to(dev), tree) for dev in mesh.distinct}


def pad_to_multiple(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """`x` with its last item repeated until the leading axis divides by n,
    and the count of items added."""
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
    return x, pad


# --------------------------------------------------------------- execution
@contextlib.contextmanager
def _on(dev: torch.device, grad: bool):
    with torch.set_grad_enabled(grad):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                yield
        else:
            yield


def fan_out(devices: Sequence[torch.device], fn: Callable[[int], Any]) -> List:
    """[fn(i) for each entry i on devices[i]]: entries that share a device
    run in turn; with several distinct devices, one host thread each, under
    the caller's grad mode. The first exception raised is re-raised."""
    groups: Dict[torch.device, List[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(torch.device(dev), []).append(i)
    if len(groups) == 1:
        return [fn(i) for i in range(len(devices))]
    grad = torch.is_grad_enabled()

    def run(dev, ids):
        with _on(dev, grad):
            return [(i, fn(i)) for i in ids]

    out: Dict[int, Any] = {}
    with ThreadPoolExecutor(len(groups)) as pool:
        futures = [pool.submit(run, dev, ids) for dev, ids in groups.items()]
        for f in futures:
            out.update(f.result())
    return [out[i] for i in range(len(devices))]


class Rendezvous:
    """The collectives of `run_spmd`'s threads: entry r's `all_gather(r, x)`
    returns every entry's x concatenated along the leading axis, in entry
    order, on x's device. Each call is two barrier waits: one after every
    entry has posted, one after every entry has read."""

    def __init__(self, n: int, timeout: Optional[float] = None):
        self._slots: List[Optional[torch.Tensor]] = [None] * n
        self._barrier = threading.Barrier(n, timeout=timeout)

    def all_gather(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        self._slots[rank] = x
        self._barrier.wait()
        full = torch.cat([s.to(x.device) for s in self._slots])
        self._barrier.wait()
        return full

    def abort(self):
        self._barrier.abort()


@dataclasses.dataclass(frozen=True)
class Shard:
    """What entry `index` of a `run_spmd` call passes to code that joins the
    collectives."""
    index: int
    rendezvous: Rendezvous

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.rendezvous.all_gather(self.index, x)


def run_spmd(devices: Sequence[torch.device], fn: Callable[[Shard], Any],
             timeout: Optional[float] = None) -> List:
    """[fn(Shard(i, r)) for each entry i], each in its own host thread on
    devices[i] under the caller's grad mode, so that the entries meet in the
    rendezvous' collectives. An exception in one entry breaks the barrier
    for the others and is re-raised here."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    rv = Rendezvous(n, timeout)
    grad = torch.is_grad_enabled()

    def run(i):
        try:
            with _on(devices[i], grad):
                return fn(Shard(i, rv))
        except BaseException:
            rv.abort()
            raise

    with ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(run, i) for i in range(n)]
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as e:      # re-raised below, after every join
                errors.append(e)
    if errors:
        # The entry that failed, not those its abort broke out of the barrier.
        real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return results


def map_over_data(mesh: DeviceMesh, fn: Callable, items: torch.Tensor, *more: torch.Tensor,
                  per_device: Optional[int] = None):
    """fn(device, *chunks) over the items' leading axis, split across the
    `data` entries and gathered on the home device. The axis is padded to a
    multiple of n_data by repeating the last item, and the pad dropped after;
    with `per_device`, the items go in slabs of per_device·n_data. fn returns
    a tensor or a tree of tensors with the chunk's leading axis."""
    n = mesh.shape["data"]
    devs = mesh.data_devices
    slab = len(items) if per_device is None else per_device * n
    outs = []
    for s in range(0, len(items), slab):
        arrays = [a[s:s + slab] for a in (items,) + more]
        m = len(arrays[0])
        arrays = [pad_to_multiple(a, n)[0] for a in arrays]
        b = len(arrays[0]) // n
        parts = fan_out(devs, lambda d: fn(devs[d], *(a[d * b:(d + 1) * b].to(devs[d])
                                                      for a in arrays)))
        out = tree_cat(parts, mesh.home)
        outs.append(tree_map(lambda x, m=m: x[:m], out))
    return tree_cat(outs, mesh.home) if len(outs) > 1 else outs[0]


class Replicas:
    """A module's copy on each device, made once: the module itself on its
    own device, a deep copy moved to any other."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self._copies: Dict[torch.device, torch.nn.Module] = {}
        self._lock = threading.Lock()

    def on(self, device: torch.device) -> torch.nn.Module:
        home = next(self.module.parameters()).device
        if torch.device(device) == home:
            return self.module
        with self._lock:
            if device not in self._copies:
                self._copies[device] = copy.deepcopy(self.module).to(device)
            return self._copies[device]


# ---------------------------------------------------------------- renders
def _render_config(keys, depth_ratio: float):
    from g4splat_torch.ops.rasterize_common import RenderConfig

    # The distortion-moment scans only when a distortion channel is asked for.
    return RenderConfig(depth_ratio=depth_ratio, compute_distortion=bool(
        {"rend_dist", "dist_m1", "dist_m2"} & set(keys)))


def view_parallel_render(mesh: DeviceMesh, scene, cameras, backend: str = "cuda",
                         keys: Sequence[str] = ("render", "rend_alpha", "rend_normal",
                                                "surf_depth"),
                         depth_ratio: float = 0.0) -> Dict[str, torch.Tensor]:
    """Render a camera batch with each `data` entry rendering its view shard
    (one render() per view on the entry's device, the scene copied once per
    distinct device); no collective but the gather. The number of views must
    divide over `data`: pad with a repeated camera and drop the tail.
    Returns {key: (V, H, W[, C])} on the home device."""
    from g4splat_torch.core.cameras import camera_at
    from g4splat_torch.ops.rasterize import render

    n_views = cameras.w2c.shape[0]
    n_data = mesh.shape["data"]
    if n_views % n_data:
        raise ValueError(f"views ({n_views}) must divide over the data axis ({n_data})")
    cfg = _render_config(keys, depth_ratio)
    scenes = replicate(mesh, scene)
    cams = shard_batch(mesh, cameras)
    devs = mesh.data_devices
    b = n_views // n_data

    def entry(d):
        outs = [render(camera_at(cams[d], i), scenes[devs[d]], config=cfg, backend=backend)
                for i in range(b)]
        return {k: torch.stack([o[k] for o in outs]) for k in keys}

    return tree_cat(fan_out(devs, entry), mesh.home)


def render_views(mesh: DeviceMesh, scene, cameras, n_views: int, backend: str = "cuda",
                 keys: Sequence[str] = ("render",), depth_ratio: float = 0.0
                 ) -> Dict[str, torch.Tensor]:
    """`view_parallel_render` of the first n_views cameras, padded to a
    multiple of the `data` entries by repeating the last camera, the pad
    dropped after."""
    cams = tree_map(lambda x: pad_to_multiple(x[:n_views], mesh.shape["data"])[0], cameras)
    out = view_parallel_render(mesh, scene, cams, backend=backend, keys=keys,
                               depth_ratio=depth_ratio)
    return {k: v[:n_views] for k, v in out.items()}


def tile_parallel_render(mesh: DeviceMesh, scene, camera, backend: str = "cuda",
                         keys: Sequence[str] = ("render", "rend_alpha", "surf_depth"),
                         config=None) -> Dict[str, torch.Tensor]:
    """Render one image with its tile rows split over `data`: entry d renders
    a strip of rows through a cropped camera (cy − y0, the strip's height)
    with render()'s `config`; culling is rect-against-grid, so a splat
    reaching into a strip from outside is kept by that strip. The last strip
    is padded and the result cropped to H. `surf_normal` / `surf_normal_cam`
    are recomputed once from the assembled `surf_depth`, since normals from
    depth read neighbouring pixels across the seams. The strips equal the
    full frame where its binning drops no tile of a splat
    (`max_tiles_per_splat` cuts a splat's tiles in row-major order, and a
    strip holds fewer of them; ROADMAP C29)."""
    from g4splat_torch.core.geometry import depth_to_normal
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.ops.rasterize_common import TILE

    H = camera.height
    n_data = mesh.shape["data"]
    rows = (H + TILE - 1) // TILE
    strip_h = (rows + n_data - 1) // n_data * TILE
    surf = [k for k in keys if k in ("surf_normal", "surf_normal_cam")]
    strip_keys = [k for k in keys if k not in surf]
    if surf and "surf_depth" not in strip_keys:
        strip_keys.append("surf_depth")
    # The inference kernel unless an aux channel is asked for.
    need_aux = any(k in ("rend_dist", "n_contrib", "dist_m1", "dist_m2") for k in keys)
    scenes = replicate(mesh, scene)
    devs = mesh.data_devices

    def entry(d):
        cam = camera.to(devs[d])
        crop = cam.replace(cy=cam.cy - float(d * strip_h), height=strip_h)
        out = render(crop, scenes[devs[d]], config=config, backend=backend,
                     need_aux=need_aux)
        return {k: out[k] for k in strip_keys}

    strips = fan_out(devs, entry)
    result = {k: v[:H] for k, v in tree_cat(strips, mesh.home).items()}
    if surf:
        cam = camera.to(mesh.home)
        sn = depth_to_normal(cam, result["surf_depth"])
        if "rend_alpha" in result:
            sn = sn * result["rend_alpha"][..., None]
        if "surf_normal" in surf:
            result["surf_normal"] = sn
        if "surf_normal_cam" in surf:
            result["surf_normal_cam"] = sn @ cam.c2w[:3, :3]
    return {k: result[k] for k in keys}


def data_parallel_train_step(mesh: DeviceMesh, cfg):
    """A data-parallel training step without densify statistics:
    ``step(scene, optimizer, cameras, views, view_ids, iteration,
    generator=None) -> loss``. The views `view_ids` split over `data`, each
    entry's loss is the mean of its views' losses, gradients are averaged
    over `data` and `optimizer` (whose leaves are the scene's parameters)
    steps once. `Trainer(mesh=…)` runs `train.trainer.make_dp_train_step`,
    which also accumulates the densify statistics."""
    from g4splat_torch.train.trainer import make_dp_train_step

    full = make_dp_train_step(mesh)
    no_stats = cfg.replace(densify_until_iter=0)

    def step(scene, optimizer, cameras, views, view_ids, iteration, generator=None):
        _, metrics = full(scene, optimizer, None, cameras, views, view_ids, iteration,
                          no_stats, generator=generator)
        return metrics["loss"]

    return step
