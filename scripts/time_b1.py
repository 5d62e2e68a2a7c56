"""Time kernel B1 (g4splat_torch/csrc/rasterize_fwd.cu) at the three shapes
of chip_smoke.py's main paths, and hold it against its plain version
(chip_smoke's MAP_TOL / FLIP_FRAC gates):

  (a) 768x576, the 200k-splat scene of phase 4 from its orbit camera 0, infer;
  (b) 512x384, the 2.4M-splat frame of phase 5, infer and full;
  (c) 512x384, the training shape of phase 9 (the first training step's
      scene, view 0), nodist and full.

At each it prints the kernel's registers, spills, resident blocks per SM
(rasterize_cuda.kernel_info) and the waves its grid of one block per tile
takes; the entries each tile reads (up to its deepest pixel's stop); the
(warp, entry) steps walked, with a lane still walking, with a contributing
lane, and of those still walking the ones whose entry's reach box misses the
warp's pixels; the bound (chip_smoke.b1_bound); and, timed in turns by CUDA
events, B1's whole call, the splat table's build and the per-entry row
gather ("pack") that render() ran before B1 when B1 read gathered rows.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_b1.py [--reps 10] [--shapes a b c]
        [--variant build/variant.cu ...] [--parent DIR] [--pack]

--variant builds another source of the same C interface and times it in
turns with the default (default, variants, parent, then reversed); nvcc's
ptxas lines give its registers. --parent builds
DIR/g4splat_torch/csrc/rasterize_fwd.cu, a tree whose B1 read gathered
entry rows (g4_rasterize_fwd(entries, tile_start, ...)), and calls it on
table[gauss_id], gathered once outside the timing. --pack also times, in
turns with and without the per-entry gather added back to every B1 call,
render() and its stages at (a) and (b) (infer) and Trainer.step() and its
split at (c).
"""

import argparse
import contextlib
import ctypes
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
import time_b2  # noqa: E402
from g4splat_torch.core.cameras import lookat_camera  # noqa: E402
from g4splat_torch.ops import cuda_build  # noqa: E402
from g4splat_torch.ops import rasterize_cuda as fwd  # noqa: E402
from g4splat_torch.ops.rasterize_common import RenderConfig, preprocess  # noqa: E402
from g4splat_torch.train.trainer import camera_at  # noqa: E402


def parent_call(lib, rows, b, bg, w, h, want_aux, want_dist):
    """One call of a B1 that reads gathered rows (the parent's interface)."""
    fn = lib.g4_rasterize_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((h, w, fwd.OUT_C), device="cuda")
    nc = torch.empty((h, w), dtype=torch.int32, device="cuda")
    err = fn(rows.data_ptr(), b.tile_start.data_ptr(), b.tile_count.data_ptr(), bg.data_ptr(),
             w, h, 0.2, 100.0, int(want_aux), int(want_aux and want_dist), out.data_ptr(),
             nc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent B1 failed: CUDA error {err}")
    return fwd._maps(out, nc)


def shape_inputs(key):
    """(tag, camera, scene, modes, trainer) of shape a, b or c; the trainer
    (shape c only) holds the scene."""
    if key == "a":
        n, w, h = cs.MAIN_SHAPE
        cam = lookat_camera([0.0, -0.8, -6.5], [0, 0, 0], [0, -1, 0], fx=600.0 * w / 768,
                            fy=600.0 * w / 768, width=w, height=h, device=cs.DEVICE)
        return f"(a) {w}x{h} {n}", cam, cs.build_scene(n, 0, sh_degree=3), ("infer",), None
    if key == "b":
        n, w, h = cs.BIG_SHAPE
        cam = lookat_camera([0, -0.8, -6.5], [0, 0, 0], [0, -1, 0], fx=600.0 * w / 768,
                            fy=600.0 * w / 768, width=w, height=h, device=cs.DEVICE)
        return (f"(b) {w}x{h} {n}", cam, cs.build_scene(n, 0, sh_degree=3), ("infer", "full"),
                None)
    trainer, cams, w, h = time_b2.training_trainer()
    return f"(c) training {w}x{h}", camera_at(cams, 0), trainer.scene, ("nodist", "full"), trainer


def pack_ms(cam, scene, b, reps):
    """The splat table's build, and the build plus the per-entry gather
    render() ran before B1 read rows through gauss_id, in ms."""
    prep = preprocess(cam, scene.xyz, scene.scaling(), scene.rotation_raw, scene.opacity(),
                      scene.features(), scene.active_sh_degree, config=RenderConfig())
    gid = b.gauss_id.long()
    table_ms = cs.cuda_ms(lambda: fwd.splat_table(prep), reps=reps)
    gather_ms = cs.cuda_ms(lambda: fwd.splat_table(prep)[gid].contiguous(), reps=reps)
    return table_ms, gather_ms


@contextlib.contextmanager
def gathered():
    """Every B1 call (render(), the training forward) first gathers the
    per-entry rows table[gauss_id], as the pack stage did before B1 read
    rows through gauss_id; only the gather's cost is added."""
    orig = fwd.rasterize_entries

    def packed(table, gauss_id, *args, **kwargs):
        table[gauss_id.long()].contiguous()
        return orig(table, gauss_id, *args, **kwargs)

    fwd.rasterize_entries = packed
    try:
        yield
    finally:
        fwd.rasterize_entries = orig


def pack_turns(tag, cam, scene, trainer, reps):
    """render() at infer (`reps` calls after one unmeasured; shapes a and b)
    or Trainer.step() (shape c: 5 steps and a split of 3, after two
    unmeasured steps) without and with the per-entry gather, in turns
    (without, with, with, without). render()'s kernel stage and the step's
    forward split hold the gather where it runs."""
    if trainer is not None:
        cs.timed_step(trainer)
        trainer.step()
    for pack in (False, True, True, False):
        label = f"{tag} {'with' if pack else 'without'} the per-entry gather"
        with gathered() if pack else contextlib.nullcontext():
            if trainer is None:
                with torch.no_grad():
                    cs.time_render(f"{label} [infer]", cam, scene, RenderConfig(), False,
                                   reps=reps)
                continue
            splits = [cs.timed_step(trainer) for _ in range(3)]
            steps = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step()
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
        med = {k: float(np.median([s_[k] for s_ in splits])) for k in splits[0]}
        print(f"  {label}: Trainer.step() " + " / ".join(f"{t:.3f}" for t in steps)
              + " ms (host clock); split ms (CUDA events, median of 3): "
              + " ".join(f"{k} {v:.3f}" for k, v in med.items()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", nargs="*", default=["a", "b", "c"])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--pack", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_b1: needs a CUDA card", file=sys.stderr)
        return 2
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"device {torch.cuda.get_device_name(0)} ({smi}), torch {torch.__version__}")
    cuda_build.build_all(("rasterize_fwd", "rasterize_bwd"))
    default = cuda_build.load("rasterize_fwd")
    libs = {}
    for v in a.variant:
        try:
            lib, _ = time_b2.build(Path(v), f"variant-fwd-{Path(v).stem}")
        except RuntimeError as e:     # one variant that does not build skips only itself
            cs.check(False, f"variant {v} builds: {e}")
            continue
        libs[Path(v).stem] = lib
    parent = None
    if a.parent:
        parent, _ = time_b2.build(Path(a.parent) / "g4splat_torch/csrc/rasterize_fwd.cu",
                                  "parent-fwd")
    bg = torch.tensor([0.05, 0.1, 0.15], device=cs.DEVICE)    # as kernel_vs_plain's
    with torch.no_grad():
        for key in a.shapes:
            tag, cam, scene, modes, trainer = shape_inputs(key)
            b, table = cs.kernel_inputs(cam, scene)
            w, h = cam.width, cam.height
            n_tiles = b.tile_count.numel()
            print(f"== {tag}: {b.gauss_id.numel()} entries, {table.shape[0]} splats, "
                  f"{n_tiles} tiles, densest tile {int(b.tile_count.max())}", flush=True)
            cs.gathered_bitwise(tag, b, table, w, h, modes)
            maps = cs.plain_walk(b, table, w, h)
            act = cs.fwd_activity(tag, b, table, maps, w, h)
            cs.print_b1_walk(tag, act, b, modes)
            bound, by = cs.b1_bound(tag, act[0], n_tiles, w, h)
            rows = table[b.gauss_id.long()].contiguous() if parent is not None else None
            t_ms, g_ms = pack_ms(cam, scene, b, a.reps)
            print(f"  {tag}: splat table {t_ms:.4f} ms; table + per-entry gather (pack) "
                  f"{g_ms:.4f} ms", flush=True)
            for mode in modes:
                aux, dist = cs.MODES[mode]
                args = (table, b.gauss_id, b.tile_start, b.tile_count, bg, w, h)
                _, ref = cs.kernel_vs_plain(f"{tag} default", b, table, w, h, (mode,),
                                            quiet=True)
                p_ms = cs.cuda_ms(lambda: fwd.rasterize_entries_plain(
                    *args, want_aux=aux, want_dist=dist), reps=1, warmup=0)

                def call(lib):
                    def run():
                        cuda_build._loaded["rasterize_fwd"] = lib
                        return fwd.rasterize_entries(*args, want_aux=aux, want_dist=dist)
                    return run

                timed = {"default": call(default)}
                for name, lib in libs.items():
                    cs.compare_maps(f"{tag} [{mode}] variant {name}", call(lib)(), ref, True)
                    timed[name] = call(lib)
                if parent is not None:
                    cs.compare_maps(f"{tag} [{mode}] parent", parent_call(
                        parent, rows, b, bg, w, h, aux, dist), ref, True)
                    timed["parent"] = lambda: parent_call(parent, rows, b, bg, w, h, aux, dist)
                names = list(timed) + list(timed)[::-1]
                got = {n: [] for n in timed}
                for n in names:
                    got[n].append(cs.cuda_ms(timed[n], reps=a.reps))
                cuda_build._loaded["rasterize_fwd"] = default
                print(f"  {tag} [{mode}] bound {bound:.4f} ms ({by}); plain {p_ms:.2f} ms; "
                      f"pairs the boxes leave {act[0]['needed']}, entries read "
                      f"{act[0]['reads']}; in turns "
                      f"({' '.join(names)}), ms: " + "; ".join(
                          f"{n} " + " / ".join(f"{t:.4f}" for t in v) + f" (median "
                          f"{np.median(v):.4f})" for n, v in got.items()), flush=True)
            del b, table, maps, rows
            if a.pack:
                with torch.enable_grad():
                    pack_turns(tag, cam, scene, trainer, 5 if key == "a" else 3)
            del scene, trainer
            torch.cuda.empty_cache()
    if cs.failures:
        print("time_b1: failed:", *cs.failures, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
