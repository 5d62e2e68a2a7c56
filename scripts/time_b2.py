"""Time kernel B2 (g4splat_torch/csrc/rasterize_bwd.cu) at the training
shape of chip_smoke.py (512x384, the first training step's scene of a
2.4M-slot grey init, view 0) in both modes, and hold it and its work list
against their plain versions (chip_smoke's GRAD_TOL per gradient group).
Prints the per-tile walk lengths that set its balance, the (warp, entry)
steps in which some lane contributes and those the entries' reach boxes
skip, the walk kernel's registers and resident blocks, and the whole call.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_b2.py [--reps 10] [--variant build/variant.cu ...]
        [--parent DIR]

--variant builds another source of the same interface and times it in turns
with the default (default, variants, variants reversed, default). --parent
builds DIR/g4splat_torch/csrc/rasterize_bwd.cu, a tree whose B2 read
gathered entry rows (the same C interface, its first argument the (E, 16)
rows table[gauss_id], gathered once outside the timing), and times it in
the same turns.
"""

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.ops import cuda_build  # noqa: E402
from g4splat_torch.ops import rasterize_cuda_bwd as bwd  # noqa: E402
from g4splat_torch.train.trainer import Trainer, TrainConfig, camera_at  # noqa: E402


def training_trainer():
    """A Trainer (production TrainConfig) on chip_smoke phase 8's data, its
    cameras, and the frame's width and height."""
    n_live, cap, w, h, n_views, _, _ = cs.TRAIN_SHAPE
    init, cams, views = cs.training_data(n_live, cap, w, h, n_views)
    return Trainer(init, cams, views, TrainConfig(max_capacity=cap), seed=0), cams, w, h


def training_shape():
    """The frame of chip_smoke phase 9: view 0's camera and the first step's
    scene (mip filter applied), and the frame's width and height."""
    trainer, cams, w, h = training_trainer()
    return camera_at(cams, 0), trainer.scene, w, h


def build(src: Path, tag: str):
    """nvcc `src` with the port's flags, and the port's csrc/ on the include
    path, into build/kernels/ and load it. Returns the library and the
    compiler's log."""
    out = cuda_build.BUILD_DIR / f"lib{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
                          "-o", str(out), str(src)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{log.stdout}{log.stderr}")
    print(f"  built {src}: " + "; ".join(
        l.strip() for l in (log.stdout + log.stderr).splitlines() if "registers" in l))
    return ctypes.CDLL(str(out)), log.stdout + log.stderr


def parent_call(lib, rows, args, want_dist):
    """One call of a B2 that reads gathered rows (the parent's interface:
    the work-list scratch, and `rows` = table[gauss_id] in the table's place)."""
    fn = lib.g4_rasterize_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ts = (rows,) + args[1:7]
    n_tiles = args[3].numel()
    work = torch.empty(2 * n_tiles + 2, dtype=torch.int32, device="cuda")
    grad = torch.zeros((args[0].shape[0], bwd.GRAD_F), device="cuda")
    err = fn(*(t.data_ptr() for t in ts), args[7], args[8], 0.2, 100.0, int(want_dist),
             work.data_ptr(), grad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent B2 failed: CUDA error {err}")
    return grad


def whole_call(args, want_dist):
    """One backward call of the loaded B2 library."""
    return bwd.rasterize_backward(*args, want_dist=want_dist)


def grade(tag, got, ref):
    errs = {n: float((got[:, sl] - ref[:, sl]).norm() / ref[:, sl].norm())
            for n, sl in cs.GRAD_GROUPS.items()}
    cs.check(max(errs.values()) <= cs.GRAD_TOL, f"{tag}: ||kernel - plain|| / ||plain|| "
             + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) + f" <= {cs.GRAD_TOL}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--parent", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_b2: needs a CUDA card", file=sys.stderr)
        return 2
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"device {torch.cuda.get_device_name(0)} ({smi}), torch {torch.__version__}")
    log = cuda_build.build_all(("rasterize_fwd", "rasterize_bwd"))["rasterize_bwd"]
    print("\n".join(f"  {line.strip()}" for line in log.splitlines() if "registers" in line))
    default = cuda_build.load("rasterize_bwd")
    variants = {Path(v).stem: build(Path(v), f"variant-{Path(v).stem}")[0] for v in a.variant}
    parent = (build(Path(a.parent) / "g4splat_torch/csrc/rasterize_bwd.cu", "parent-bwd")[0]
              if a.parent else None)
    cam, scene, w, h = training_shape()
    with torch.no_grad():
        b, table = cs.kernel_inputs(cam, scene)
        print(f"training shape {w}x{h}: {b.gauss_id.numel()} entries, {table.shape[0]} splats, "
              f"{b.tile_count.numel()} tiles, densest tile {int(b.tile_count.max())}", flush=True)
        rows = table[b.gauss_id.long()].contiguous() if parent is not None else None
        runs = cs.bwd_vs_plain("training shape", b, table, w, h)
        for want_dist, (args, stats) in runs.items():
            mode = "full" if want_dist else "nodist"
            print(f"  [{mode}] walk per tile: {cs.format_histogram(cs.walk_histogram(args))}")
            info = bwd.kernel_info(want_dist)
            print(f"  [{mode}] {info}")
            if not want_dist:
                cs.walk_activity("training shape", args)
            ref = bwd.rasterize_backward_plain(*args, want_dist=want_dist,
                                               max_elems=cs.PLAIN_BWD_ELEMS)
            bound, by = cs.bwd_bound(stats, w, h, b.tile_count.numel(), want_dist)
            print(f"  [{mode}] bound {bound:.4f} ms ({by})")
            cs.worklist_vs_plain("training shape", args, want_dist)
            print(f"  [{mode}] whole call {cs.b2_ms(args, want_dist, reps=a.reps):.4f} ms",
                  flush=True)
            # In turns: parent and variants beside the default, both ways round.
            timed = {"default": lambda: whole_call(args, want_dist)}
            if parent is not None:
                grade(f"[{mode}] parent B2", parent_call(parent, rows, args, want_dist), ref)
                timed["parent"] = lambda: parent_call(parent, rows, args, want_dist)
            for name, lib in variants.items():
                cuda_build._loaded["rasterize_bwd"] = lib
                grade(f"[{mode}] variant {name}", whole_call(args, want_dist), ref)
                def run_variant(lib=lib):
                    cuda_build._loaded["rasterize_bwd"] = lib
                    return whole_call(args, want_dist)
                timed[name] = run_variant
            cuda_build._loaded["rasterize_bwd"] = default
            if len(timed) > 1:
                names = list(timed) + list(timed)[::-1]
                got = {n: [] for n in timed}
                for n in names:
                    got[n].append(cs.cuda_ms(timed[n], reps=a.reps))
                    cuda_build._loaded["rasterize_bwd"] = default
                print(f"  [{mode}] in turns ({' '.join(names)}), ms: " + "; ".join(
                    f"{n} " + " / ".join(f"{t:.4f}" for t in v) for n, v in got.items()),
                    flush=True)
    if cs.failures:
        print("time_b2: failed:", *cs.failures, sep="\n  ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
