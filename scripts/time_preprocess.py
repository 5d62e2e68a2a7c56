"""Time the preprocess kernels (g4splat_torch/csrc/preprocess.cu) at the
training shape, beside their plain forms and the torch chain they replace.

The shape is train_room's: 2.4M slots, 1.2M of them live (chip_smoke's room
shell, seed 11), SH degree 3, a centre offset, 512x384 from
(0, -0.8, -6.5). Timed by CUDA events over --reps calls after two warm-up
calls, each in turns (kernel, plain, chain, then reversed), forward and
backward apart:

  forward:  preprocess_cuda.forward_cuda; forward_plain; the torch chain
            rasterize_common.preprocess (with the SH `cat` render() ran);
  backward: preprocess_cuda.backward_cuda; backward_plain; autograd of the
            torch chain's outputs, with the same cotangents as B2 hands
            them (column slices of one (P, 18) table).

It prints the card, its power limit and the bytes bound: the forward reads
240 B and writes 77 B a slot, the backward reads 297 B and writes 236 B
(preprocess_cuda.FWD_BYTES_PER_SLOT, BWD_BYTES_PER_SLOT), over the card's
3.35 TB/s.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_preprocess.py [--reps 20]
"""

import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from g4splat_torch.core.cameras import lookat_camera  # noqa: E402
from g4splat_torch.models.gaussians import GaussianScene  # noqa: E402
from g4splat_torch.ops import preprocess_cuda as pc  # noqa: E402
from g4splat_torch.ops.rasterize_common import preprocess  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def timed_ms(fn, reps):
    """Mean ms of fn() over `reps` calls between CUDA events, after 2 calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda")
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {limit.strip()}")

    xyz, cols, scales, quats = cs.scene_arrays(1_200_000, 11)
    scene = GaussianScene.from_points(xyz, cols, scales=scales, quats=quats,
                                      capacity=2_400_000, initial_opacity=0.5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    scene = scene.replace(f_rest=0.05 * torch.randn(scene.f_rest.shape, generator=gen,
                                                    device=dev), active_sh_degree=3)
    cam = lookat_camera([0, -0.8, -6.5], [0, 0, 0], [0, -1, 0], fx=400.0, fy=400.0,
                        width=512, height=384, device=dev)
    P = scene.capacity
    off = torch.zeros((P, 2), device=dev)
    w2c, M = cam.w2c, cam.world2pix
    fwd_args = (scene.xyz, scene.scaling(), scene.rotation_raw, scene.f_dc, scene.f_rest, None,
                off, scene.opacity().reshape(-1), w2c, M, 3, 1.0, cam.width, cam.height)
    valid = pc.forward_cuda(*fwd_args)[-1]
    print(f"slots {P}, live {int(scene.num_alive)}, valid {int(valid.sum())}")
    table = torch.randn((P, 18), generator=gen, device=dev)
    cots = (table[:, 0:9].reshape(P, 3, 3), table[:, 9:11], table[:, 12:15], table[:, 15:18])
    bwd_args = (scene.xyz, scene.scaling(), scene.rotation_raw, scene.f_dc, scene.f_rest, None,
                w2c, M, valid) + cots + (True, 3, 1.0)

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (scene.xyz, scene.scaling(), scene.rotation_raw, scene.f_dc,
                        scene.f_rest, off)]
    opacity = scene.opacity()

    def chain_fwd():
        return preprocess(cam, leaves[0], leaves[1], leaves[2], opacity,
                          torch.cat([leaves[3], leaves[4]], 1), 3, center_offset=leaves[5])

    def chain_bwd():
        ch = chain_fwd()
        torch.autograd.backward((ch.T, ch.center, ch.rgb, ch.normal), cots)

    fwd = {"kernel": lambda: pc.forward_cuda(*fwd_args),
           "plain": lambda: pc.forward_plain(*fwd_args),
           "chain": lambda: chain_fwd()}
    bwd = {"kernel": lambda: pc.backward_cuda(*bwd_args),
           "plain": lambda: pc.backward_plain(*bwd_args)}
    ms = {("fwd", k): [] for k in fwd}
    ms.update({("bwd", k): [] for k in bwd})
    ms[("fwd+bwd", "chain")] = []
    order = ["kernel", "plain", "chain"]
    for turn in (order, order[::-1]):
        for k in turn:
            ms[("fwd", k)].append(timed_ms(fwd[k], args.reps))
            if k in bwd:
                ms[("bwd", k)].append(timed_ms(bwd[k], args.reps))
            else:
                ms[("fwd+bwd", "chain")].append(timed_ms(chain_bwd, args.reps))
    bound_f = pc.FWD_BYTES_PER_SLOT * P / HBM_BYTES_PER_S * 1e3
    bound_b = pc.BWD_BYTES_PER_SLOT * P / HBM_BYTES_PER_S * 1e3
    print(f"bound (bytes): forward {pc.FWD_BYTES_PER_SLOT} B a slot, {bound_f:.4f} ms; "
          f"backward {pc.BWD_BYTES_PER_SLOT} B a slot, {bound_b:.4f} ms")
    for (d, k), v in ms.items():
        line = f"{d:8s} {k:7s} ms (turns) " + " / ".join(f"{x:.4f}" for x in v)
        if k == "kernel":
            b = bound_f if d == "fwd" else bound_b
            line += f"; {100.0 * b / min(v):.1f} % of the bytes roofline"
        print(line)
    print(f"launches: forward {pc.PREPROCESS_FWD.launches}, backward "
          f"{pc.PREPROCESS_BWD.launches}")


if __name__ == "__main__":
    main()
