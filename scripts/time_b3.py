"""Time kernel B3 (g4splat_torch/csrc/attention_fwd.cu) at the See3D main
path's attention shapes beside F.scaled_dot_product_attention (the
yardstick; the port never calls it), and hold it against chunked_attention
(1e-4 * max|plain|). Also prints how far B3 and the plain version lie from a
float64 reference on the first 256 queries (relative to its largest value),
and first the build's compiler report and tensor-core instruction counts.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/time_b3.py [--reps 3]
"""

import argparse
import os
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from g4splat_torch.ops import attention_cuda, cuda_build  # noqa: E402
from g4splat_torch.ops.attention import chunked_attention  # noqa: E402

# (q shape, keys): self-attention at ds = 1, 2, 4 and the largest
# cross-attention of the See3D UNet at 512 px.
SHAPES = (((2, 36864, 5, 64), 36864), ((2, 9216, 10, 64), 9216),
          ((2, 2304, 20, 64), 2304), ((18, 4096, 5, 64), 77))
TOL = 1e-4
N64 = 256


def rel64(out, q, k, v):
    """max|out - ref64| / max|ref64| on the first N64 queries."""
    qh = q[:, :N64].double()
    s = torch.einsum("bnhd,bmhd->bhnm", qh, k.double()) / q.shape[-1] ** 0.5
    ref = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.double())
    return float((out[:, :N64] - ref).abs().max() / ref.abs().max())


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_b3: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    log = cuda_build.build_all(("attention_fwd",))["attention_fwd"]
    print("\n".join(f"  {line.strip()}" for line in log.splitlines() if line.strip()))
    for fn, c in cuda_build.sass_mma_counts("attention_fwd").items():
        print(f"  SASS {fn}: HMMA {c['HMMA']}, HGMMA {c['HGMMA']}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = 0
    for qs, m in SHAPES:
        ks = (qs[0], m) + qs[2:]
        q = torch.randn(qs, device="cuda", generator=gen)
        k = torch.randn(ks, device="cuda", generator=gen)
        v = torch.randn(ks, device="cuda", generator=gen)
        ref = chunked_attention(q, k, v)
        top = float(ref.abs().max())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), args.reps)
        line = [f"{qs} x {m}: plain vs float64 {rel64(ref, q, k, v):.2e}; SDPA {l_ms:.4f} ms"]
        got = attention_cuda.attention_fwd(q, k, v)
        err = float((got - ref).abs().max())
        ok = err <= TOL * top
        failed += not ok
        ms = cuda_ms(lambda: attention_cuda.attention_fwd(q, k, v), args.reps)
        line.append(f"B3 {ms:.4f} ms, max|d| / max|plain| {err / top:.2e} "
                    f"{'ok' if ok else 'FAIL'}, vs float64 {rel64(got, q, k, v):.2e}")
        print("; ".join(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
