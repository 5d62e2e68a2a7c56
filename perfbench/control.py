"""Readings of the check's numbers for the control and the planted faults,
at a cell's own size, one JSON line per seed:

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 [--fault tf32]

The control is the plain reference put in the program's place and computed
in TF32, the next precision below the configuration's float32; a training
cell also reads `--fault half_batch` (its losses over half of each image).
The limits of `workloads/<traffic>.json` lie between these readings and the
largest the program's runs give. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="tf32")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    control = cell.driver().control
    for seed in args.seeds:
        t = time.perf_counter()
        nums = control(cell.config, cell.traffic, seed, device, args.fault)
        print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "numbers": {n: v for n, v in nums}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
