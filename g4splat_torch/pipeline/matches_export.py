"""Pairwise match export (counterpart of `g4splat_tpu.pipeline.matches_export`).

The reference's matcher tools (mast3r/compute_matches.py, run_matching.py,
make_pairs.py; SURVEY §2.4): MASt3R on image pairs, the reciprocal nearest
neighbours of its local descriptors on a strided grid, written to one npz in
the schema the chart-alignment reprojection loss reads
(matcha/pointmap/mast3r.py:26-129): per-pair pixel coordinates `xy1`,
`xy2`, confidences `conf`, the image ids `pair_i`, `pair_j` and the pairs'
row `offsets`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from g4splat_torch.pipeline.sfm import build_pairs_exhaustive
from g4splat_torch.priors.mast3r import extract_correspondences


def compute_and_export_matches(
    model,                       # MASt3RModel
    images,                      # (V, H, W, 3) tensor or array in [0, 1]
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    out_path: str = "matches.npz",
    subsample: int = 8,
    max_batch: int = 8,
) -> dict:
    """Match every pair (all pairs by default) and write the npz to
    `out_path` (no file when it is empty); returns the npz's arrays. Both
    orderings of `max_batch // 2` pairs ride one `symmetric_inference_batch`
    call, on the model's device; the matching runs there too, and the
    arrays come back to the host."""
    images = torch.as_tensor(images)
    pairs = list(pairs) if pairs is not None else build_pairs_exhaustive(len(images))
    per_call = max(1, max_batch // 2)
    xs1, xs2, confs, offsets = [], [], [], [0]
    for s in range(0, len(pairs), per_call):
        chunk = pairs[s:s + per_call]
        outs = model.symmetric_inference_batch(images[[i for i, _ in chunk]],
                                               images[[j for _, j in chunk]],
                                               max_batch=max_batch)
        for out11, _, out22, _ in outs:
            xy1, xy2, conf = extract_correspondences(
                out11["desc"][0], out22["desc"][0], out11["desc_conf"][0],
                out22["desc_conf"][0], subsample=subsample)
            xs1.append(xy1)
            xs2.append(xy2)
            confs.append(conf)
            offsets.append(offsets[-1] + len(conf))

    data = {
        "xy1": np.concatenate(xs1) if xs1 else np.zeros((0, 2)),
        "xy2": np.concatenate(xs2) if xs2 else np.zeros((0, 2)),
        "conf": np.concatenate(confs) if confs else np.zeros(0),
        "pair_i": np.asarray([i for i, _ in pairs], np.int32),
        "pair_j": np.asarray([j for _, j in pairs], np.int32),
        "offsets": np.asarray(offsets, np.int32),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.savez(out_path, **data)
    return data


def load_matches(path: str) -> List[dict]:
    """The npz → one dict per pair: "i", "j", "xy1", "xy2", "conf"."""
    d = np.load(path)
    out = []
    for k in range(len(d["pair_i"])):
        s, e = d["offsets"][k], d["offsets"][k + 1]
        out.append({
            "i": int(d["pair_i"][k]),
            "j": int(d["pair_j"][k]),
            "xy1": d["xy1"][s:e],
            "xy2": d["xy2"][s:e],
            "conf": d["conf"][s:e],
        })
    return out
