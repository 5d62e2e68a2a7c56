"""Tiny versions of the MASt3R pair cell and of the viewer cell for the CPU
tests, added to `tiny.layout`'s copy of the benchmark: `mast3r_tiny`
(MASt3R at the program's TINY_CONFIG widths, 4 views at 96×64) and
`render_tiny` (the viewer's traffic on `train_tiny`'s room). The viewer
cell is not in `BENCHMARK.json` (PERF.md §7), so its metric entries, as a
later change would add them, are given here."""

from __future__ import annotations

import json
from pathlib import Path

from perfbench.tests import tiny

MAST3R_MODEL = {"patch_size": 16, "enc_embed_dim": 64, "enc_depth": 2, "enc_num_heads": 2,
                "dec_embed_dim": 48, "dec_depth": 2, "dec_num_heads": 2, "local_feat_dim": 8,
                "rope_base": 100.0, "dpt_features": 32, "dpt_layer_dims": [8, 16, 24, 32],
                "two_confs": True}
MAST3R_TRAFFIC = {"views": 4, "width": 96, "height": 64, "pool_sets": 2, "checked_pairs": 2}
RENDER_TRAFFIC = {"poses": 4, "warmup_cycles": 1, "checked_frames": 2, "traced_frames": 4,
                  "labelled_frames": 1}
RENDER_END_TO_END = [("render_frames_per_s", "frames/s", "higher"),
                     ("render_p95_ms", "ms", "lower")]
RENDER_PER_LAYER = [("preprocess_ms.render", "ms", "lower"),
                    ("binning_span_ms.render", "ms", "lower"),
                    ("b1_roofline.render", "%", "higher"), ("copy_ms.render", "ms", "lower"),
                    ("host_syncs.render", "syncs/frame", "lower"),
                    ("mfu_pct.render", "%", "higher"), ("idle_pct.render", "%", "lower")]


def layout(tmp: Path) -> Path:
    """`tiny.layout`'s root with `mast3r_tiny` and `render_tiny` added."""
    root = tiny.layout(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    mixes = root / "perfbench" / "workloads"

    cfg = json.loads((root / conf["mast3r_vitl_base_512"]["file"]).read_text())
    cfg["model"] = MAST3R_MODEL
    path = "perfbench/configs/mast3r_tiny.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append(dict(conf["mast3r_vitl_base_512"], name="mast3r_tiny", file=path))
    traffic = json.loads((mixes / "sfm_pairs_10view.json").read_text())
    (mixes / "mast3r_tiny.json").write_text(json.dumps(dict(traffic, **MAST3R_TRAFFIC)))
    bench["workloads"].append(dict(cells["mast3r_pairs"], name="mast3r_tiny",
                                   config="mast3r_tiny", traffic="mast3r_tiny"))
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "mast3r_pairs" in m.get("workloads", []):
                m["workloads"].append("mast3r_tiny")

    traffic = json.loads((mixes / "viewer_frames.json").read_text())
    (mixes / "render_tiny.json").write_text(json.dumps(dict(traffic, **RENDER_TRAFFIC)))
    bench["workloads"].append({"name": "render_tiny", "config": "train_tiny",
                               "traffic": "render_tiny", "chips": 1, "why": "tiny viewer"})
    bench["end_to_end"] += [{"name": n, "unit": u, "better": b, "bound": 0.25,
                             "source": "host_clock", "workloads": ["render_tiny"]}
                            for n, u, b in RENDER_END_TO_END]
    bench["per_layer"] += [{"name": n, "unit": u, "better": b, "source": "device_trace",
                            "layer": "render path", "moves": "render_frames_per_s",
                            "workloads": ["render_tiny"]} for n, u, b in RENDER_PER_LAYER]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
