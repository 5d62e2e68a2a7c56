"""Tiny cells for the CPU tests: a copy of the benchmark's layout in a
temporary directory whose configurations are cut to a size the CPU runs in
seconds, with the drivers and metric readers copied as they are."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TRAIN_SCENE = {"live": 400, "capacity": 1000, "width": 64, "height": 48, "views": 5}
SEE3D_MODELS = {
    "unet": {"model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
             "attention_resolutions": [1, 2], "num_head_channels": 16, "context_dim": 16,
             "camera_dim": None},
    "vae": {"base_ch": 32, "ch_mult": [1, 2], "z_ch": 4},
    "clip_vision": {"embed_dim": 32, "depth": 1, "num_heads": 2, "projection_dim": 16},
    "clip_text": {"width": 16, "depth": 1, "num_heads": 2},
    "ddim": {"num_steps": 4},
}
SEE3D_TRAFFIC = {"resolution": 32, "warmup_steps": 1, "checked_steps": 1}


def layout(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and perfbench/ with the tiny cells
    `train_tiny` and `see3d_tiny` beside the real ones."""
    root = tmp / "root"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    for cell, cfg_name, patch in (("train_room", "room_2dgs", {"scene": TRAIN_SCENE}),
                                  ("see3d_inpaint", "see3d_mvdream_sd21",
                                   {"models": SEE3D_MODELS})):
        cfg = json.loads((REPO / conf[cfg_name]["file"]).read_text())
        for group, values in patch.items():
            for k, v in values.items():
                if isinstance(v, dict):
                    cfg[group][k].update(v)
                else:
                    cfg[group][k] = v
        tiny = cell.split("_")[0] + "_tiny"
        path = f"perfbench/configs/{tiny}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append(dict(conf[cfg_name], name=tiny, file=path))
        w = cells[cell]
        mix = REPO / "perfbench" / "workloads" / f"{w['traffic']}.json"
        traffic = json.loads(mix.read_text())
        if cell == "see3d_inpaint":
            traffic.update(SEE3D_TRAFFIC)
        (root / "perfbench" / "workloads" / f"{tiny}.json").write_text(json.dumps(traffic))
        bench["workloads"].append(dict(w, name=tiny, config=tiny, traffic=tiny))
        for group in ("end_to_end", "per_layer"):
            for m in bench[group]:
                if cell in m.get("workloads", []):
                    m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def config(name: str) -> dict:
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((REPO / "perfbench" / "workloads" / f"{name}.json").read_text())
