"""Train/test view-split files (counterpart of `g4splat_tpu.io.splits`).

The reference datasets carry a `split-{N}views.json` per scene
(`{"train": [...], "test": [...]}`) read by `train.py --use_view_config`
(the training views) and `eval/eval.py:67-80` (held-out image metrics),
with an older `train_test_split_{N}.json` (`train_ids` / `test_ids`) as the
fallback.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple


def load_view_split(source_path: str, n_views: int) -> Optional[Tuple[List[int], List[int]]]:
    """(train_ids, test_ids) from the scene's split file, sorted, or None if
    the scene has none (reference eval.py:67-80)."""
    for name, train, test in ((f"split-{n_views}views.json", "train", "test"),
                              (f"train_test_split_{n_views}.json", "train_ids", "test_ids")):
        path = os.path.join(source_path, name)
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            return sorted(d[train]), sorted(d[test])
    return None
