"""The box room's inputs that `g4splat_torch.eval.synthetic.quality_run`
renders, against the JAX package's, on the CPU.

The port's `cuda` backend (its plain version on the CPU) against the JAX
package's `dense` oracle on box_room(300) and 4 `room_cameras` at 32×24:
colour and surface depth within 1e-3 at every pixel (two float32
compositing orders over thousands of entries a tile; a few pixels reach
2.4e-4). Not against the JAX `tiled` default: it keeps the front 1024
entries of a tile (`tile_k`), and at 32×24 every tile of the room holds
thousands (ROADMAP C25). The quality_run itself: tests/test_torch_quality.py.
"""

import jax
import numpy as np
import pytest
import torch

from g4splat_torch.core.cameras import camera_at
from g4splat_torch.eval import synthetic as TS
from g4splat_torch.ops.rasterize import render
from g4splat_tpu.eval import synthetic as JS
from g4splat_tpu.ops.rasterize import render as jrender


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's tests: the suite runs several
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_box_room_inputs_match_jax():
    W, H = 32, 24
    scene, _ = TS.box_room(points_per_m2=300, device="cpu")
    jscene, _ = JS.box_room(points_per_m2=300)
    cams = TS.room_cameras(4, W, H, device="cpu")
    jcams = JS.room_cameras(4, W, H)
    for i in range(4):
        with torch.no_grad():
            t = render(camera_at(cams, i), scene, backend="cuda")
        j = jrender(jax.tree.map(lambda x: x[i], jcams), jscene, backend="dense")
        for k in ("render", "surf_depth"):
            d = np.abs(t[k].numpy() - np.asarray(j[k]))
            assert d.max() <= 1e-3, (i, k, d.max())
