"""`g4splat_torch.pipeline.matches_export` against
`g4splat_tpu.pipeline.matches_export` on the CPU.

A reduced MASt3R (TINY_CONFIG, the port's seeded weights plus 0.02 noise,
carried to the JAX package through its own `convert_torch_mast3r`) on three
seeded 32×32 images: both packages export the same pairs (given, and all
pairs by default). The npz files hold the same keys and dtype kinds, the
same pair ids, offsets and match coordinates exactly, and confidences within
1e-5 relative (two frameworks' float32 networks); `load_matches` gives the
JAX package's list of dicts. An empty pair list writes the JAX package's
empty arrays.
"""

import numpy as np
import pytest
import torch

from g4splat_torch.pipeline import matches_export as TX
from g4splat_tpu.pipeline import matches_export as JX
from test_torch_pipeline_run import mast3r_pair

RES = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's fixtures and tests: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models_and_images():
    tm, jm = mast3r_pair()
    images = np.random.RandomState(4).rand(3, RES, RES, 3).astype(np.float32)
    return tm, jm, images


@pytest.mark.parametrize("pairs", [[(0, 1), (2, 0), (1, 2)], None])
def test_export_matches_jax(models_and_images, tmp_path, pairs):
    tm, jm, images = models_and_images
    tpath, jpath = str(tmp_path / "port" / "m.npz"), str(tmp_path / "jax" / "m.npz")
    got = TX.compute_and_export_matches(tm, images, pairs, out_path=tpath, subsample=4)
    want = JX.compute_and_export_matches(jm, images, pairs, out_path=jpath, subsample=4)
    t, j = np.load(tpath), np.load(jpath)
    assert sorted(t.files) == sorted(j.files) == sorted(got) == sorted(want)
    for k in ("pair_i", "pair_j", "offsets", "xy1", "xy2"):
        assert t[k].dtype.kind == j[k].dtype.kind, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert len(t["conf"]) > 0
    np.testing.assert_allclose(t["conf"], j["conf"], rtol=1e-5)
    tl, jl = TX.load_matches(tpath), JX.load_matches(jpath)
    assert len(tl) == len(jl) == 3
    for a, b in zip(tl, jl):
        assert (a["i"], a["j"]) == (b["i"], b["j"])
        np.testing.assert_array_equal(a["xy1"], b["xy1"])
        np.testing.assert_array_equal(a["xy2"], b["xy2"])
        np.testing.assert_allclose(a["conf"], b["conf"], rtol=1e-5)


def test_empty_pairs_match_jax(models_and_images, tmp_path):
    tm, jm, images = models_and_images
    got = TX.compute_and_export_matches(tm, images, [], out_path="")
    want = JX.compute_and_export_matches(jm, images, [], out_path="")
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
