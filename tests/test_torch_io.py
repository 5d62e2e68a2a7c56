"""The port's file zoo against the JAX package's on the CPU: float32 depth
TIFFs (the port's own encoder, read back exactly, read by PIL as mode "F",
and PIL-written TIFFs such as the JAX package's read by the port), mask PNGs,
NPY writes on the I/O pool, point-cloud PLYs, and the flat YAML reader held
to `yaml.safe_load` on the repository's configs.
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import g4splat_tpu.io.images as JI
import g4splat_tpu.io.ply as JPLY
import g4splat_torch.io.images as TI
import g4splat_torch.io.ply as TPLY
from g4splat_torch.utils.config import CONFIG_ROOT, load_config, parse_flat_yaml


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (384, 512)])
def test_depth_tiff_round_trip(tmp_path, shape):
    d = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 3
    d.flat[0] = np.inf
    p = str(tmp_path / "d.tiff")
    TI.save_depth_tiff(p, torch.from_numpy(d))
    np.testing.assert_array_equal(TI.load_depth_tiff(p), d)
    im = Image.open(p)
    assert im.mode == "F" and im.size == shape[::-1]
    np.testing.assert_array_equal(np.asarray(im, np.float32), d)
    np.testing.assert_array_equal(JI.load_depth_tiff(p), d)


def test_reads_pil_tiffs(tmp_path):
    d = np.random.default_rng(1).uniform(0, 5, (300, 200)).astype(np.float32)
    p = str(tmp_path / "j.tiff")
    JI.save_depth_tiff(p, d)
    np.testing.assert_array_equal(TI.load_depth_tiff(p), d)
    Image.fromarray(d.astype(np.uint8)).save(str(tmp_path / "u8.tiff"))
    with pytest.raises(ValueError):
        TI.load_depth_tiff(str(tmp_path / "u8.tiff"))


def test_async_zoo_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    depth = rng.uniform(size=(24, 32)).astype(np.float32)
    mask = rng.uniform(size=(24, 32)) > 0.5
    arr = rng.normal(size=(24, 32, 3)).astype(np.float32)
    TI.save_depth_tiff_async(str(tmp_path / "t.tiff"), torch.from_numpy(depth))
    TI.save_mask_png_async(str(tmp_path / "t.png"), torch.from_numpy(mask))
    TI.save_npy_async(str(tmp_path / "t.npy"), torch.from_numpy(arr))
    TI.flush_io()
    JI.save_mask_png(str(tmp_path / "j.png"), mask)
    np.testing.assert_array_equal(TI.load_depth_tiff(str(tmp_path / "t.tiff")), depth)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    np.testing.assert_array_equal(JI.load_mask_png(str(tmp_path / "t.png")), mask)
    np.testing.assert_array_equal(TI.load_mask_png(str(tmp_path / "t.png")), mask)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), arr)


@pytest.mark.parametrize("with_colors, with_normals", [(False, False), (True, True)])
def test_point_cloud_ply(tmp_path, with_colors, with_normals):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3)) if with_colors else None
    nrm = rng.normal(size=(50, 3)) if with_normals else None
    TPLY.save_point_cloud_ply(str(tmp_path / "t.ply"), torch.from_numpy(pts), cols, nrm)
    JPLY.save_point_cloud_ply(str(tmp_path / "j.ply"), pts, cols, nrm)
    a, b = TPLY.read_ply(str(tmp_path / "t.ply")), JPLY.read_ply(str(tmp_path / "j.ply"))
    assert a["vertex"].dtype == b["vertex"].dtype
    np.testing.assert_array_equal(a["vertex"], b["vertex"])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIG_ROOT, "*", "*.yaml"))))
def test_flat_yaml_configs(path):
    """Every config reads as yaml.safe_load reads it (flat keys, scalars and
    one-line lists of scalars); a nested or mapping value is refused, not
    misread."""
    text = open(path).read()
    want = yaml.safe_load(text) or {}
    assert parse_flat_yaml(text) == want
    for bad in ("a: {b: 1}", "a:\n  - 1", "a: [[1, 2]]", "a: |\n  text"):
        with pytest.raises(ValueError):
            parse_flat_yaml(text + "\n" + bad)


def test_default_schedule():
    assert load_config("free_gaussians_refinement") == yaml.safe_load(
        open(os.path.join(CONFIG_ROOT, "free_gaussians_refinement", "default.yaml")))
    with pytest.raises(FileNotFoundError):
        load_config("free_gaussians_refinement", "missing")
