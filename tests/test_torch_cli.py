"""`g4splat_torch.cli` against `g4splat_tpu.cli` on the CPU.

- Every flag of the JAX parser exists in the port's with the same default,
  type, choices and arity, except `--render_backend`, whose default is
  `cuda` (choices cuda, tiled, dense) where the JAX package's is `pallas`.
- `load_scene_images` gives the JAX package's file list and images within
  1e-5 (both resize with jax.image.resize's antialiased bilinear weights)
  for every selection mode; `load_image` equals the JAX one exactly on PNG
  and JPEG files; `load_view_split` reads both file formats as the JAX one.
- `build_priors` on tests/test_cli.py's tiny zoo (eval_shape zeros, no
  compile), with a CLIPText entry added, builds every prior through the
  port's converters with strict loads; SAM's weights are the zoo's.
- `main(argv, device="cpu")` runs end to end on test_torch_pipeline_run.py's
  scene (3 photos as 8-bit PNGs, its `sparse/0`, a split file holding view
  2 out) with its YAML overlays, a TINY_SAM `sam.npz` (the port's seeded
  weights through `convert_torch_sam`) as the only zoo entry, the real
  trainer at `--iterations 2`, `--render_backend tiled` and `--work_size
  16` (the COLMAP cameras scaled to the images, ROADMAP C23). The sizes the
  CLI has no flag for (capacity, grids, the See3D resolution) are cut by a
  `functools.partial` of `PipelineConfig`. It leaves the JAX package's file
  names (the snapshots, renders, plane masks, mesh) and result keys.
- `scale_to_images` (the port's repair of C23, which the JAX CLI lacks): for
  photos that `load_scene_images` resizes by one factor (512×384 → 256×192)
  and by two (500×380 → 512×384), world points projected by the scaled
  camera land at (u + 0.5)·s − 0.5 of their pixel under the photo's camera,
  per axis, within 1e-3 px (float32 projection of coordinates up to 512; a
  principal point scaled as c·s moves them 0.012-0.25 px, swapped factors
  several px).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import g4splat_torch.cli as TC
import g4splat_torch.pipeline.orchestrator as TO
import g4splat_tpu.cli as JC
from g4splat_torch.io.images import read_png, save_image
from g4splat_torch.io.splits import load_view_split
from g4splat_torch.priors import sam as TS
from g4splat_tpu.io import images as JI
from g4splat_tpu.io.splits import load_view_split as jax_load_view_split
from test_cli import _materialize, _save, zoo  # noqa: F401  (zoo: a fixture)
from test_torch_pipeline_run import RES, scene_and_cameras, source_tree
from test_torch_pipeline_run import patched  # noqa: F401  (the YAML overlays, a fixture)

# JAX's evaluate() for a held-out split, no GT images or mesh passed (as its CLI runs it).
RESULT_KEYS = ["LPIPS-uncalibrated", "test_views_num", "Average-PSNR", "Average-SSIM",
               "Average-LPIPS"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_FLAGS = sorted(_actions(JC.build_parser()))


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_flag_matches_jax(dest):
    j, t = _actions(JC.build_parser())[dest], _actions(TC.build_parser())[dest]
    assert t.option_strings == j.option_strings
    assert (t.type, t.nargs, t.required, type(t)) == (j.type, j.nargs, j.required, type(j))
    if dest == "render_backend":
        assert (j.default, t.default) == ("pallas", "cuda")
        assert t.choices == ["cuda", "tiled", "dense"]
    else:
        assert t.default == j.default and t.choices == j.choices


def test_no_flag_beyond_jax():
    assert set(_actions(TC.build_parser())) == set(JAX_FLAGS)


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """Five photos of odd sizes: four 8-bit PNGs (the port's writer), one
    JPEG (Pillow's)."""
    src = tmp_path_factory.mktemp("photos")
    os.makedirs(src / "images")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(50, 70), (50, 70), (61, 85), (50, 70)]):
        save_image(str(src / "images" / f"frame_{i:02d}.png"),
                   rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(
        src / "images" / "frame_04.jpg")
    return str(src)


@pytest.mark.parametrize("mode", [dict(), dict(n_images=3), dict(image_idx=[4, 1]),
                                  dict(n_images=2, randomize=True)],
                         ids=["all", "first-n", "idx", "random"])
def test_load_scene_images_matches_jax(photos, mode):
    sizes = [48, 40] if mode == {} else [48]
    for work in sizes:
        ti, tf = TC.load_scene_images(photos, work_size=work, **mode)
        ji, jf = JC.load_scene_images(photos, work_size=work, **mode)
        assert tf == jf
        assert ti.shape == ji.shape and ti.dtype == np.float32
        np.testing.assert_allclose(ti, ji, atol=1e-5)


def test_load_image_matches_jax(photos):
    from g4splat_torch.io.images import load_image

    files = sorted(os.listdir(os.path.join(photos, "images")))
    grey = os.path.join(photos, "grey.png")
    save_image(grey, np.arange(12, dtype=np.uint8).reshape(3, 4) * 20)
    for f in [os.path.join(photos, "images", f) for f in files] + [grey]:
        got, want = load_image(f), JI.load_image(f)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["split", "train_test", "none"])
def test_load_view_split_matches_jax(tmp_path, fmt):
    if fmt == "split":
        (tmp_path / "split-4views.json").write_text(json.dumps({"train": [3, 0, 2, 5],
                                                                "test": [4, 1]}))
    elif fmt == "train_test":
        (tmp_path / "train_test_split_4.json").write_text(json.dumps(
            {"train_ids": [5, 0, 1, 2], "test_ids": [3]}))
    got = load_view_split(str(tmp_path), 4)
    assert got == jax_load_view_split(str(tmp_path), 4)
    assert (got is None) == (fmt == "none")


@pytest.fixture(scope="module")
def text_zoo(zoo):
    """tests/test_cli.py's zoo and a tiny CLIPText."""
    from g4splat_tpu.priors.clip_text import CLIPText

    cfg = dict(vocab_size=49408, width=32, depth=1, num_heads=2, n_ctx=77, max_positions=80)
    net = CLIPText(**cfg)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    _save(zoo, "clip_text", _materialize(shapes), dict(cfg, pad_id=5))
    return zoo


def test_build_priors_every_prior(text_zoo):
    from g4splat_torch.eval.image_metrics import LPIPS
    from g4splat_torch.priors.clip_text import CLIPTextEmbedder
    from g4splat_torch.priors.clip_vision import CLIPImageEmbedder
    from g4splat_torch.priors.depth_anything import DepthAnything
    from g4splat_torch.priors.mast3r import MASt3RModel
    from g4splat_torch.priors.see3d import See3DPipeline
    from g4splat_torch.priors.vae import AutoencoderKL

    args = TC.build_parser().parse_args(["-s", "x", "--checkpoint_dir", text_zoo])
    p = TC.build_priors(args, device="cpu")
    assert isinstance(p.depth_model, DepthAnything) and p.depth_model.encoder == "vits"
    assert isinstance(p.mast3r, MASt3RModel) and p.mast3r.cfg.enc_depth == 2
    assert isinstance(p.see3d, See3DPipeline) and isinstance(p.see3d_sr, See3DPipeline)
    assert p.see3d.unet.cfg.model_channels == 32
    assert isinstance(p.vae, AutoencoderKL)
    assert isinstance(p.image_embedder, CLIPImageEmbedder)
    assert isinstance(p.text_embedder, CLIPTextEmbedder) and p.text_embedder.pad_id == 5
    assert p.text_embedder().shape == (1, 77, 32)
    assert isinstance(p.lpips, LPIPS) and p.lpips.calibrated
    assert callable(p.sam_generator) and hasattr(p.sam_generator, "batch")
    for m in (p.depth_model.model, p.mast3r.model, p.see3d.unet, p.vae,
              p.image_embedder.model, p.text_embedder.model):
        assert all(t.device.type == "cpu" and not t.any() for t in m.state_dict().values()
                   if t.dtype.is_floating_point and t.numel())
    empty = TC.build_parser().parse_args(["-s", "x", "--checkpoint_dir", str(text_zoo) + "-none"])
    assert TC.build_priors(empty, device="cpu").sam_generator is None


def sam_zoo(dst, cfg=TS.TINY_SAM, seed=0):
    """`sam.npz` as scripts/convert_checkpoints.py writes it, from the port's
    seeded SAM through the port's `convert_torch_sam`."""
    pred = TS.SAMPredictor(cfg, seed=seed, device="cpu")
    sd = {k: v.numpy() for k, v in pred.model.state_dict().items()}
    _save(dst, "sam", TS.convert_torch_sam(sd, cfg), dataclasses.asdict(cfg))
    return pred


def test_main_end_to_end(patched, tmp_path, monkeypatch):
    images, jc, _ = scene_and_cameras()
    src = source_tree(str(tmp_path), jc)
    os.makedirs(os.path.join(src, "images"))
    for v, img in enumerate(images):
        save_image(os.path.join(src, "images", f"frame_{v:06d}.png"), img)
    with open(os.path.join(src, "split-2views.json"), "w") as f:
        json.dump({"train": [1, 0], "test": [2]}, f)
    zoo_dir = str(tmp_path / "zoo")
    os.makedirs(zoo_dir)
    writer = sam_zoo(zoo_dir)
    out = str(tmp_path / "out")
    argv = ["-s", src, "-o", out, "--sfm_config", "posed", "--use_view_config",
            "--config_view_num", "2", "--checkpoint_dir", zoo_dir, "--iterations", "2",
            "--render_backend", "tiled", "--work_size", str(RES // 2), "--alignment_config", "fast",
            "--use_multires_tsdf", "--select_inpaint_num", "2"]
    monkeypatch.setattr(TO, "PipelineConfig", functools.partial(
        TO.PipelineConfig, gaussian_capacity=4000, vis_grid_resolution=0, tsdf_resolution=24,
        none_visible_high=0.95, mvd_resolution=None))
    built = []
    build = TC.build_priors
    monkeypatch.setattr(TC, "build_priors", lambda *a, **kw: built.append(build(*a, **kw))
                        or built[-1])
    assert TC.main(argv, device="cpu") == 0
    sam = built[0].sam_generator
    assert sam is not None and built[0].mast3r is None and built[0].see3d is None
    got = json.load(open(os.path.join(out, "result_iter_2.json")))
    assert list(got) == RESULT_KEYS and got["test_views_num"] == 1
    with open(os.path.join(out, "result_iter_2.txt")) as f:
        txt = [line.split(":")[0] for line in f.read().splitlines()]
    assert txt == RESULT_KEYS
    g = os.path.join(out, "free_gaussians")
    assert sorted(os.listdir(g)) == ["point_cloud", "point_cloud-ori", "point_cloud-s1",
                                     "point_cloud-s2", "test"]
    # The photos are 32², the work size 16: the COLMAP cameras are scaled to
    # the images (C23), so the held-out renders match the held-out images.
    render0 = os.path.join(g, "test", "ours_2", "renders", "00000.png")
    assert read_png(render0).shape[:2] == (RES // 2, RES // 2)
    planes = os.path.join(out, "sfm", "plane-refine-depths")
    assert {f"plane_mask_frame{v:06d}.npy" for v in range(2)} <= set(os.listdir(planes))
    assert os.listdir(os.path.join(out, "tetra_meshes"))


@pytest.mark.parametrize("photo,work,one_factor", [((384, 512), 256, True),
                                                   ((380, 500), 512, False)])
def test_scale_to_images_moves_pixel_centres(tmp_path, photo, work, one_factor):
    from g4splat_torch.core.cameras import Camera

    H, W = photo
    os.makedirs(tmp_path / "images")
    save_image(str(tmp_path / "images" / "a.png"), np.zeros((H, W, 3), np.float32))
    h, w = TC.load_scene_images(str(tmp_path), work_size=work)[0].shape[1:3]
    rng = np.random.default_rng(0)
    w2c = torch.eye(4)
    w2c[:3, 3] = torch.tensor([0.1, -0.2, 0.3])
    cam = Camera(w2c, torch.tensor(0.9 * W), torch.tensor(0.8 * W), torch.tensor(0.47 * W),
                 torch.tensor(0.53 * H), width=W, height=H)
    pts = torch.from_numpy(np.concatenate([rng.uniform(-1, 1, (64, 2)),
                                           rng.uniform(2, 4, (64, 1))], 1).astype(np.float32))
    uv, _ = cam.project(pts)
    got, _ = TC.scale_to_images(cam, h, w).project(pts)
    s = torch.tensor([w / W, h / H])
    assert (h, w) != (H, W) and bool(s[0] == s[1]) == one_factor
    np.testing.assert_allclose(got.numpy(), ((uv + 0.5) * s - 0.5).numpy(), rtol=0, atol=1e-3)


def test_load_inputs_puts_test_cameras_on_the_device(tmp_path):
    """The CLI reads COLMAP cameras on the host; `load_inputs` moves the
    held-out cameras to the pipeline's device with the training ones (the
    meta device stands in for the card)."""
    from g4splat_torch.convert import camera_from

    _, jc, _ = scene_and_cameras()
    cams = camera_from(jc, device="cpu")
    pipe = TO.G4SplatPipeline(TO.PipelineConfig(output_path=str(tmp_path)), device="meta")
    pipe.load_inputs(np.zeros((3, 8, 8, 3), np.float32), cams, test_images=np.zeros((1, 8, 8, 3)),
                     test_cameras=cams)
    assert pipe.state.cameras.w2c.device.type == "meta"
    assert pipe.state.test_cameras.w2c.device.type == "meta"
