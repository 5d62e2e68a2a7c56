"""Command-line entry point with the reference `train.py` flag surface
(counterpart of `g4splat_tpu.cli`).

Usage (mirrors the reference README):
    python -m g4splat_torch.cli -s data/scene -o output/scene \\
        --sfm_config posed --use_view_config --config_view_num 5 \\
        --select_inpaint_num 10 --tetra_downsample_ratio 0.25 \\
        --checkpoint_dir zoo

Input layout: `source_path/images/*.png|jpg` (+ optional COLMAP
`source_path/sparse/0` for posed mode, + optional `split-{N}views.json`).
The prior networks come from --checkpoint_dir, the JAX package's npz zoo
(`scripts/convert_checkpoints.py` writes it: one npz per prior, a pickled
numpy params tree and, optionally, the config's kwargs); each is taken
through the port's converter in `g4splat_torch.convert`. An absent file
leaves its prior None and the stage degrades as the orchestrator says.

Everything runs on the card; `main(argv, device="cpu")` runs on the CPU
(with `--render_backend tiled` or `dense`: the `cuda` backend's kernels
need the card).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from g4splat_torch.device import DeviceLike, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="g4splat_torch scene reconstruction")
    p.add_argument("-s", "--source_path", type=str, required=True)
    p.add_argument("-o", "--output_path", type=str, default=None)
    p.add_argument("--n_images", type=int, default=None)
    p.add_argument("--use_view_config", action="store_true")
    p.add_argument("--config_view_num", type=int, default=10)
    p.add_argument("--image_idx", type=int, nargs="*", default=None)
    p.add_argument("--randomize_images", action="store_true",
                   help="shuffle (seeded) the image list before --n_images "
                        "truncation; ignored with --image_idx / view config "
                        "(run_sfm.py:48-53 semantics)")
    p.add_argument("--dense_supervision", action="store_true",
                   help="switch the GS schedule to the 30k 'long' config "
                        "(train.py:120-121)")
    p.add_argument("--use_dense_view", action="store_true")
    p.add_argument("--dense_regul", type=str, default="default",
                   choices=["default", "strong", "weak", "none"],
                   help="accepted for reference flag parity (the reference "
                        "trainer receives but never reads it)")
    p.add_argument("--no_interpolated_views", action="store_true",
                   help="disable interpolated cameras in mesh extraction")
    p.add_argument("--downweight_input_view_color_loss", action="store_true",
                   help="x0.01 color loss on input views too "
                        "(train_with_refine_depth.py:384)")
    p.add_argument("--use_multires_tsdf", action="store_true")
    p.add_argument("--use_mesh_filter", action="store_true")
    p.add_argument("--sfm_config", type=str, default="unposed",
                   choices=["posed", "unposed"])
    p.add_argument("--alignment_config", type=str, default="default")
    p.add_argument("--depth_model", type=str, default="depthanythingv2",
                   choices=["depthanythingv2"],
                   help="monocular depth prior family (only DA2)")
    p.add_argument("--depthanything_encoder", type=str, default="vitl")
    p.add_argument("--free_gaussians_config", type=str, default=None,
                   help="None → 'long' with --dense_supervision else "
                        "'default' (train.py:120-121)")
    p.add_argument("--tsdf_config", type=str, default="default")
    p.add_argument("--tetra_config", type=str, default="default")
    p.add_argument("--tetra_downsample_ratio", type=float, default=0.5)
    p.add_argument("--select_inpaint_num", type=int, default=20)
    p.add_argument("--use_downsample_gaussians", action="store_true")
    p.add_argument("--downsample_gaussians_type", type=str, default="warp",
                   choices=["warp", "voxel"])
    p.add_argument("--warp_depth_error_thresh", type=float, default=0.01)
    p.add_argument("--warp_downsample_pixel_grid_size", type=int, default=-1)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="Directory with converted prior-model checkpoints")
    p.add_argument("--work_size", type=int, default=512)
    p.add_argument("--iterations", type=int, default=None,
                   help="None → iterations from the resolved "
                        "free_gaussians_refinement YAML (7000/30000)")
    p.add_argument("--render_backend", type=str, default="cuda",
                   choices=["cuda", "tiled", "dense"])
    return p


def load_scene_images(source_path: str, n_images=None, image_idx=None, work_size: int = 512,
                      randomize: bool = False, seed: int = 0):
    """The scene's photos, sorted by name, each resized (bilinear, as
    `jax.image.resize` does it) so its longer side is near `work_size`, both
    sides rounded to multiples of 16. Returns ((V, h, w, 3) float32, files)."""
    from g4splat_torch.core.resize import resize_bilinear
    from g4splat_torch.io.images import load_image

    img_dir = os.path.join(source_path, "images")
    files = sorted(glob.glob(os.path.join(img_dir, "*.png"))
                   + glob.glob(os.path.join(img_dir, "*.jpg"))
                   + glob.glob(os.path.join(img_dir, "*.jpeg")))
    if image_idx:
        files = [files[i] for i in image_idx]
    elif n_images:
        if randomize:
            # Seeded shuffle, then a constant-spacing subsample to n_images
            # (run_mast3r.py:76 help text).
            order = np.random.RandomState(seed).permutation(len(files))
            step = max(1, len(files) // n_images)
            files = [files[i] for i in sorted(order[::step][:n_images])]
        else:
            files = files[:n_images]
    imgs = []
    for f in files:
        img = load_image(f)
        H, W = img.shape[:2]
        s = work_size / max(H, W)
        nh = max(16, int(round(H * s / 16)) * 16)
        nw = max(16, int(round(W * s / 16)) * 16)
        imgs.append(resize_bilinear(torch.from_numpy(img), (nh, nw)).numpy())
    return np.stack(imgs), files


def scale_to_images(cameras, height: int, width: int):
    """Cameras of the photos' size → cameras of the loaded (resized) images:
    focals scaled, principal points moved as the half-pixel resize moves
    pixel centres, (c + 0.5)·s − 0.5. The JAX package's CLI keeps the
    photos' intrinsics (ROADMAP C23)."""
    sx, sy = width / cameras.width, height / cameras.height
    if sx == sy == 1.0:
        return cameras
    return cameras.replace(fx=cameras.fx * sx, fy=cameras.fy * sy,
                           cx=(cameras.cx + 0.5) * sx - 0.5, cy=(cameras.cy + 0.5) * sy - 0.5,
                           width=width, height=height)


def _load_npz(path):
    """npz zoo entry → (params tree, config kwargs or None): a pickled
    ``params`` tree of numpy arrays and an optional pickled ``cfg``."""
    data = dict(np.load(path, allow_pickle=True))
    params = data["params"].item()
    cfg = data["cfg"].item() if "cfg" in data else None
    return params, cfg


def build_priors(args, device: DeviceLike = None):
    """Every prior network of --checkpoint_dir on `device` (the card by
    default); an absent file leaves its prior None. Zoo: one npz per prior,
    depth_anything_v2, mast3r, sam, see3d, see3d_sr, vae, clip, clip_text,
    lpips. The reference loads the torch originals at
    guidance/see3d_util.py:18-40 (MVD UNet + VAE + CLIP),
    planes/mask_generator.py:10-18 (SAM) and in eval (VGG for LPIPS)."""
    from g4splat_torch import convert
    from g4splat_torch.pipeline.orchestrator import Priors

    priors = Priors()
    ckpt = args.checkpoint_dir
    if not ckpt:
        return priors
    dev = resolve_device(device)

    def path(name):
        p = os.path.join(ckpt, name + ".npz")
        return p if os.path.exists(p) else None

    def built(factory, state_dict):
        with torch.device(dev):
            module = factory()
        module.load_state_dict(state_dict, strict=True)
        return module.eval()

    p = path("depth_anything_v2")
    if p:
        from g4splat_torch.priors.depth_anything import DepthAnything, DepthAnythingV2

        params, cfg = _load_npz(p)
        enc = (cfg or {}).get("encoder", args.depthanything_encoder)
        priors.depth_model = DepthAnything(enc, model=built(
            lambda: DepthAnythingV2(enc), convert.depth_anything_state_dict(params, enc)))

    p = path("mast3r")
    if p:
        from g4splat_torch.priors.mast3r import AsymmetricMASt3R, MASt3RConfig, MASt3RModel

        params, cfg = _load_npz(p)
        mcfg = MASt3RConfig(**cfg) if cfg else MASt3RConfig()
        priors.mast3r = MASt3RModel(mcfg, model=built(
            lambda: AsymmetricMASt3R(mcfg), convert.mast3r_state_dict(params, mcfg)))

    p = path("sam")
    if p:
        from g4splat_torch.priors.sam import SAMConfig, SAMPredictor, sam_mask_generator

        params, cfg = _load_npz(p)
        scfg = SAMConfig(**cfg) if cfg else SAMConfig()
        priors.sam_generator = sam_mask_generator(SAMPredictor(
            scfg, state_dict=convert.sam_state_dict(params, scfg), device=dev))

    for name in ("see3d", "see3d_sr"):
        p = path(name)
        if p:
            from g4splat_torch.priors.see3d import MultiViewUNet, See3DPipeline, UNetConfig

            params, cfg = _load_npz(p)
            ucfg = UNetConfig(**cfg) if cfg else UNetConfig()
            setattr(priors, name, See3DPipeline(built(lambda: MultiViewUNet(ucfg),
                                                      convert.flax_state_dict(params))))

    p = path("vae")
    if p:
        from g4splat_torch.priors.vae import AutoencoderKL

        params, cfg = _load_npz(p)
        priors.vae = built(lambda: AutoencoderKL(**(cfg or {})), convert.flax_state_dict(params))

    p = path("clip")
    if p:
        from g4splat_torch.priors.clip_vision import CLIPImageEmbedder, CLIPVision

        params, cfg = _load_npz(p)
        priors.image_embedder = CLIPImageEmbedder(model=built(
            lambda: CLIPVision(**(cfg or {})), convert.flax_state_dict(params)))

    p = path("clip_text")
    if p:
        from g4splat_torch.priors.clip_text import CLIPText, CLIPTextEmbedder

        params, cfg = _load_npz(p)
        cfg = dict(cfg or {})
        pad_id = int(cfg.pop("pad_id", 0))
        sd = convert.flax_state_dict(params)
        # The tables as the checkpoint holds them (the JAX tower reads the
        # first n_ctx rows of any position table, and any vocabulary).
        cfg.setdefault("vocab_size", sd["token_embedding"].shape[0])
        cfg.setdefault("max_positions", sd["pos_embed"].shape[0])
        priors.text_embedder = CLIPTextEmbedder(model=built(lambda: CLIPText(**cfg), sd),
                                                pad_id=pad_id)

    p = path("lpips")
    if p:
        from g4splat_torch.eval.image_metrics import LPIPS

        params, _ = _load_npz(p)
        priors.lpips = LPIPS(params=convert.lpips_params_from(params, device=dev),
                             calibrated=True, device=dev)
    return priors


def main(argv=None, device: DeviceLike = None) -> int:
    """Parse `argv` (sys.argv without the program by default) and run the
    pipeline on `device` (the card by default)."""
    args = build_parser().parse_args(argv)
    out = args.output_path or os.path.join(
        "output", os.path.basename(args.source_path.rstrip("/")))
    os.makedirs(out, exist_ok=True)

    from g4splat_torch.core.cameras import stack_cameras
    from g4splat_torch.io import colmap as colmap_io
    from g4splat_torch.pipeline.orchestrator import G4SplatPipeline, PipelineConfig

    # View split (reference --use_view_config + split-{N}views.json,
    # train.py:99-114 / eval/eval.py:67-80): the train ids select the
    # training views, the test ids become the held-out eval set.
    image_idx = args.image_idx
    test_ids: list = []
    if args.use_view_config and not image_idx:
        from g4splat_torch.io.splits import load_view_split

        split = load_view_split(args.source_path, args.config_view_num)
        if split is not None:
            image_idx, test_ids = split

    images, _ = load_scene_images(args.source_path, args.n_images, image_idx, args.work_size,
                                  randomize=args.randomize_images)
    test_images = None
    if test_ids:
        test_images, _ = load_scene_images(args.source_path, None, test_ids, args.work_size)

    cameras = test_cameras = None
    sparse_dir = os.path.join(args.source_path, "sparse", "0")
    if args.sfm_config == "posed" and os.path.isdir(sparse_dir):
        cams, imgs_meta, _ = colmap_io.read_model(sparse_dir)
        fw = colmap_io.to_framework_cameras(cams, imgs_meta, device="cpu")
        if image_idx:
            cameras = stack_cameras([fw[i][1] for i in image_idx])
        else:
            cameras = stack_cameras([c for _, c in fw[:len(images)]])
        cameras = scale_to_images(cameras, *images.shape[1:3])
        if test_ids:
            test_cameras = scale_to_images(stack_cameras([fw[i][1] for i in test_ids]),
                                           *test_images.shape[1:3])

    # --dense_supervision → the 30k 'long' schedule (train.py:120-121);
    # iterations follow the resolved YAML unless --iterations overrides.
    fg_config = args.free_gaussians_config or ("long" if args.dense_supervision else "default")
    iterations = args.iterations
    if iterations is None:
        from g4splat_torch.utils.config import load_config

        iterations = int(load_config("free_gaussians_refinement", fg_config).get(
            "iterations", 7000))

    cfg = PipelineConfig(
        source_path=args.source_path,
        output_path=out,
        sfm_config=args.sfm_config,
        alignment_config=args.alignment_config,
        free_gaussians_config=fg_config,
        tetra_config=args.tetra_config,
        tsdf_config=args.tsdf_config,
        tetra_downsample_ratio=args.tetra_downsample_ratio,
        select_inpaint_num=args.select_inpaint_num,
        use_dense_view=args.use_dense_view,
        dense_regul=args.dense_regul,
        use_interpolated_views=not args.no_interpolated_views,
        downweight_input_view_color_loss=args.downweight_input_view_color_loss,
        use_mesh_filter=args.use_mesh_filter,
        use_multires_tsdf=args.use_multires_tsdf,
        use_downsample_gaussians=args.use_downsample_gaussians,
        downsample_gaussians_type=args.downsample_gaussians_type,
        warp_depth_error_thresh=args.warp_depth_error_thresh,
        warp_downsample_pixel_grid_size=args.warp_downsample_pixel_grid_size,
        work_size=args.work_size,
        train_iterations=iterations,
        render_backend=args.render_backend,
    )
    pipeline = G4SplatPipeline(cfg, build_priors(args, device), device=device)
    results = pipeline.run(images, cameras=cameras, test_images=test_images,
                           test_cameras=test_cameras)
    print(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
