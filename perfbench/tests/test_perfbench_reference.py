"""The benchmark's plain references agree with the program's plain path on
the CPU at tiny sizes: the surfel render and its gradients, the training
step's losses, and the See3D networks and call."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from perfbench.drivers import see3d_inpaint as see3d_driver
from perfbench.drivers import train_2dgs
from perfbench.reference import see3d as ref3d
from perfbench.reference import surfel, train2dgs
from perfbench.reference.precision import Ops, round_tf32
from perfbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(n=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = (torch.rand((n, 3), generator=g) * 2 - 1) * 1.5
    feats = 0.3 * torch.randn((n, 16, 3), generator=g)
    return {"xyz": xyz, "features": feats,
            "opacity": 0.2 + 0.7 * torch.rand((n,), generator=g),
            "scaling": torch.exp(-3.0 + torch.rand((n, 2), generator=g)),
            "rotation_raw": torch.randn((n, 4), generator=g)}


def port_scene(s):
    from g4splat_torch.models.gaussians import GaussianScene

    n = s["xyz"].shape[0]
    o = s["opacity"].clamp(1e-4, 1 - 1e-4)
    return GaussianScene(xyz=s["xyz"], f_dc=s["features"][:, :1], f_rest=s["features"][:, 1:],
                         opacity_raw=(torch.log(o) - torch.log1p(-o))[:, None],
                         scaling_raw=torch.log(s["scaling"]), rotation_raw=s["rotation_raw"],
                         alive=torch.ones(n, dtype=torch.bool),
                         mip_filter=torch.zeros((n, 1)), active_sh_degree=3)


def port_cam(c):
    from g4splat_torch.core.cameras import make_camera

    return make_camera(c.w2c, float(c.fx), float(c.fy), float(c.cx), float(c.cy), c.width,
                       c.height, device="cpu")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5e-3])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0                          # a tie goes to the even neighbour
    assert r[3] == 1.0 + 2 ** -9
    assert abs(float(r[4]) + 2.5e-3) <= 2.5e-3 * 2 ** -11


@pytest.mark.parametrize("backend", ["dense", "tiled", "cuda"])
def test_render_matches_the_program(backend):
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.ops.rasterize_common import RenderConfig

    s = small_scene()
    cam = surfel.look_at([0.3, -0.5, -4.0], [0, 0, 0], [0, -1, 0], 60.0, 48, 40, CPU)
    with torch.no_grad():
        want = render(port_cam(cam), port_scene(s), RenderConfig(depth_ratio=0.5),
                      backend=backend)
        got = surfel.render(cam, dict(s, opacity=torch.sigmoid(port_scene(s).opacity_raw[:, 0])),
                            3, Ops(), depth_ratio=0.5)
    assert int(got["n_pairs"].sum()) > 0
    for k in ("render", "rend_alpha", "rend_normal", "surf_depth", "surf_normal", "radii"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_render_gradients_match_the_program():
    from g4splat_torch.ops.rasterize import render
    from g4splat_torch.ops.rasterize_common import RenderConfig

    s = small_scene(200, seed=3)
    cam = surfel.look_at([0.0, -0.3, -4.0], [0, 0, 0], [0, -1, 0], 60.0, 40, 32, CPU)
    g = torch.Generator().manual_seed(9)
    cot = {k: torch.randn(shape, generator=g) for k, shape in
           (("render", (32, 40, 3)), ("rend_normal", (32, 40, 3)), ("surf_depth", (32, 40)))}

    def grads(fn, leaves):
        leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        out = fn(leaves)
        total = sum((out[k] * c).sum() for k, c in cot.items())
        return torch.autograd.grad(total, list(leaves.values()))

    base = port_scene(s)
    keys = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw")
    leaves = {k: getattr(base, k) for k in keys}
    want = grads(lambda p: render(port_cam(cam), base.replace(**p),
                                  RenderConfig(depth_ratio=0.5, compute_distortion=False),
                                  backend="cuda"), leaves)
    got = grads(lambda p: surfel.render(
        cam, {"xyz": p["xyz"], "features": torch.cat([p["f_dc"], p["f_rest"]], 1),
              "opacity": torch.sigmoid(p["opacity_raw"][:, 0]),
              "scaling": torch.exp(p["scaling_raw"]), "rotation_raw": p["rotation_raw"]},
        3, Ops(), depth_ratio=0.5, want_dist=False), leaves)
    for k, a, b in zip(keys, got, want):
        assert float(b.norm()) > 0, k
        assert float((a - b).norm() / b.norm()) < 1e-4, k


def test_step_loss_matches_the_program():
    from g4splat_torch.train import losses as L
    from g4splat_torch.train.trainer import TrainConfig, compute_losses

    cfg = tiny.config("room_2dgs")
    sc = dict(cfg["scene"], **tiny.TRAIN_SCENE)
    pb = train_2dgs.make_problem(sc, 7, CPU)
    tc = TrainConfig(**cfg["train"])
    it = 1998
    cam = pb["cams"][2]
    view = {k: v[2] for k, v in pb["views"].items() if k != "scale_factor"}
    view["scale_factor"] = pb["views"]["scale_factor"]
    mip = train2dgs.mip_filter(pb["init"]["xyz"], pb["cams"])
    p = pb["init"]
    shifts = L.draw_depth_order_shifts((sc["height"], sc["width"]),
                                       torch.Generator().manual_seed(1))
    got = train2dgs.step_loss(p, pb["alive"], mip, cam, view, cfg["train"], it, 3, shifts,
                              Ops())
    from g4splat_torch.models.gaussians import GaussianScene

    scene = GaussianScene(alive=pb["alive"], mip_filter=mip, active_sh_degree=3,
                          use_mip_filter=True, **p)
    want, _ = compute_losses(scene, port_cam(cam), view, tc, it,
                             torch.zeros((sc["capacity"], 2)), shifts=shifts)
    assert math.isclose(float(got), float(want), rel_tol=1e-5)


def test_training_follow_matches_the_trainer():
    """Three steps of the reference and of `Trainer.step` from one state."""
    cfg = tiny.config("room_2dgs")
    traffic = tiny.traffic("train_window")
    cfg["scene"].update(tiny.TRAIN_SCENE)
    cell = train_2dgs.TrainCell(cfg, traffic, 11, CPU)
    want = cell.reference(Ops())
    for name, v in train_2dgs.compare(cell.got, want):
        assert v < 1e-4, (name, v)


# ------------------------------------------------------------------- See3D
@pytest.fixture(scope="module")
def tiny_see3d():
    cfg = tiny.config("see3d_mvdream_sd21")
    for k, v in tiny.SEE3D_MODELS.items():
        cfg["models"][k].update(v)
    layout = ref3d.shapes(cfg["models"])
    w = ref3d.Weights.from_flat(see3d_driver.make_weights(layout, 4, CPU, 0.5), layout)
    return cfg, w, see3d_driver.program_modules(cfg["models"], w)


def test_parameter_names_match_the_program_at_full_width():
    cfg = tiny.config("see3d_mvdream_sd21")
    layout = ref3d.shapes(cfg["models"])
    w = ref3d.Weights({k: torch.empty(s, device="meta") for k, s in layout.items()})
    nets = see3d_driver.program_modules(cfg["models"], w)
    n = sum(p.numel() for net in nets.values() for p in net.parameters())
    assert n == sum(int(np.prod(s)) for s in layout.values())
    assert 1.90e9 < n < 1.95e9


def test_networks_match_the_program(tiny_see3d):
    from g4splat_torch.priors.clip_text import CLIPTextEmbedder
    from g4splat_torch.priors.clip_vision import CLIPImageEmbedder

    cfg, w, nets = tiny_see3d
    m = cfg["models"]
    g = torch.Generator().manual_seed(2)
    ops = Ops()
    with torch.no_grad():
        x = torch.randn((6, 9, 16, 16), generator=g)
        t = torch.full((6,), 500, dtype=torch.long)
        ctx = torch.randn((6, 77, 16), generator=g)
        np.testing.assert_allclose(ref3d.unet(w.unet, x, t, ctx, 3, m["unet"], ops).numpy(),
                                   nets["unet"](x, t, ctx, num_frames=3).numpy(),
                                   rtol=1e-4, atol=1e-5)
        img = torch.rand((3, 3, 32, 32), generator=g) * 2 - 1
        z = ref3d.vae_encode(w.vae, img, ops)
        np.testing.assert_allclose(z.numpy(), nets["vae"].encode(img).numpy(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(ref3d.vae_decode(w.vae, z, ops).numpy(),
                                   nets["vae"].decode(z).numpy(), rtol=1e-4, atol=1e-5)
        im = torch.rand((32, 32, 3), generator=g)
        np.testing.assert_allclose(
            ref3d.clip_image_context(w.clip_vision, im, m["clip_vision"], ops).numpy(),
            CLIPImageEmbedder(nets["clip_vision"])(im).numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            ref3d.clip_text_context(w.clip_text, m["clip_text"], ops, CPU).numpy(),
            CLIPTextEmbedder(nets["clip_text"])().numpy(), rtol=1e-4, atol=1e-6)


def test_inpaint_call_matches_the_stage(tiny_see3d):
    from g4splat_torch.pipeline.orchestrator import Priors
    from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint
    from g4splat_torch.priors.clip_text import CLIPTextEmbedder
    from g4splat_torch.priors.clip_vision import CLIPImageEmbedder
    from g4splat_torch.priors.see3d import DDIMConfig, See3DPipeline

    cfg, w, nets = tiny_see3d
    traffic = dict(tiny.traffic("inpaint_4ref_5warp"), **tiny.SEE3D_TRAFFIC)
    x = see3d_driver.Inputs(cfg, traffic, 5, CPU)
    priors = Priors(see3d=See3DPipeline(nets["unet"], DDIMConfig(**cfg["models"]["ddim"])),
                    vae=nets["vae"], image_embedder=CLIPImageEmbedder(nets["clip_vision"]),
                    text_embedder=CLIPTextEmbedder(nets["clip_text"]))
    outs, _ = run_see3d_inpaint(priors, x.refs, 4, x.warps, x.masks, stage=0,
                                mvd_resolution=32, noise_fn=x.noise, device="cpu")
    with torch.no_grad():
        got = ref3d.inpaint(w, cfg["models"], x.refs, torch.stack(x.warps),
                            torch.stack(x.masks), x.noise, Ops())
    np.testing.assert_allclose(got["images"].numpy(), torch.stack(outs).numpy(), atol=1e-4)
