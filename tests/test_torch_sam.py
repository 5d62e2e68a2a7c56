"""Parity of `g4splat_torch.priors.sam` (and `convert.sam_state_dict`) with
`g4splat_tpu.priors.sam` and with the official-named torch oracle of
tests/test_sam_convert.py, on the CPU.

- TINY_SAM, and TINY_SAM with window_size 3 (the 8×8 grid padded to 9×9,
  as the full width pads 64 to 70): the port's seeded weights cross into
  JAX params through the JAX package's `convert_torch_sam` (no flax init);
  the image embedding within 5e-5 and a 4-prompt decode's masks and IoU
  within 2e-4 of max|JAX| (test_sam_convert.py's tolerances).
- The port's `convert_torch_sam` returns the JAX package's tree array for
  array; `sam_state_dict` gives back every official key but
  `mask_downscaling.*`, bit for bit (the transposed convolutions
  un-flipped).
- The oracle `TorchSAM` loads into the port with `strict=True` and the port
  matches its outputs at the same tolerances (the oracle's two-way
  LayerNorms use eps 1e-5, the port's 1e-6, ROADMAP C20). At `SAMConfig()`
  on the meta device the two have the same keys and shapes.
- `generate_masks` and `.batch` at 48×48 with 16 prompts, stability
  thresholds 0.0 and 0.85: on the crossed seeded weights, the same number
  of masks in both packages, each differing at ≤ 1e-3 of its pixels; with
  a stand-in decoder that returns the same seeded disc logits to both
  packages (several candidates, equal areas, suppressions), identical
  masks in the same order.
- `nms_masks` keeps the JAX loop's list on masks with tied areas;
  `resize_nearest` equals `jax.image.resize(..., "nearest")` at 256 →
  (384, 512) and at odd sizes.
- `PlaneExcavator` on `seg_masks=[]` and on SAM's masks: the same
  `seg_mask` in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.pipeline.planes as JP
import g4splat_torch.pipeline.planes as TP
from g4splat_torch.convert import sam_state_dict
from g4splat_torch.priors import sam as TS
from g4splat_tpu.priors import sam as JS
from test_sam_convert import CFG, TorchSAM
from test_torch_planes import region_normals

EMB_TOL, DEC_TOL = 5e-5, 2e-4
PIXEL_SHARE = 1e-3
PAD_SAM = dataclasses.replace(TS.TINY_SAM, window_size=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1e-3, float(np.abs(ref).max())))


def crossed(cfg, seed=0):
    """The port's seeded predictor and the JAX params converted from its
    state dict by the JAX package's converter."""
    port = TS.SAMPredictor(cfg, seed=seed, device="cpu")
    sd = {k: v.numpy() for k, v in port.model.state_dict().items()}
    return port, JS.convert_torch_sam(sd, JS.SAMConfig(**dataclasses.asdict(cfg)))


def prompts(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 1, 2)).astype(np.float32),
            np.ones((n, 1), np.float32))


@pytest.mark.parametrize("cfg", [TS.TINY_SAM, PAD_SAM], ids=["tiny", "padded-window"])
def test_forward_matches_jax(cfg):
    port, params = crossed(cfg)
    jcfg = JS.SAMConfig(**dataclasses.asdict(cfg))
    if cfg.window_size == 3:
        g = cfg.img_size // cfg.patch_size
        assert g % cfg.window_size and (g + (-g) % 3) == 9
    jp = JS.SAMPredictor(jcfg, params=params)
    img = np.random.default_rng(0).random((1, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    emb_j = np.asarray(jp._encode(params, jnp.asarray(img)))
    with torch.no_grad():
        emb_t = port.model.encode_image(torch.from_numpy(img)).numpy()
    assert rel_err(emb_t, emb_j) < EMB_TOL
    pts, lbl = prompts(4)
    embs = np.repeat(emb_j, 4, axis=0)
    masks_j, iou_j = jp._decode(params, jnp.asarray(embs), jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        masks_t, iou_t = port.model.decode(torch.from_numpy(embs), torch.from_numpy(pts),
                                           torch.from_numpy(lbl))
    assert rel_err(masks_t.numpy(), masks_j) < DEC_TOL
    assert rel_err(iou_t.numpy(), iou_j) < DEC_TOL


def test_converter_matches_jax_and_inverts():
    port = TS.SAMPredictor(TS.TINY_SAM, seed=3, device="cpu")
    sd = {k: v.numpy() for k, v in port.model.state_dict().items()}
    ours = TS.convert_torch_sam(sd, TS.TINY_SAM)
    theirs = JS.convert_torch_sam(sd, JS.TINY_SAM)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_o, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    back = sam_state_dict(ours, TS.TINY_SAM)
    assert set(sd) - set(back) == {k for k in sd if k.startswith(TS.DOWNSCALING)}
    assert set(back) <= set(sd)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), sd[k]), k
    # The transposed convolutions cross flipped and come back as they were.
    w = sd["mask_decoder.output_upscaling.0.weight"]
    assert not np.array_equal(ours["params"]["mask_decoder"]["up1"]["kernel"],
                              w.transpose(2, 3, 0, 1))


def test_oracle_loads_strictly_and_matches():
    torch.manual_seed(0)
    oracle = TorchSAM(CFG)
    with torch.no_grad():
        for n, p in oracle.named_parameters():
            if "rel_pos" in n or "pos_embed" in n:
                p.copy_(torch.randn_like(p) * 0.1)
    model = TS.SAM(CFG)
    model.load_state_dict(oracle.state_dict(), strict=True)
    img = torch.randn(1, 3, CFG.img_size, CFG.img_size)
    pts = torch.rand(2, 3, 2)
    lbl = torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 0.0]])
    with torch.no_grad():
        emb_r = oracle.image_encoder(img)
        sparse, dense_pe, no_mask = oracle.prompt_encoder(pts, lbl, emb_r.shape[-2:])
        masks_r, iou_r = oracle.mask_decoder(emb_r.expand(2, -1, -1, -1), dense_pe, sparse,
                                             no_mask)
        emb = model.encode_image(img.permute(0, 2, 3, 1))
        masks, iou = model.decode(emb.expand(2, -1, -1, -1), pts, lbl)
    assert rel_err(emb.permute(0, 3, 1, 2).numpy(), emb_r.numpy()) < EMB_TOL
    assert rel_err(masks.numpy(), masks_r.numpy()) < DEC_TOL
    assert rel_err(iou.numpy(), iou_r.numpy()) < DEC_TOL


def test_full_width_keys_equal_oracle_on_meta():
    with torch.device("meta"):
        ours = TS.SAM(TS.SAMConfig()).state_dict()
        oracle = TorchSAM(TS.SAMConfig()).state_dict()
    assert list(ours) == list(oracle)
    assert all(ours[k].shape == oracle[k].shape for k in ours)
    assert ours["image_encoder.blocks.7.attn.rel_pos_h"].shape == (127, 80)
    assert ours["image_encoder.blocks.0.attn.rel_pos_h"].shape == (27, 80)
    n = sum(v.numel() for v in ours.values())
    assert 641_000_000 < n < 641_200_000, n


def disc_logits(pts, n_masks, size, seed):
    """Seeded stand-in decoder output: per prompt, discs about the prompt of
    four radii and slopes (some too shallow for the 0.85 stability test),
    radii on a coarse grid so that areas tie."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) + 0.5
    out = np.zeros((len(pts), n_masks, size, size), np.float32)
    for i, (x, y) in enumerate(pts[:, 0] * size):
        d = np.sqrt((xx - np.round(x)) ** 2 + (yy - np.round(y)) ** 2)
        for m in range(n_masks):
            r = 2.0 * rng.integers(1, 6)
            slope = rng.choice([0.3, 4.0])
            out[i, m] = (r - d) * slope
    return out


@pytest.mark.parametrize("thresh", [0.0, 0.85])
def test_generate_masks_match_jax(thresh, monkeypatch):
    port, params = crossed(TS.TINY_SAM)
    jp = JS.SAMPredictor(JS.TINY_SAM, params=params)
    imgs = np.random.default_rng(4).random((2, 48, 48, 3)).astype(np.float32)
    kw = dict(num_prompts=16, stability_thresh=thresh)
    got = TS.sam_mask_generator(port, **kw).batch(imgs)
    want = JS.sam_mask_generator(jp, **kw).batch(imgs)
    one = port.generate_masks(imgs[1], **kw)
    assert len(one) == len(got[1]) and all(np.array_equal(a, b) for a, b in zip(one, got[1]))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == (48, 48) and a.dtype == bool
            assert np.mean(a != np.asarray(b)) <= PIXEL_SHARE

    # Identical logits in both packages: identical selection, NMS and resize.
    size = 4 * TS.TINY_SAM.img_size // TS.TINY_SAM.patch_size

    def stand_in(emb, pts, lbl):
        p = np.asarray(pts)
        return disc_logits(p, 4, size, int(p.sum() * 1e4)), np.zeros((len(p), 4), np.float32)

    monkeypatch.setattr(port, "_decode", lambda e, p, l: tuple(
        torch.from_numpy(x) for x in stand_in(e, p.numpy(), l)))
    monkeypatch.setattr(jp, "_decode", lambda prm, e, p, l: stand_in(e, p, l))
    for n_prompts in (16, 64):
        kw["num_prompts"] = n_prompts
        got = TS.sam_mask_generator(port, **kw).batch(imgs[:1])[0]
        want = JS.sam_mask_generator(jp, **kw).batch(imgs[:1])[0]
        assert len(got) == len(want) > 1
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def jax_nms(cands, iou_thresh):
    """The JAX package's NMS loop (g4splat_tpu/priors/sam.py:618-622)."""
    cands = list(cands)
    cands.sort(key=lambda m: -m.sum())
    kept = []
    for c in cands:
        if all(JS.mask_iou(c, k) < iou_thresh for k in kept):
            kept.append(c)
    return kept


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_equals_loop_with_ties(seed):
    rng = np.random.default_rng(seed)
    masks = np.zeros((40, 24, 24), bool)
    for i, m in enumerate(masks):
        y, x = rng.integers(0, 12, 2)
        h, w = (8, 9) if i % 3 else (9, 8)          # equal areas, other shapes
        if i % 5 == 0:
            h, w = rng.integers(2, 12, 2)
        m[y:y + h, x:x + w] = True
        if i % 7 == 6:                              # a near copy of an earlier mask
            m[:] = masks[i - 3]
            m[y, x] = ~m[y, x]
    areas = [int(m.sum()) for m in masks]
    assert len(set(areas)) < len(areas)
    for thresh in (0.3, 0.8):
        kept = TS.nms_masks(torch.from_numpy(masks), areas, thresh)
        want = jax_nms(masks, thresh)
        assert len(kept) == len(want) < len(masks)
        assert all(np.array_equal(masks[i], w) for i, w in zip(kept, want))
    assert TS.nms_masks(torch.zeros(0, 24, 24, dtype=torch.bool), [], 0.8) == []


@pytest.mark.parametrize("shapes", [((256, 256), (384, 512)), ((37, 23), (101, 67)),
                                    ((256, 256), (383, 511)), ((31, 30), (17, 11))])
def test_resize_nearest_matches_jax(shapes):
    (h, w), (H, W) = shapes
    x = np.random.default_rng(0).random((3, h, w)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, H, W), "nearest"))
    np.testing.assert_array_equal(TS.resize_nearest(torch.from_numpy(x), (H, W)).numpy(), want)


def test_plane_excavator_on_sam_masks():
    n = region_normals(5)
    port = TS.SAMPredictor(TS.TINY_SAM, seed=0, device="cpu")
    img = np.random.default_rng(2).random((48, 64, 3)).astype(np.float32)
    masks = port.generate_masks(img, num_prompts=16, stability_thresh=0.0)
    assert masks and all(m.shape == (48, 64) and m.dtype == bool for m in masks)
    halves = [np.zeros((48, 64), bool) for _ in range(2)]
    halves[0][:, :40] = True
    halves[1][:30] = True
    for seg in ([], masks, masks + halves):
        a = JP.PlaneExcavator(JP.PlaneExcavatorConfig())(img, n, seg_masks=seg)
        b = TP.PlaneExcavator(TP.PlaneExcavatorConfig())(torch.from_numpy(img),
                                                         torch.from_numpy(n), seg_masks=seg)
        np.testing.assert_array_equal(a["seg_mask"], b["seg_mask"])
        if not seg:
            assert not b["seg_mask"].any() and b["normal"] is None
