"""Gradients of the port's rasterizer against g4splat_tpu on the CPU.

- `rasterize_backward_plain` (B2's plain version) against torch.autograd of
  the forward plain version on the same entry table, deep tiles included:
  relative norm ≤ 1e-3 per gradient group.
- render(backend="cuda") — the B1/B2 autograd Function, which on CPU tensors
  runs both plain versions — and render(backend="tiled") against JAX `tiled`
  gradients of every scene parameter and of the screen-space offset:
  relative norm ≤ 5e-3 without distortion and ≤ 1e-2 with it, the bounds of
  tests/test_rasterize.py (Pallas against tiled).

Scenes are made with numpy from a seed and carried across with
`g4splat_torch.convert`; JAX runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.ops import rasterize as trast
from g4splat_torch.ops import rasterize_common as tcommon
from g4splat_torch.ops import rasterize_cuda as tcuda
from g4splat_torch.ops import rasterize_cuda_bwd as tbwd
from g4splat_torch.ops import rasterize_tiled as ttiled
from g4splat_tpu.ops import rasterize as jrast
from test_torch_rasterize import BG, configs, make_cams, make_scenes, np_

PARAMS = ("xyz", "scaling_raw", "rotation_raw", "opacity_raw", "f_dc", "f_rest")
GROUPS = {"dT": slice(0, 9), "d_center": slice(9, 11), "d_opacity": slice(11, 12),
          "d_rgb": slice(12, 15), "d_normal": slice(15, 18)}
COT_MAPS = ("color", "normal", "depth_acc", "alpha", "distortion", "median_depth",
            "final_T")
# render() outputs the gradient loss weighs (random per-pixel weights).
LOSS_KEYS = ("render", "rend_alpha", "rend_normal", "rend_depth", "depth_median",
             "surf_normal", "final_T")


def rel(a, b):
    a, b = np_(a), np_(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class Case:
    def __init__(self, n, seed, cam=(), **scene_kw):
        self.ts, self.js = make_scenes(n, seed, **scene_kw)
        self.tc, self.jc = make_cams(*cam)
        self.n = self.js.capacity


@pytest.fixture(scope="module")
def spread():
    return Case(150, 0)


@pytest.fixture(scope="module")
def deep():
    # Central tiles hold several hundred entries: more than one chunk of the
    # plain version and several batches of the kernel.
    return Case(700, 3, spread=0.25, depth=(2.5, 4.0), opacity=0.5)


def entry_problem(case):
    """The kernels' inputs: preprocess, the binning and the splat table."""
    s = case.ts
    prep = tcommon.preprocess(case.tc, s.xyz, s.scaling(), s.rotation_raw, s.opacity(),
                              s.features(), 1)
    b = ttiled.bin_splats(prep, case.tc.width, case.tc.height)
    return prep, b, tcuda.splat_table(prep)


def identity(n):
    return torch.arange(n, dtype=torch.int32)


def cotangents(maps, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*maps[k].shape).astype(np.float32))
            for k in COT_MAPS}


def cot_image(c):
    H, W = c["alpha"].shape
    return torch.cat([c["color"], c["normal"], c["depth_acc"][..., None],
                      (c["alpha"] - c["final_T"])[..., None], c["distortion"][..., None],
                      c["median_depth"][..., None], torch.zeros(H, W, 2)], -1)


def aux_image(maps):
    return torch.stack([maps["final_T"], maps["n_contrib"].float(), maps["m1_tot"],
                        maps["m2_tot"]], -1).detach()


@pytest.mark.parametrize("want_dist", [False, True])
def test_plain_backward_matches_autograd(deep, want_dist):
    """B2's plain version against autograd of B1's plain version. Autograd
    differentiates T through the centre the forward recomputes from it, so
    the plain version's d_center is chained through `conic_center` before
    dT is compared."""
    prep, b, table = entry_problem(deep)
    assert int(b.tile_count.max()) > 256
    W, H = deep.tc.width, deep.tc.height
    bg = torch.tensor(BG)
    e = table[b.gauss_id.long()].requires_grad_(True)      # one row per entry
    maps = tcuda.rasterize_entries_plain(e, identity(e.shape[0]), b.tile_start,
                                         b.tile_count, bg, W, H, want_dist=want_dist)
    cot = cotangents(maps, 5)
    loss = sum((maps[k] * cot[k]).sum() for k in COT_MAPS)
    (de,) = torch.autograd.grad(loss, e)
    P = prep.T.shape[0]
    gid = b.gauss_id.long()
    ad = torch.zeros(P, 16).index_add_(0, gid, de)

    got = tbwd.rasterize_backward_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                        aux_image(maps), cot_image(cot), bg, W, H,
                                        want_dist=want_dist)
    T = prep.T.detach().clone().requires_grad_(True)
    center, _, ok = tcommon.conic_center(T)
    center = torch.where(ok[:, None], center, 0.0)
    (via_center,) = torch.autograd.grad(center, T, got[:, 9:11])
    pairs = {"dT": (got[:, :9] + via_center.reshape(P, 9), ad[:, :9]),
             "d_opacity": (got[:, 11], ad[:, 9]),
             "d_rgb": (got[:, 12:15], ad[:, 10:13]),
             "d_normal": (got[:, 15:18], ad[:, 13:16])}
    for name, (a, r) in pairs.items():
        assert float(r.norm()) > 0, name
        assert rel(a, r) <= 1e-3, (name, rel(a, r))


@pytest.mark.parametrize("want_dist", [False, True])
def test_plain_backward_groups_match_autograd(deep, want_dist, monkeypatch):
    """Every gradient group on its own, d_center included: autograd of B1's
    plain version with the recomputed centre made an independent input (as
    the kernels treat it, and as TestManualGeomVJP checks the TPU kernel)."""
    prep, b, table = entry_problem(deep)
    W, H = deep.tc.width, deep.tc.height
    bg = torch.tensor(BG)
    entries = table[b.gauss_id.long()]                      # one row per entry
    E = entries.shape[0]
    center, f, ok = tcommon.conic_center(entries[:, :9].reshape(E, 3, 3))
    center = center.detach().requires_grad_(True)
    monkeypatch.setattr(tcuda, "conic_center", lambda T: (center, f, ok))
    e = entries.clone().requires_grad_(True)
    maps = tcuda.rasterize_entries_plain(e, identity(E), b.tile_start, b.tile_count, bg,
                                         W, H, want_dist=want_dist)
    cot = cotangents(maps, 9)
    loss = sum((maps[k] * cot[k]).sum() for k in COT_MAPS)
    de, dc = torch.autograd.grad(loss, (e, center))
    P = prep.T.shape[0]
    ad = torch.zeros(P, 18).index_add_(
        0, b.gauss_id.long(),
        torch.cat([de[:, :9], dc, de[:, 9:10], de[:, 10:13], de[:, 13:16]], 1))
    got = tbwd.rasterize_backward_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                        aux_image(maps), cot_image(cot), bg, W, H,
                                        want_dist=want_dist)
    for name, sl in GROUPS.items():
        assert float(ad[:, sl].norm()) > 0, name
        assert rel(got[:, sl], ad[:, sl]) <= 1e-3, (name, rel(got[:, sl], ad[:, sl]))


def test_plain_backward_independent_of_chunking(deep):
    prep, b, table = entry_problem(deep)
    W, H = deep.tc.width, deep.tc.height
    bg = torch.tensor(BG)
    with torch.no_grad():
        maps = tcuda.rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                             bg, W, H)
    args = (table, b.gauss_id, b.tile_start, b.tile_count, aux_image(maps),
            cot_image(cotangents(maps, 6)), bg, W, H)
    stats = {}
    ref = tbwd.rasterize_backward_plain(*args, stats=stats)
    small = tbwd.rasterize_backward_plain(*args, chunk=16, max_elems=1 << 13)
    for name, sl in GROUPS.items():
        assert rel(small[:, sl], ref[:, sl]) <= 1e-5, name
    assert stats["pairs"] == int(maps["n_contrib"].sum())
    assert 0 < stats["contributors"] <= stats["pairs"]
    assert 0 < stats["splats"] <= prep.T.shape[0]
    assert stats["rows"] <= b.gauss_id.numel()


def backward_args(case, want_dist, seed=6):
    prep, b, table = entry_problem(case)
    W, H = case.tc.width, case.tc.height
    bg = torch.tensor(BG)
    with torch.no_grad():
        maps = tcuda.rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                             bg, W, H, want_dist=want_dist)
    return (table, b.gauss_id, b.tile_start, b.tile_count, aux_image(maps),
            cot_image(cotangents(maps, seed)), bg, W, H)


@pytest.fixture(scope="module")
def closeup():
    # Surfels 0.25-1.0 from the camera, many seen at a slant: tens of pixels
    # across, the reach boxes' widest and most tilted case.
    return Case(300, 5, spread=0.5, depth=(0.25, 1.0), opacity=0.9)


@pytest.fixture(scope="module")
def wide():
    # A 512×384 frame (the training shape): pixel coordinates in the
    # hundreds, where the intersection's cross product cancels most.
    return Case(400, 11, cam=(512, 384, 480.0), spread=1.5, depth=(2.0, 6.0))


def reach_box_pairs(args, margin):
    """Walked (entry, pixel) pairs against the entries' reach boxes, over the
    plain version's own intersections: contributing pairs outside their
    box, contributing pairs, and pairs the boxes leave out."""
    table, gid, tile_start, tile_count, aux, cot, bg, W, H = args
    box = tbwd.reach_boxes(table, margin=margin)
    gx, aux_t, cot_t, walk, ent, order, bg = tbwd._plain_setup(
        table, gid, tile_start, tile_count, aux, cot, bg, W, H, tcommon.NEAR_N,
        tcommon.FAR_N)
    n = dict(outside=0, contributing=0, left_out=0)
    for b0 in range(0, order.numel(), 32):
        t = order[b0:b0 + 32]
        b = tbwd._Batch(t, gx, tile_start, walk[t], aux_t, cot_t, bg)
        last = int(b.last.max())
        for lo in range(0, last, 64):
            pos, idx, _, _, _, _, contrib, _, _, _ = ent.chunk(b, lo, min(lo + 64, last))
            bx = box[idx]
            px, py = b.px[:, None, :].double(), b.py[:, None, :].double()
            inside = ((px >= bx[..., 0:1]) & (px <= bx[..., 1:2]) & (py >= bx[..., 2:3])
                      & (py <= bx[..., 3:4]))
            walked = (pos[None, :] < b.last[:, None])[..., None]
            n["outside"] += int((contrib & walked & ~inside).sum())
            n["contributing"] += int((contrib & walked).sum())
            n["left_out"] += int((walked & ~inside).sum())
    return n


@pytest.mark.parametrize("scene", ["deep", "spread", "closeup", "wide"])
def test_reach_boxes_hold_every_contributor(request, scene):
    """The reach box that lets B2's warps skip an entry bounds every pixel
    the entry contributes to, even with no margin (the kernel adds one
    pixel), and still leaves out part of the walked pairs: close by, at a
    slant and at the large pixel coordinates of a 512×384 frame."""
    args = backward_args(request.getfixturevalue(scene), False)
    n = reach_box_pairs(args, margin=0.0)
    assert n["contributing"] > 0
    assert n["outside"] == 0, n
    assert n["left_out"] > 0


@pytest.mark.parametrize("scene", ["deep", "spread", "closeup", "wide"])
def test_forward_skip_outside_reach_boxes_keeps_maps(request, scene, monkeypatch):
    """B1's warps skip an entry whose reach box misses their pixels. Its
    plain walk with every (entry, pixel) pair outside the entry's box (no
    margin: stricter than the kernel's warp-wide test with one pixel of
    margin) forced to alpha 0 gives the same maps, n_contrib and n_walked,
    exactly: every pair forced was already below 1/255, so the arithmetic is
    unchanged. The boxes do leave pairs out."""
    case = request.getfixturevalue(scene)
    prep, b, table = entry_problem(case)
    W, H = case.tc.width, case.tc.height
    n = dict(forced=0, left_out=0)

    def boxed(T, center, opacity, valid, px, py, near=tcommon.NEAR_N):
        alpha, z = tcommon.alpha_depth(T, center, opacity, valid, px, py, near)
        rows = torch.cat([T.reshape(-1, 9), opacity.reshape(-1, 1),
                          torch.zeros(opacity.numel(), 6)], 1)
        box = tbwd.reach_boxes(rows, margin=0.0).reshape(*opacity.shape, 4)
        x, y = px[..., None, :].double(), py[..., None, :].double()
        inside = ((x >= box[..., 0:1]) & (x <= box[..., 1:2]) & (y >= box[..., 2:3])
                  & (y <= box[..., 3:4]))
        n["forced"] += int(((alpha > 0) & ~inside).sum())
        n["left_out"] += int((valid[..., None] & ~inside).sum())
        return torch.where(inside, alpha, 0.0), z

    args = (table, b.gauss_id, b.tile_start, b.tile_count, torch.tensor(BG), W, H)
    ref = tcuda.rasterize_entries_plain(*args)
    monkeypatch.setattr(tcuda, "alpha_depth", boxed)
    got = tcuda.rasterize_entries_plain(*args)
    assert n["forced"] == 0 and n["left_out"] > 0, n
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("want_dist", [False, True])
def test_plain_backward_reads_table_through_gauss_id(deep, want_dist):
    """B2's plain version reads entry i as table row gauss_id[i] and adds its
    gradients there: the same table with its rows permuted (ids mapped
    along) gives the same gradients permuted, and a table rebuilt from the
    gathered rows (table[gauss_id] = rows, as a caller holding per-entry rows
    does) the same gradients, exactly."""
    args = backward_args(deep, want_dist)
    table, gid = args[0], args[1].long()
    ref = tbwd.rasterize_backward_plain(*args, want_dist=want_dist)
    assert ref.shape == (table.shape[0], 18) and ref.abs().sum() > 0
    perm = torch.from_numpy(np.random.RandomState(3).permutation(table.shape[0]))
    moved = torch.empty_like(table)
    moved[perm] = table
    got = tbwd.rasterize_backward_plain(moved, perm[gid].to(torch.int32), *args[2:],
                                        want_dist=want_dist)
    assert torch.equal(got[perm], ref)
    rebuilt = torch.zeros_like(table)
    rebuilt[gid] = table[gid]
    got = tbwd.rasterize_backward_plain(rebuilt, *args[1:], want_dist=want_dist)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("kernel", ["forward", "backward"])
@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_refuse_bad_gauss_id(deep, kernel, bad):
    """Both wrappers refuse a gauss_id that is not (E,) int32 on the table's
    device, before any launch."""
    prep, b, table = entry_problem(deep)
    W, H = deep.tc.width, deep.tc.height
    gid = {"dtype": b.gauss_id.long(), "shape": b.gauss_id[:, None],
           "device": b.gauss_id.to("meta")}[bad]
    with pytest.raises(ValueError, match="gauss_id"):
        if kernel == "forward":
            tcuda.rasterize_entries(table, gid, b.tile_start, b.tile_count, torch.zeros(3),
                                    W, H)
        else:
            tbwd.rasterize_backward(table, gid, b.tile_start, b.tile_count,
                                    torch.zeros(H, W, 4), torch.zeros(H, W, 12),
                                    torch.zeros(3), W, H)


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_plain_versions_raise_on_gauss_id_out_of_range(deep, kernel):
    """The wrappers leave 0 <= gauss_id < P to the caller (checking it would
    take a host sync, and the kernels read row gauss_id[i] unchecked); the
    plain versions raise on an id past the table."""
    prep, b, table = entry_problem(deep)
    W, H = deep.tc.width, deep.tc.height
    gid = b.gauss_id.clone()
    first = int(b.tile_start[int(torch.nonzero(b.tile_count)[0])])
    gid[first] = table.shape[0]
    with pytest.raises(IndexError):
        if kernel == "forward":
            tcuda.rasterize_entries(table, gid, b.tile_start, b.tile_count, torch.zeros(3),
                                    W, H)
        else:
            maps = tcuda.rasterize_entries(table, b.gauss_id, b.tile_start, b.tile_count,
                                           torch.zeros(3), W, H)
            aux = torch.stack([maps["final_T"], maps["n_contrib"].to(torch.float32),
                               maps["m1_tot"], maps["m2_tot"]], -1)
            tbwd.rasterize_backward(table, gid, b.tile_start, b.tile_count, aux,
                                    torch.ones(H, W, 12), torch.zeros(3), W, H)


def slanted_surfel(theta, center=(450.0, 330.0), depth=3.0, f=480.0, s=0.05,
                   opacity=0.9):
    """One entry row: a surfel of radius scale s at `depth` whose centre
    projects to pixel `center` of a pinhole of focal length f centred at
    (0, 0), its u axis turned by `theta` from square to the viewing ray
    toward the ray itself (90° is edge-on to the camera); T's rows are
    M = K [t_u, t_v, p0]."""
    cx, cy = center
    p0 = np.array([cx * depth / f, cy * depth / f, depth])
    ray = p0 / np.linalg.norm(p0)
    t_v = np.cross(ray, [1.0, 0.0, 0.0])
    t_v /= np.linalg.norm(t_v)
    t_u = np.cos(theta) * np.cross(t_v, ray) + np.sin(theta) * ray
    M = np.diag([f, f, 1.0]) @ np.stack([s * t_u, s * t_v, p0], 1)
    row = np.zeros(tcommon.ENTRY_F)
    row[:9] = M.reshape(-1)
    row[9] = opacity
    return torch.tensor(row[None], dtype=torch.float32)


def grid_contributors(entries, W=512, H=384):
    """(E, H·W) whether each entry contributes at each pixel of a W×H grid,
    by the forward plain version's arithmetic, and the pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    E = entries.shape[0]
    T = entries[:, :9].reshape(E, 3, 3)
    center, _, ok = tcommon.conic_center(T)
    center = torch.where(ok[:, None], center, 0.0)
    alpha, _ = tcommon.alpha_depth(T, center, entries[:, 9], torch.ones(E, dtype=torch.bool),
                                   px, py)
    return alpha > 0, px.double(), py.double()


@pytest.mark.parametrize("theta_deg,center", [
    (0.0, (450.0, 330.0)), (60.0, (450.0, 330.0)), (85.0, (450.0, 330.0)),
    (89.0, (450.0, 330.0)), (89.9, (450.0, 330.0)),
    (89.9, (0.0, 200.0)),          # edge-on to a vertical sliver: the low-pass disk sets x
])
def test_reach_box_holds_slanted_surfels(theta_deg, center):
    """A surfel of a 512×384 frame, from square to the viewing ray to
    almost edge-on: every pixel it contributes to lies inside its box with
    no margin, and while the disk's image is wide the box is tight (within
    2 pixels of the contributors) along its v axis (near y)."""
    e = slanted_surfel(np.deg2rad(theta_deg), center=center)
    hit, px, py = grid_contributors(e)
    box = tbwd.reach_boxes(e, margin=0.0)[0]
    assert int(hit.sum()) > 0
    x, y = px[hit[0]], py[hit[0]]
    assert float(x.min()) >= box[0] and float(x.max()) <= box[1]
    assert float(y.min()) >= box[2] and float(y.max()) <= box[3]
    if theta_deg <= 60.0:
        assert float(box[3] - y.max()) <= 2.0 and float(y.min() - box[2]) <= 2.0


def test_reach_box_face_on_matches_its_formula():
    """A surfel parallel to the image plane, its centre at pixel (200, 100):
    the box is the centre ± max(sqrt(R)·f·s / depth,
    sqrt(R / 2)) with R = 2 ln(opacity · 255) widened by 0.1 % + 1e-3, plus
    the margin."""
    f, s, depth, opa = 480.0, 0.05, 3.0, 0.9
    row = np.zeros(tcommon.ENTRY_F, dtype=np.float32)
    row[:9] = [f * s, 0.0, 200.0 * depth, 0.0, f * s, 100.0 * depth, 0.0, 0.0, depth]
    row[9] = opa
    e = torch.from_numpy(row[None])
    R = (2.0 * np.log(np.float32(opa) / tcommon.ALPHA_EPS)) * 1.001 + 1e-3
    r = max(np.sqrt(R) * f * s / depth, np.sqrt(R / tcommon.FILTER_INV_SQUARE))
    want = np.array([200.0 - r, 200.0 + r, 100.0 - r, 100.0 + r]) + np.array([-1, 1, -1, 1])
    np.testing.assert_allclose(np_(tbwd.reach_boxes(e, margin=1.0)[0]), want, rtol=1e-5)


def test_reach_box_empty_and_unbounded():
    """An entry below the alpha threshold reaches no pixel (an empty box);
    a disk that crosses the camera plane gets an unbounded one."""
    faint = slanted_surfel(0.3, opacity=0.5 / 255.0)
    box = tbwd.reach_boxes(faint)[0]
    assert box[0] > box[1] and box[2] > box[3]
    assert not bool(grid_contributors(faint)[0].any())
    crossing = slanted_surfel(np.deg2rad(89.0), depth=0.02, s=0.5)
    box = tbwd.reach_boxes(crossing)[0]
    assert torch.isinf(box).all() and box[0] < 0 < box[1]


@pytest.mark.parametrize("walks", [
    [0, 5, 0, 0, 3, 0],                      # empty tiles, short tiles
    [0, 9, 1, 1000, 0, 1],                   # one tile far longer than the rest
    [3, 7, 2, 8, 1, 4],                      # every tile short
    [16, 17, 15, 32, 33, 0],
    [0, 0, 0, 0],                            # nothing to walk
    [7, 7, 7, 7],                            # one bucket
    list(range(1, 65)),                      # two walks per bucket
    [1],
])
def test_tile_order_plain(walks):
    """The kernel's tile order on hand-made walks: every tile that walks an
    entry once, bucket by bucket longest first, so no tile starts behind one
    that walks more than a bucket's width (longest / NBUCKET) less."""
    walk = torch.tensor(walks, dtype=torch.int32)
    order = tbwd.tile_order_plain(walk)
    longest = max(max(walks), 1)
    want = sorted((t for t, w in enumerate(walks) if w > 0),
                  key=lambda t: (-((walks[t] - 1) * tbwd.NBUCKET // longest), t))
    assert order.dtype == torch.int32 and order.tolist() == want
    got = [walks[t] for t in want]
    for i, w in enumerate(got):
        assert all(w >= v - longest / tbwd.NBUCKET for v in got[i:])
    np.testing.assert_array_equal(np_(tbwd.walk_buckets(walk)),
                                  [((w - 1) * tbwd.NBUCKET // longest) if w else -1
                                   for w in walks])


@pytest.mark.parametrize("seed,nc_scale", [(0, 0.0), (1, 0.5), (2, 3.0), (3, 1.0)])
def test_tile_walks(seed, nc_scale):
    """Entries each tile walks, min(deepest n_contrib of its pixels, count),
    on a 40×24 frame whose edge tiles are ragged (pixels past the frame
    count for nothing)."""
    rng = np.random.RandomState(seed)
    W, H = 40, 24
    counts = rng.randint(0, 50, size=6)
    nc = np.floor(rng.rand(H, W) * nc_scale * 50)
    aux = torch.zeros(H, W, 4)
    aux[..., 1] = torch.from_numpy(nc.astype(np.float32))
    walk = tbwd.tile_walks(aux, torch.tensor(counts, dtype=torch.int32), W, H)
    want = [min(int(nc[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16].max()), int(counts[t]))
            for t, (ty, tx) in enumerate((ty, tx) for ty in range(2) for tx in range(3))]
    np.testing.assert_array_equal(np_(walk), want)


@pytest.mark.parametrize("want_dist", [False, True])
def test_backward_runs_plain_version_on_cpu(deep, want_dist):
    """On CPU tensors the wrapper is the plain version, and counts no launch."""
    args = backward_args(deep, want_dist)
    before = tbwd.RASTERIZE_BWD.launches
    got = tbwd.rasterize_backward(*args, want_dist=want_dist)
    assert tbwd.RASTERIZE_BWD.launches == before
    ref = tbwd.rasterize_backward_plain(*args, want_dist=want_dist)
    assert torch.equal(got, ref)


def test_kernel_binding_matches_source(monkeypatch):
    """Every function csrc/rasterize_bwd.cu exports gets ctypes argtypes of
    its C signature (pointer → c_void_p, int → c_int, float → c_float) and
    an int restype, so no pointer is cut to 32 bits."""
    import ctypes
    import re
    import types

    from g4splat_torch.ops import cuda_build

    src = (cuda_build.CSRC / "rasterize_bwd.cu").read_text()
    sigs = dict(re.findall(r'extern "C" int (g4_\w+)\(([^)]*)\)', src))
    assert len(sigs) == 2
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in sigs})
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    tbwd._lib()
    kinds = {"*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    for name, params in sigs.items():
        want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
                for p in params.split(",")]
        fn = getattr(fake, name)
        assert fn.argtypes == want and fn.restype is ctypes.c_int, name


def test_backward_wrapper_checks_inputs(deep):
    prep, b, table = entry_problem(deep)
    W, H = deep.tc.width, deep.tc.height
    aux = torch.zeros(H, W, 4)
    cot = torch.zeros(H, W, 12)
    bg = torch.zeros(3)
    with pytest.raises(ValueError, match="cot"):
        tbwd.rasterize_backward(table, b.gauss_id, b.tile_start, b.tile_count, aux,
                                cot[..., :10], bg, W, H)
    with pytest.raises(ValueError, match="gauss_id"):
        tbwd.rasterize_backward(table, b.gauss_id.long(), b.tile_start, b.tile_count,
                                aux, cot, bg, W, H)
    # Zero cotangents give zero gradients, one row per table row, one launch
    # of the plain version.
    g = tbwd.rasterize_backward(table, b.gauss_id, b.tile_start, b.tile_count, aux,
                                cot, bg, W, H)
    assert g.shape == (table.shape[0], 18) and not g.any()


def port_grads(case, backend, dist, weights):
    s = case.ts
    params = {k: getattr(s, k).clone().requires_grad_(True) for k in PARAMS}
    off = torch.zeros((case.n, 2), requires_grad=True)
    cfg = tcommon.RenderConfig(bg=BG, tile_k=1024, compute_distortion=dist)
    out = trast.render(case.tc, s.replace(**params), cfg, center_offset=off,
                       backend=backend)
    loss = sum((out[k] * torch.from_numpy(w)).sum() for k, w in weights.items())
    loss.backward()
    return {**{k: p.grad for k, p in params.items()}, "center_offset": off.grad}


def jax_grads(case, dist, weights, backend="tiled"):
    jcfg = configs(case.n, 1024)[1]
    js = case.js

    def loss(params, off):
        out = jrast.render(case.jc, js.replace(**params), jcfg, center_offset=off,
                           backend=backend)
        return sum(jnp.sum(out[k] * w) for k, w in weights.items())

    params = {k: getattr(js, k) for k in PARAMS}
    gp, go = jax.grad(loss, argnums=(0, 1))(params, jnp.zeros((case.n, 2)))
    return {**{k: np.asarray(v) for k, v in gp.items()}, "center_offset": np.asarray(go)}


def loss_weights(case, dist, seed=7):
    rng = np.random.RandomState(seed)
    H, W = case.tc.height, case.tc.width
    shapes = {"render": (H, W, 3), "rend_normal": (H, W, 3), "surf_normal": (H, W, 3)}
    keys = LOSS_KEYS + (("rend_dist",) if dist else ())
    return {k: rng.randn(*shapes.get(k, (H, W))).astype(np.float32) * 0.1 for k in keys}


@pytest.mark.parametrize("backend", ["cuda", "tiled"])
@pytest.mark.parametrize("dist", [False, True])
def test_gradients_match_jax_tiled(spread, backend, dist):
    """Every scene parameter's gradient and the screen-space offset's (what
    densify reads), port against JAX `tiled`."""
    weights = loss_weights(spread, dist)
    got = port_grads(spread, backend, dist, weights)
    ref = jax_grads(spread, dist, weights)
    tol = 1e-2 if dist else 5e-3
    for k, r in ref.items():
        assert np.abs(r).max() > 0, k
        assert rel(got[k], r) <= tol, (k, rel(got[k], r))


def test_deep_gradients_match_jax_tiled(deep):
    weights = loss_weights(deep, True, seed=8)
    got = port_grads(deep, "cuda", True, weights)
    ref = jax_grads(deep, True, weights)
    for k, r in ref.items():
        assert rel(got[k], r) <= 1e-2, (k, rel(got[k], r))


def test_cuda_function_counts_and_no_grad(spread):
    """One forward and one backward of the Function per render()+backward;
    with no input requiring grad it runs forward only."""
    s = spread.ts
    xyz = s.xyz.clone().requires_grad_(True)
    out = trast.render(spread.tc, s.replace(xyz=xyz), tcommon.RenderConfig(bg=BG),
                       backend="cuda")
    assert out["render"].requires_grad and not out["n_contrib"].requires_grad
    out["render"].sum().backward()
    assert xyz.grad is not None and bool(torch.isfinite(xyz.grad).all())
    with torch.no_grad():
        ref = trast.render(spread.tc, s, tcommon.RenderConfig(bg=BG), backend="cuda")
    np.testing.assert_array_equal(np_(out["render"]), np_(ref["render"]))


@pytest.mark.slow
def test_cuda_backend_grads_match_pallas_interpret(spread):
    """The JAX package's Pallas forward and backward kernels (interpret mode)
    against the port's cuda backend on CPU tensors."""
    for dist in (False, True):
        weights = loss_weights(spread, dist)
        got = port_grads(spread, "cuda", dist, weights)
        ref = jax_grads(spread, dist, weights, backend="pallas")
        for k, r in ref.items():
            assert rel(got[k], r) <= (1e-2 if dist else 5e-3), k
