"""B1's and B2's reach boxes and entry reads on the CPU (split from
test_torch_rasterize_bwd.py, whose scenes and helpers it imports).

- No contributing (entry, pixel) pair of B2's plain version lies outside its
  entry's reach box (`rasterize_cuda_bwd.reach_boxes`), on the deep, spread,
  close-up and 512×384 scenes, and the forward maps are unchanged when the
  pairs outside the boxes are skipped.
- Both plain versions read entry i as row `gauss_id[i]` of the per-splat
  table, exactly as on gathered rows; the wrappers refuse a bad `gauss_id`
  and the plain versions one out of range.
- The boxes hold slanted surfels (to 89.9°) at 512×384; the box's face-on
  formula; empty and unbounded boxes.
- B2's work list: `tile_order_plain` and `tile_walks`.
"""

import numpy as np
import pytest
import torch

from g4splat_torch.ops import rasterize_common as tcommon
from g4splat_torch.ops import rasterize_cuda as tcuda
from g4splat_torch.ops import rasterize_cuda_bwd as tbwd
from test_torch_rasterize import BG, np_
from test_torch_rasterize_bwd import Case, backward_args, deep, entry_problem, spread  # noqa: F401


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
