"""Parity of the port's rasterizer with g4splat_tpu on the CPU.

The same numpy scenes go through both packages (carried across with
`g4splat_torch.convert`). The JAX side runs its plain backends, `tiled` and
`dense` (its Pallas kernel is reached only by the one slow interpret-mode
test). JAX bins in depth-rank mode with no compaction and a buffer that drops
nothing, which sorts on exact depth as the port does. Maps agree to atol 2e-4,
the dense-vs-tiled bound of the JAX package's own checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import camera_from, scene_from
from g4splat_torch.core import cameras as tcam
from g4splat_torch.io import ply as tply
from g4splat_torch.models.gaussians import GaussianScene as TScene
from g4splat_torch.ops import rasterize as trast
from g4splat_torch.ops import rasterize_common as tcommon
from g4splat_torch.ops import rasterize_cuda as tcuda
from g4splat_torch.ops import rasterize_tiled as ttiled
from g4splat_tpu.core import cameras as jcam
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.ops import rasterize as jrast
from g4splat_tpu.ops import rasterize_common as jcommon
from g4splat_tpu.ops import rasterize_tiled as jtiled

ATOL = 2e-4
BG = (0.05, 0.1, 0.15)
FLOAT_KEYS = ["render", "rend_alpha", "rend_normal", "rend_normal_cam", "rend_dist",
              "rend_depth", "depth_median", "surf_depth", "surf_normal",
              "surf_normal_cam", "final_T", "dist_m1", "dist_m2", "radii"]
# (need_aux, compute_distortion): the inference kernel, the render_all /
# mesh-sweep mode, and the render() default.
MODES = {"infer": (False, True), "nodist": (True, False), "full": (True, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_scenes(n, seed, spread=1.2, depth=(2.0, 6.0), opacity=0.8, sh_degree=1):
    rng = np.random.RandomState(seed)
    xyz = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                          rng.uniform(*depth, (n, 1))], 1).astype(np.float32)
    js = JScene.from_points(xyz, rng.rand(n, 3).astype(np.float32),
                            scales=np.exp(rng.uniform(-3.2, -1.8, n)).astype(np.float32),
                            quats=rng.randn(n, 4).astype(np.float32),
                            initial_opacity=opacity, capacity=n + 8)
    js = js.replace(f_rest=jnp.asarray(rng.randn(n + 8, 15, 3).astype(np.float32) * 0.1),
                    active_sh_degree=sh_degree)
    return scene_from(js, device="cpu"), js


def make_cams(w=64, h=48, f=60.0):
    jc = jcam.make_camera(jnp.eye(4), f, f, (w - 1) / 2.0, (h - 1) / 2.0, w, h)
    return camera_from(jc, device="cpu"), jc


def configs(n, tile_k, **kw):
    jcfg = jcommon.RenderConfig(bg=jnp.asarray(BG), tile_k=tile_k, depth_rank_binning=True,
                                binning_compact_width=0, buf_size=n * 16, **kw)
    return tcommon.RenderConfig(bg=BG, tile_k=tile_k, **kw), jcfg


class Case:
    """A scene rendered once by each JAX backend, shared by the tests."""

    def __init__(self, n, seed, tile_k, **scene_kw):
        self.ts, self.js = make_scenes(n, seed, **scene_kw)
        self.tc, self.jc = make_cams()
        self.tcfg, self.jcfg = configs(self.js.capacity, tile_k)
        self.jax = {b: {k: np.asarray(v) for k, v in
                        jrast.render(self.jc, self.js, self.jcfg, backend=b).items()}
                    for b in ("tiled", "dense")}


@pytest.fixture(scope="module")
def spread_case():
    return Case(150, 0, tile_k=256)


@pytest.fixture(scope="module")
def deep_case():
    # A narrow cone of splats: the central tiles hold several hundred entries,
    # more than one 256-entry batch of the kernel.
    return Case(700, 3, tile_k=1024, spread=0.25, depth=(2.5, 4.0), opacity=0.5)


def compare(out, ref, keys, atol=ATOL):
    for k in keys:
        np.testing.assert_allclose(np_(out[k]), ref[k], atol=atol, rtol=0, err_msg=k)


def check_mode(out, ref_tiled, ref_dense, mode):
    need_aux, dist = MODES[mode]
    zero = set()
    if not (need_aux and dist):
        zero |= {"rend_dist", "dist_m1", "dist_m2"}
    for k in zero:
        assert not np_(out[k]).any(), k
    keys = [k for k in FLOAT_KEYS if k not in zero]
    compare(out, ref_tiled, keys)
    compare(out, ref_dense, keys)
    if need_aux:
        np.testing.assert_array_equal(np_(out["n_contrib"]), ref_tiled["n_contrib"])
    else:
        assert not np_(out["n_contrib"]).any()
    np.testing.assert_array_equal(np_(out["visibility_filter"]),
                                  ref_tiled["visibility_filter"])
    assert int(out["n_dropped"]) == int(ref_tiled["n_dropped"])
    assert int(out["n_overflow"]) == 0


def prep_pair(c):
    """The same scene preprocessed by both packages."""
    def run(mod, cam, s, cfg):
        return mod.preprocess(cam, s.xyz, s.scaling(), s.rotation_raw, s.opacity(),
                              s.features(), 1, config=cfg)
    return run(tcommon, c.tc, c.ts, c.tcfg), run(jcommon, c.jc, c.js, c.jcfg)


class TestPreprocess:
    def test_fields(self, spread_case):
        tp, jp = prep_pair(spread_case)
        for k in ("T", "center", "radius", "depth", "normal", "opacity", "rgb"):
            np.testing.assert_allclose(np_(getattr(tp, k)), np.asarray(getattr(jp, k)),
                                       atol=1e-4, rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(np_(tp.valid), np.asarray(jp.valid))


class TestBinning:
    @pytest.mark.parametrize("cap", [16, 2])
    def test_ranges_order_and_drops(self, spread_case, cap):
        c = spread_case
        tp, jp = prep_pair(c)
        tb = ttiled.bin_splats(tp, 64, 48, max_tiles_per_splat=cap)
        # JAX rank mode: rows presorted front to back; map its ids back.
        order = np.argsort(np.where(np.asarray(jp.valid), np.asarray(jp.depth), np.inf),
                           kind="stable")
        jb = jtiled.bin_splats(jtiled.presort_splats_by_depth(jp), 64, 48,
                               buf_size=c.js.capacity * cap, max_tiles_per_splat=cap,
                               rows_are_depth_ranks=True, compact_width=0)
        np.testing.assert_array_equal(np_(tb.tile_count), np.asarray(jb.tile_count))
        assert int(tb.n_dropped) == int(jb.n_dropped)
        assert (int(tb.n_dropped) > 0) == (cap == 2)
        assert tb.gauss_id.shape[0] == int(np.asarray(jb.tile_count).sum())
        jgid = order[np.asarray(jb.gauss_id)]
        for t, (ts_, js_, n) in enumerate(zip(np_(tb.tile_start), np.asarray(jb.tile_start),
                                              np_(tb.tile_count))):
            np.testing.assert_array_equal(np_(tb.gauss_id)[ts_:ts_ + n],
                                          jgid[js_:js_ + n], err_msg=f"tile {t}")
            assert (np_(tb.tile_id)[ts_:ts_ + n] == t).all()


class TestRender:
    @pytest.mark.parametrize("backend", ["dense", "tiled"])
    def test_differentiable_backends(self, spread_case, backend):
        c = spread_case
        out = trast.render(c.tc, c.ts, c.tcfg, backend=backend)
        if backend == "tiled":
            check_mode(out, c.jax["tiled"], c.jax["dense"], "full")
        else:   # dense n_contrib counts over all splats, as in the JAX oracle
            compare(out, c.jax["dense"], FLOAT_KEYS + ["n_contrib"])

    @pytest.mark.parametrize("mode", list(MODES))
    def test_cuda_backend_on_cpu(self, spread_case, mode):
        c = spread_case
        need_aux, dist = MODES[mode]
        cfg = tcommon.RenderConfig(bg=BG, compute_distortion=dist)
        with torch.no_grad():
            out = trast.render(c.tc, c.ts, cfg, backend="cuda", need_aux=need_aux)
        check_mode(out, c.jax["tiled"], c.jax["dense"], mode)
        assert set(out) == set(c.jax["tiled"])

    @pytest.mark.parametrize("mode", list(MODES))
    def test_plain_kernel_version(self, deep_case, mode):
        """The kernel's plain version on the entry table, deep tiles included,
        in every mode; also independent of its chunk size (chunk carries)."""
        c = deep_case
        need_aux, dist = MODES[mode]
        prep = prep_pair(c)[0]
        b = ttiled.bin_splats(prep, 64, 48)
        assert int(b.tile_count.max()) > 256
        table = tcuda.splat_table(prep)
        bg = torch.tensor(BG)
        maps = tcuda.rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                             bg, 64, 48, want_aux=need_aux, want_dist=dist)
        small = tcuda.rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                              bg, 64, 48, want_aux=need_aux, want_dist=dist,
                                              chunk=32, max_elems=1 << 16)
        pairs = {"color": "render", "normal": "rend_normal_cam", "alpha": "rend_alpha",
                 "median_depth": "depth_median", "final_T": "final_T"}
        if need_aux and dist:
            pairs.update(distortion="rend_dist", m1_tot="dist_m1", m2_tot="dist_m2")
        for k, rk in pairs.items():
            for ref in (c.jax["tiled"], c.jax["dense"]):
                np.testing.assert_allclose(np_(maps[k]), ref[rk], atol=ATOL, err_msg=k)
            np.testing.assert_allclose(np_(small[k]), np_(maps[k]), atol=1e-5, err_msg=k)
        ref = c.jax["tiled"]
        depth = np_(maps["depth_acc"]) / np.maximum(np_(maps["alpha"]), 1e-10)
        np.testing.assert_allclose(depth, ref["rend_depth"], atol=ATOL)
        if need_aux:
            np.testing.assert_array_equal(np_(maps["n_contrib"]), ref["n_contrib"])
        assert (np_(maps["n_walked"]) >= np_(maps["n_contrib"])).all()
        np.testing.assert_array_equal(np_(small["n_walked"]), np_(maps["n_walked"]))

    @pytest.mark.parametrize("mode", list(MODES))
    def test_plain_reads_table_through_gauss_id(self, deep_case, mode):
        """Entry i is row gauss_id[i] of the splat table: the plain version
        on (table, gauss_id) equals it on the gathered rows table[gauss_id]
        with identity ids, exactly, in every map and in n_walked."""
        need_aux, dist = MODES[mode]
        prep = prep_pair(deep_case)[0]
        b = ttiled.bin_splats(prep, 64, 48)
        table = tcuda.splat_table(prep)
        assert table.shape == (prep.T.shape[0], tcommon.ENTRY_F) and table.is_contiguous()
        rows = table[b.gauss_id.long()]
        ids = torch.arange(rows.shape[0], dtype=torch.int32)
        bg = torch.tensor(BG)
        got = tcuda.rasterize_entries_plain(table, b.gauss_id, b.tile_start, b.tile_count,
                                            bg, 64, 48, want_aux=need_aux, want_dist=dist)
        ref = tcuda.rasterize_entries_plain(rows, ids, b.tile_start, b.tile_count, bg, 64,
                                            48, want_aux=need_aux, want_dist=dist)
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k

    def test_deep_overlap_render(self, deep_case):
        c = deep_case
        for backend in ("tiled", "cuda"):
            with torch.no_grad():
                out = trast.render(c.tc, c.ts, c.tcfg, backend=backend)
            check_mode(out, c.jax["tiled"], c.jax["dense"], "full")

    def test_empty_scene_is_background(self):
        tc, _ = make_cams()
        scene = TScene.empty(64, device="cpu")
        for backend in ("dense", "tiled", "cuda"):
            out = trast.render(tc, scene, tcommon.RenderConfig(bg=BG), backend=backend)
            np.testing.assert_allclose(np_(out["render"]),
                                       np.broadcast_to(BG, (48, 64, 3)), atol=1e-7)
            assert not np_(out["rend_alpha"]).any()
            assert all(np.isfinite(np_(v)).all() for v in out.values())

    def test_splat_behind_camera(self):
        js = JScene.from_points(np.array([[0.0, 0.0, -2.0], [0.3, 0.1, 3.0]], np.float32),
                                np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
                                scales=np.array([0.5, 0.05], np.float32), initial_opacity=0.9)
        ts = scene_from(js, device="cpu")
        tc, jc = make_cams()
        only_front = scene_from(js.replace(alive=js.alive.at[0].set(False)), device="cpu")
        for backend in ("dense", "tiled", "cuda"):
            out = trast.render(tc, ts, tcommon.RenderConfig(bg=BG), backend=backend)
            ref = trast.render(tc, only_front, tcommon.RenderConfig(bg=BG), backend=backend)
            assert not bool(out["visibility_filter"][0])
            compare(out, {k: np_(v) for k, v in ref.items()}, FLOAT_KEYS, atol=0.0)
        jout = jrast.render(jc, js, configs(2, 64)[1], backend="dense")
        compare(out, {k: np.asarray(v) for k, v in jout.items()}, ["render", "rend_alpha"])

    def test_tiled_gradients_match_dense(self, spread_case):
        c = spread_case
        grads = []
        for backend in ("dense", "tiled"):
            xyz = c.ts.xyz.clone().requires_grad_(True)
            out = trast.render(c.tc, c.ts.replace(xyz=xyz), c.tcfg, backend=backend)
            (out["render"].square().mean() + 0.05 * out["rend_dist"].mean()).backward()
            grads.append(xyz.grad.numpy())
        assert np.isfinite(grads[0]).all() and np.abs(grads[0]).max() > 0
        rel = np.linalg.norm(grads[1] - grads[0]) / np.linalg.norm(grads[0])
        assert rel < 1e-4, rel

    def test_cuda_backend_refuses_grad(self, spread_case):
        """need_aux=False is the forward-only inference path: it refuses
        inputs that require grad (need_aux=True differentiates through B2)."""
        c = spread_case
        scene = c.ts.replace(xyz=c.ts.xyz.clone().requires_grad_(True))
        with pytest.raises(RuntimeError, match="forward-only"):
            trast.render(c.tc, scene, c.tcfg, backend="cuda", need_aux=False)
        with torch.no_grad():
            trast.render(c.tc, scene, c.tcfg, backend="cuda", need_aux=False)
        assert trast.render(c.tc, scene, c.tcfg, backend="cuda")["render"].requires_grad

    def test_mark_visible(self, spread_case):
        c = spread_case
        pts = np.random.RandomState(0).uniform(-3, 3, (100, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            np_(trast.mark_visible(c.tc, torch.from_numpy(pts))),
            np.asarray(jrast.mark_visible(c.jc, jnp.asarray(pts))))

    def test_loaded_ply_renders_like_source(self, spread_case, tmp_path):
        c = spread_case
        path = str(tmp_path / "point_cloud.ply")
        tply.save_gaussian_ply(path, c.ts)
        loaded = tply.load_gaussian_ply(path, device="cpu")
        cfg = tcommon.RenderConfig(bg=BG)
        a = trast.render(c.tc, loaded, cfg, backend="cuda", need_aux=False)
        # The file keeps live splats only and sets the SH degree from its columns.
        assert loaded.capacity == 150 and loaded.active_sh_degree == 3
        b = trast.render(c.tc, c.ts.replace(active_sh_degree=3), cfg, backend="cuda",
                         need_aux=False)
        np.testing.assert_array_equal(np_(a["render"]), np_(b["render"]))


class TestDevices:
    def test_entry_points_refuse_missing_card(self, monkeypatch, tmp_path):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcam.make_camera(np.eye(4), 50.0, 50.0, 16.0, 16.0, 32, 32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TScene.empty(4)
        path = str(tmp_path / "e.ply")
        tply.save_gaussian_ply(path, TScene.empty(4, device="cpu"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tply.load_gaussian_ply(path)

    def test_kernel_wrapper_checks_inputs(self):
        e = torch.zeros((4, 16))
        gid = torch.zeros(5, dtype=torch.int32)
        ts = torch.zeros(12, dtype=torch.int32)
        with pytest.raises(ValueError, match="tile_start"):
            tcuda.rasterize_entries(e, gid, ts.long(), ts, torch.zeros(3), 64, 48)
        with pytest.raises(ValueError, match="table"):
            tcuda.rasterize_entries(e[:, :8], gid, ts, ts, torch.zeros(3), 64, 48)


@pytest.mark.slow
def test_cuda_backend_matches_pallas_interpret(spread_case):
    """The JAX package's Pallas kernel (interpret mode) against the port's
    cuda backend on CPU tensors, in the inference and default modes."""
    c = spread_case
    for need_aux in (False, True):
        ref = jrast.render(c.jc, c.js, c.jcfg, backend="pallas", need_aux=need_aux)
        with torch.no_grad():
            out = trast.render(c.tc, c.ts, c.tcfg, backend="cuda", need_aux=need_aux)
        compare(out, {k: np.asarray(v) for k, v in ref.items()},
                ["render", "rend_alpha", "rend_depth", "depth_median", "final_T"]
                + (["rend_dist"] if need_aux else []))
