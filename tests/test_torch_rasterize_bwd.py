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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores (module scope, so that it also holds for the module's fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
