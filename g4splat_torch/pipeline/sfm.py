"""MASt3R-SfM: sparse global alignment of two-view pointmaps (counterpart of
`g4splat_tpu.pipeline.sfm`).

1. Per pair, symmetric MASt3R inference and reciprocal-NN correspondences
   (`priors/mast3r.py`).
2. Canonical per-image depths: the confidence-weighted average of each
   image's self-pointmaps over its pairs; a focal from the pointmap.
3. Pose graph: a kinematic tree by ward clustering of the pair scores
   (scipy), relative poses by Umeyama on the shared pointmaps, composed
   root out.
4. Two Adam phases over per-image parameters (the quaternion and
   translation relative to the tree parent, log focal, log depth scale,
   per-anchor log depth offsets on a stride-8 grid, principal point): a
   confidence-weighted gamma 1.5 3D matching loss, then a gamma 0.5 2D
   reprojection loss, each under a cosine learning rate, quaternions
   renormalised after every step. Posed mode freezes poses and intrinsics.

The problem's tensors and the Adam loop live on the device the caller names
(the card by default); autograd takes the place of `jax.value_and_grad`,
and the Adam update and schedules are written out as optax computes them.
The sampled losses stay on the device until the loop ends. Graph building,
canonical depths, cleaning and rectification are host numpy, as in the JAX
package. Timings go to an optional `stats` dict the caller passes, not to a
module global (ROADMAP C5).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from g4splat_torch.core.transforms import quat_to_rotmat, rotmat_to_quat
from g4splat_torch.device import DeviceLike, fp32_math, resolve_device


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- primitives
def estimate_focal_from_pointmap(pts3d: np.ndarray) -> float:
    """Focal (pixels) from a self-pointmap: the median of the pixel /
    tangent ratios about the image centre."""
    pts3d = _np(pts3d)
    H, W, _ = pts3d.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys, xs = np.mgrid[:H, :W]
    u = xs - cx
    v = ys - cy
    z = np.maximum(pts3d[..., 2], 1e-8)
    x = pts3d[..., 0]
    y = pts3d[..., 1]
    fx = u * z / np.where(np.abs(x) < 1e-8, 1e-8, x)
    fy = v * z / np.where(np.abs(y) < 1e-8, 1e-8, y)
    f = np.concatenate([fx[np.abs(x) > 1e-3], fy[np.abs(y) > 1e-3]])
    f = f[f > 0]
    return float(np.median(f)) if len(f) else float(max(H, W))


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform aligning src → dst: returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def maximum_spanning_tree(n: int, edges: Dict[Tuple[int, int], float]):
    """Prim's algorithm on pair scores → (root, [(parent, child)…]) rooted at
    the best-connected node."""
    if n == 1:
        return 0, []
    score = np.zeros(n)
    for (i, j), w in edges.items():
        score[i] += w
        score[j] += w
    root = int(np.argmax(score))
    in_tree = {root}
    out = []
    while len(in_tree) < n:
        best = None
        for (i, j), w in edges.items():
            if (i in in_tree) == (j in in_tree):
                continue
            if best is None or w > best[0]:
                parent, child = (i, j) if i in in_tree else (j, i)
                best = (w, parent, child)
        if best is None:  # disconnected graph: attach arbitrarily
            rest = set(range(n)) - in_tree
            child = rest.pop()
            out.append((root, child))
            in_tree.add(child)
            continue
        out.append((best[1], best[2]))
        in_tree.add(best[2])
    return root, out


def build_kinematic_tree(
    n: int, edges: Dict[Tuple[int, int], float], linkage: str = "ward"
) -> Tuple[int, List[Tuple[int, int]]]:
    """Shallow kinematic tree by ward hierarchical clustering of the pair
    affinities (scipy, float64, in the JAX package's order): each merge joins
    the two clusters' representatives. Returns (root, [(parent, child)…])
    parent before child."""
    if n == 1:
        return 0, []
    pws = np.zeros((n, n))
    smax = max(edges.values()) if edges else 1.0
    for (i, j), w in edges.items():
        pws[i, j] = pws[j, i] = min(w / max(smax, 1e-12), 1.0)
    np.fill_diagonal(pws, 1.0)
    dist = np.where(pws > 0, 1.0 - pws, 2.0)
    np.fill_diagonal(dist, 0.0)

    import scipy.cluster.hierarchy as sch
    from scipy.spatial.distance import squareform

    Z = sch.linkage(squareform(dist, checks=False), method=linkage)
    tree_edges = []
    new_to_old = {i: i for i in range(n)}
    pws_run = pws.copy()
    for k, (a, b) in enumerate(Z[:, :2].astype(int)):
        a = new_to_old[a]
        b = new_to_old[b]
        tree_edges.append((a, b))
        best = a if pws_run[a].sum() > pws_run[b].sum() else b
        new_to_old[n + k] = best
        pws_run[best] = np.maximum(pws_run[a], pws_run[b])

    root = int(np.argmax(pws.sum(axis=1)))
    adj = [[] for _ in range(n)]
    for a, b in tree_edges:
        adj[a].append(b)
        adj[b].append(a)
    seen = {root}
    order = [root]
    out = []
    qi = 0
    while qi < len(order):
        u = order[qi]
        qi += 1
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                order.append(v)
                out.append((u, v))
    for v in range(n):
        if v not in seen:
            seen.add(v)
            out.append((root, v))
    return root, out


def _parent_array(n: int, root: int, tree) -> np.ndarray:
    parent = np.full(n, -1, np.int64)
    for par, child in tree:
        parent[child] = par
    return parent


def _topo_order(root: int, tree) -> List[int]:
    return [root] + [child for _, child in tree]


def gamma_loss(x: torch.Tensor, gamma: float, eps: float = 1e-8) -> torch.Tensor:
    """(x + eps)^gamma."""
    return (x + eps) ** gamma


# -------------------------------------------------------- Adam and schedules
def cosine_decay(lr: float, decay_steps: int):
    """optax.cosine_decay_schedule(lr, decay_steps) as a function of the
    update count (0 for the first update)."""
    def sched(count: int) -> float:
        c = min(count, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
    return sched


def piecewise_constant(lr: float, boundaries: Sequence[int], factor: float):
    """optax.piecewise_constant_schedule(lr, {b: factor}): the rate is scaled
    by `factor` once the count reaches each boundary."""
    def sched(count: int) -> float:
        v = lr
        for b in sorted(int(b) for b in boundaries):
            if count >= b:
                v *= factor
        return v
    return sched


class Adam:
    """optax.adam over a dict of tensors with one schedule per key:
    m̂ / (sqrt(v̂) + eps), the rate read at the update count (0 first)."""

    def __init__(self, params: Dict[str, torch.Tensor], schedules, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedules, self.b1, self.b2, self.eps = schedules, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        c = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** c, 1.0 - self.b2 ** c
        for k, g in grads.items():
            m, v = self.m[k], self.v[k]
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            params[k].sub_(self.schedules[k](self.count) * upd)
        self.count = c


# ------------------------------------------------------------------ problem
class PairData(NamedTuple):
    i: int
    j: int
    xy_i: np.ndarray       # (M, 2) pixel coords in image i
    xy_j: np.ndarray       # (M, 2)
    conf: np.ndarray       # (M,)
    score: float           # pair strength (Σ conf)
    T_ji: Optional[np.ndarray] = None  # (4, 4) cam-j→cam-i rigid estimate
    # DUSt3R regression fallback targets: image-i pixels and their predicted
    # 3D in camera j's frame (X12), for pairs without reliable matches.
    xy_reg: Optional[np.ndarray] = None    # (K, 2)
    pts_reg: Optional[np.ndarray] = None   # (K, 3)
    conf_reg: Optional[np.ndarray] = None  # (K,)


@dataclass
class SfMConfig:
    niter1: int = 500
    niter2: int = 500
    lr1: float = 0.07
    lr2: float = 0.014
    gamma1: float = 1.5
    gamma2: float = 0.5
    max_corres_per_pair: int = 2048
    optimize_intrinsics: bool = True
    fix_poses: bool = False
    anchor_stride: int = 8
    optimize_depth_offsets: bool = True
    # Multiplies log_doff's gradient before Adam, which all but cancels a
    # gradient scale (ROADMAP C14); kept as the JAX package has it.
    depth_offset_lr_mult: float = 0.1
    shared_intrinsics: bool = False
    optimize_pp: bool = False
    matching_conf_thr: float = 5.0
    loss_dust3r_w: float = 0.01
    gamma_d: float = 1.1
    max_reg_points: int = 1024


class SfMResult(NamedTuple):
    w2c: np.ndarray          # (V, 4, 4)
    focals: np.ndarray       # (V,)
    depthmaps: np.ndarray    # (V, h, w) optimized (scaled) canonical depths
    losses: List[float]


def _bilinear4(g, vi, y0, x0, wy, wx):
    return (g[vi, y0, x0] * (1 - wx) * (1 - wy) + g[vi, y0, x0 + 1] * wx * (1 - wy)
            + g[vi, y0 + 1, x0] * (1 - wx) * wy + g[vi, y0 + 1, x0 + 1] * wx * wy)


def sparse_global_alignment(
    canonical_depths,                 # (V, h, w) canonical per-image depths
    init_focals,                      # (V,)
    pairs: Sequence[PairData],
    cfg: SfMConfig = SfMConfig(),
    init_w2c: Optional[np.ndarray] = None,   # (V, 4, 4) calibrated init
    freeze: Optional[np.ndarray] = None,     # (V,) bool, per-image freeze
    device: DeviceLike = None,
    stats: Optional[Dict[str, float]] = None,
) -> SfMResult:
    """The two Adam phases on `device`. `stats`, when given, receives
    ``phase{k}_s_per_iter`` (steady state: the clock starts after step 0),
    ``phase{k}_iters`` and ``tree_s`` (the kinematic tree's host seconds)."""
    dev = resolve_device(device)
    canonical_depths = _np(canonical_depths).astype(np.float32)
    V, H, W = canonical_depths.shape
    freeze_np = (np.asarray(freeze, bool) if freeze is not None else np.zeros(V, bool))

    def t32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    edges = {(p.i, p.j): p.score for p in pairs}
    t_tree = time.perf_counter()
    root, tree = build_kinematic_tree(V, edges)
    if stats is not None:
        stats["tree_s"] = time.perf_counter() - t_tree

    if init_w2c is None:
        rel = {(p.i, p.j): p.T_ji for p in pairs if p.T_ji is not None}
        c2w = [None] * V
        c2w[root] = np.eye(4)
        for par, child in tree:
            T = None
            if (par, child) in rel:
                T = rel[(par, child)]             # child cam → parent cam
            elif (child, par) in rel:
                T = np.linalg.inv(rel[(child, par)])
            if T is None:
                T = np.eye(4)
            c2w[child] = c2w[par] @ T
        w2c0 = np.stack([np.linalg.inv(m) for m in c2w])
    else:
        w2c0 = _np(init_w2c).astype(np.float64).copy()

    # Kinematic chain: w2c_v = T_rel(v) @ w2c_parent(v); the root holds its
    # absolute pose.
    T_rel0 = np.zeros((V, 4, 4))
    T_rel0[root] = w2c0[root]
    for par, child in tree:
        T_rel0[child] = w2c0[child] @ np.linalg.inv(w2c0[par])
    quats0 = rotmat_to_quat(torch.as_tensor(T_rel0[:, :3, :3], dtype=torch.float32))
    trans0 = T_rel0[:, :3, 3]

    P = len(pairs)
    M = cfg.max_corres_per_pair
    xi = np.zeros((P, M, 2), np.float32)
    xj = np.zeros((P, M, 2), np.float32)
    cw = np.zeros((P, M), np.float32)
    pij = np.zeros((P, 2), np.int64)
    for k, p in enumerate(pairs):
        m = min(M, len(p.conf))
        order = np.argsort(p.conf)[::-1][:m]
        xi[k, :m] = p.xy_i[order]
        xj[k, :m] = p.xy_j[order]
        cw[k, :m] = p.conf[order]
        pij[k] = (p.i, p.j)
    cw = cw / max(cw.sum(), 1e-8) * (cw > 0).sum()

    stride = max(1, int(cfg.anchor_stride))
    Gh = (H - 1) // stride + 2
    Gw = (W - 1) // stride + 2

    params = {
        "quat": quats0.to(dev),
        "trans": t32(trans0),
        "log_focal": torch.log(t32(_np(init_focals))),
        "log_scale": torch.zeros(V, device=dev),
        "log_doff": torch.zeros((V, Gh, Gw), device=dev),
        "pp": torch.zeros((V, 2), device=dev),
    }
    depths0 = t32(canonical_depths)
    xi_t, xj_t, cw_t = t32(xi), t32(xj), t32(cw)
    pi_t = torch.as_tensor(pij[:, 0], device=dev)
    pj_t = torch.as_tensor(pij[:, 1], device=dev)
    n_pos = int((cw > 0).sum())
    parent = [int(p) for p in _parent_array(V, root, tree)]
    topo = _topo_order(root, tree)
    pp_base = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], device=dev)

    def compose_chain(params):
        """Relative (quat, trans) along the tree → absolute w2c (R, t)."""
        R_rel = quat_to_rotmat(params["quat"])
        t_rel = params["trans"]
        R_abs, t_abs = [None] * V, [None] * V
        for v in topo:
            p = parent[v]
            if p < 0:
                R_abs[v], t_abs[v] = R_rel[v], t_rel[v]
            else:
                R_abs[v] = R_rel[v] @ R_abs[p]
                t_abs[v] = R_rel[v] @ t_abs[p] + t_rel[v]
        return torch.stack(R_abs), torch.stack(t_abs)

    def lattice(xy, hi_x, hi_y, scale, gx_max, gy_max):
        gx = torch.clamp(xy[..., 0], 0, hi_x) / scale
        gy = torch.clamp(xy[..., 1], 0, hi_y) / scale
        x0 = torch.clamp(torch.floor(gx).long(), 0, gx_max)
        y0 = torch.clamp(torch.floor(gy).long(), 0, gy_max)
        return y0, x0, gy - y0, gx - x0

    def depth_offset_at(params, view_idx, xy):
        y0, x0, wy, wx = lattice(xy, W - 1, H - 1, stride, Gw - 2, Gh - 2)
        g = params["log_doff"]
        g = g - g.mean(dim=(1, 2), keepdim=True)
        return _bilinear4(g, view_idx[:, None], y0, x0, wy, wx)

    def pp_of(params, view_idx):
        return pp_base[None, :] + torch.clamp(params["pp"][view_idx], -10.0, 10.0)

    def focal_of(params, view_idx):
        if cfg.shared_intrinsics:
            return torch.exp(params["log_focal"].mean().expand(view_idx.shape))
        return torch.exp(params["log_focal"][view_idx])

    def world_points(params, R_abs, t_abs, view_idx, xy):
        R, t = R_abs[view_idx], t_abs[view_idx]
        f = focal_of(params, view_idx)
        # The global scale is gauge: the smallest per-image scale is pinned
        # at 1, and the offset grid is centred per image.
        ls = params["log_scale"] - params["log_scale"].min()
        s = torch.exp(ls[view_idx])
        y0, x0, wy, wx = lattice(xy, W - 1, H - 1, 1, W - 2, H - 2)
        d = _bilinear4(depths0, view_idx[:, None], y0, x0, wy, wx)
        d = d * s[:, None] * torch.exp(depth_offset_at(params, view_idx, xy))
        pp = pp_of(params, view_idx)
        pc = torch.stack([(xy[..., 0] - pp[:, None, 0]) / f[:, None] * d,
                          (xy[..., 1] - pp[:, None, 1]) / f[:, None] * d, d], -1)
        return torch.einsum("pba,pmb->pma", R, pc - t[:, None, :])

    def project(params, R_abs, t_abs, view_idx, pts_world):
        R, t = R_abs[view_idx], t_abs[view_idx]
        f = focal_of(params, view_idx)
        pc = torch.einsum("pab,pmb->pma", R, pts_world) + t[:, None, :]
        z = torch.clamp(pc[..., 2], min=1e-6)
        pp = pp_of(params, view_idx)
        return torch.stack([pc[..., 0] / z * f[:, None] + pp[:, None, 0],
                            pc[..., 1] / z * f[:, None] + pp[:, None, 1]], -1), pc[..., 2]

    # DUSt3R regression fallback for correspondence-starved pairs.
    weak = [p for p in pairs if p.xy_reg is not None
            and (len(p.conf) == 0 or p.conf.max() <= cfg.matching_conf_thr)]
    if weak:
        K = cfg.max_reg_points
        Pw = len(weak)
        rxy = np.zeros((Pw, K, 2), np.float32)
        rpts = np.zeros((Pw, K, 3), np.float32)
        rcw = np.zeros((Pw, K), np.float32)
        rij = np.zeros((Pw, 2), np.int64)
        for k, p in enumerate(weak):
            m = min(K, len(p.conf_reg))
            sel = np.argsort(p.conf_reg)[::-1][:m]
            rxy[k, :m] = p.xy_reg[sel]
            rpts[k, :m] = p.pts_reg[sel]
            rcw[k, :m] = p.conf_reg[sel]
            if freeze_np[p.i] and freeze_np[p.j]:
                rcw[k] = 0.0
            rij[k] = (p.i, p.j)
        rxy_t, rpts_t, rcw_t = t32(rxy), t32(rpts), t32(rcw)
        ri_t = torch.as_tensor(rij[:, 0], device=dev)
        rj_t = torch.as_tensor(rij[:, 1], device=dev)
        rden = max(float(rcw.sum(dtype=np.float32)), 1e-8)

        def loss_reg(params, R_abs, t_abs):
            wi = world_points(params, R_abs, t_abs, ri_t, rxy_t)
            Rj, tj = R_abs[rj_t], t_abs[rj_t]
            tgt = torch.einsum("pba,pmb->pma", Rj, rpts_t - tj[:, None, :])
            d = torch.linalg.vector_norm(wi - tgt, dim=-1)
            return torch.sum(rcw_t * gamma_loss(d, cfg.gamma_d)) / rden
    else:
        def loss_reg(params, R_abs, t_abs):
            return 0.0

    def loss_3d(params):
        R_abs, t_abs = compose_chain(params)
        wi = world_points(params, R_abs, t_abs, pi_t, xi_t)
        wj = world_points(params, R_abs, t_abs, pj_t, xj_t)
        d = torch.linalg.vector_norm(wi - wj, dim=-1)
        main = torch.sum(cw_t * gamma_loss(d, cfg.gamma1)) / max(n_pos, 1)
        return main + cfg.loss_dust3r_w * loss_reg(params, R_abs, t_abs)

    def loss_2d(params):
        R_abs, t_abs = compose_chain(params)
        wi = world_points(params, R_abs, t_abs, pi_t, xi_t)
        wj = world_points(params, R_abs, t_abs, pj_t, xj_t)
        pj, zj = project(params, R_abs, t_abs, pj_t, wi)
        pi, zi = project(params, R_abs, t_abs, pi_t, wj)
        res = float(max(H, W))
        e1 = torch.linalg.vector_norm(pj - xj_t, dim=-1) / res
        e2 = torch.linalg.vector_norm(pi - xi_t, dim=-1) / res
        total = torch.sum(cw_t * (gamma_loss(e1, cfg.gamma2) * (zj > 1e-3).float()
                                  + gamma_loss(e2, cfg.gamma2) * (zi > 1e-3).float()))
        main = total / max(2 * n_pos, 1)
        return main + cfg.loss_dust3r_w * loss_reg(params, R_abs, t_abs)

    keep = 1.0 - torch.as_tensor(freeze_np, dtype=torch.float32, device=dev)
    mult = cfg.depth_offset_lr_mult if cfg.optimize_depth_offsets else 0.0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    samples = []
    with fp32_math():
        for phase, (loss_fn, lr, niter) in enumerate(
                [(loss_3d, cfg.lr1, cfg.niter1), (loss_2d, cfg.lr2, cfg.niter2)]):
            if niter == 0:
                continue
            sched = cosine_decay(lr, niter)
            opt = Adam(params, {k: sched for k in params}, b1=0.9, b2=0.9)
            t_ss = None
            for it in range(niter):
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss = loss_fn(leaves)
                g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                         allow_unused=True)))
                g = {k: torch.zeros_like(params[k]) if v is None else v for k, v in g.items()}
                # The JAX step's gradient surgery, as written.
                if cfg.fix_poses:
                    g["quat"] = torch.zeros_like(g["quat"])
                    g["trans"] = torch.zeros_like(g["trans"])
                else:
                    g["quat"] = g["quat"] * keep[:, None]
                    g["trans"] = g["trans"] * keep[:, None]
                    g["log_scale"] = g["log_scale"] * keep
                if not cfg.optimize_intrinsics:
                    g["log_focal"] = torch.zeros_like(g["log_focal"])
                if not (cfg.optimize_pp and cfg.optimize_intrinsics):
                    g["pp"] = torch.zeros_like(g["pp"])
                g["log_doff"] = g["log_doff"] * mult
                params = {k: v.detach() for k, v in params.items()}
                opt.step(params, g)
                params["quat"] = params["quat"] / torch.linalg.vector_norm(
                    params["quat"], dim=-1, keepdim=True)
                if it == 0 and stats is not None:
                    sync()
                    t_ss = time.perf_counter()
                if it % max(1, niter // 10) == 0:
                    samples.append(loss.detach())
            if niter > 1 and stats is not None:
                sync()
                stats[f"phase{phase + 1}_s_per_iter"] = (time.perf_counter() - t_ss) / (niter - 1)
                stats[f"phase{phase + 1}_iters"] = niter

        with torch.no_grad():
            R_abs, t_abs = compose_chain(params)
    losses = [float(x) for x in torch.stack(samples).cpu()] if samples else []
    log_focal = _np(params["log_focal"])
    if cfg.shared_intrinsics:
        focals = np.full(V, float(np.exp(log_focal.mean())), np.float32)
    else:
        focals = np.exp(log_focal)
    ls = _np(params["log_scale"])
    scales = np.exp(ls - ls.min())
    w2c = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    w2c[:, :3, :3] = _np(R_abs)
    w2c[:, :3, 3] = _np(t_abs)

    # The per-anchor offsets at full resolution on the returned depths.
    ys, xs = np.mgrid[:H, :W].astype(np.float32)
    gx = xs / stride
    gy = ys / stride
    x0 = np.clip(np.floor(gx).astype(np.int64), 0, Gw - 2)
    y0 = np.clip(np.floor(gy).astype(np.int64), 0, Gh - 2)
    wx = gx - x0
    wy = gy - y0
    g = _np(params["log_doff"])
    g = g - g.mean(axis=(1, 2), keepdims=True)
    off = (g[:, y0, x0] * (1 - wx) * (1 - wy) + g[:, y0, x0 + 1] * wx * (1 - wy)
           + g[:, y0 + 1, x0] * (1 - wx) * wy + g[:, y0 + 1, x0 + 1] * wx * wy)
    depthmaps = canonical_depths * scales[:, None, None] * np.exp(off)
    return SfMResult(w2c, focals, depthmaps.astype(np.float32), losses)


def align_to_calibrated_locations(result: SfMResult, target_centers: np.ndarray) -> SfMResult:
    """Similarity-align the estimated camera centres to calibrated ones;
    depths scale with it."""
    centers = np.stack([np.linalg.inv(m)[:3, 3] for m in result.w2c])
    s, R, t = umeyama(centers, target_centers, with_scale=True)
    new_w2c = []
    for m in result.w2c:
        c2w = np.linalg.inv(m)
        c2w_new = np.eye(4)
        c2w_new[:3, :3] = R @ c2w[:3, :3]
        c2w_new[:3, 3] = s * R @ c2w[:3, 3] + t
        new_w2c.append(np.linalg.inv(c2w_new))
    return SfMResult(np.stack(new_w2c).astype(np.float32), result.focals,
                     result.depthmaps * s, result.losses)


# ------------------------------------------------------- pipeline assembly
def build_pairs_exhaustive(n: int) -> List[Tuple[int, int]]:
    """All view pairs."""
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def _avg_angle_depth(preds, subsample: int = 8) -> np.ndarray:
    """The reference's canonical_view(mode='avg-angle'): per block of
    `subsample` pixels, the confidence-weighted mean elevation angle about
    the block centre. preds: (pts3d (H, W, 3), conf (H, W)) of one view.
    Returns the (H, W) canonical depth."""
    H, W = preds[0][0].shape[:2]
    s = subsample
    while s > 1 and (H % s or W % s):
        s //= 2
    pts = np.stack([p for p, _ in preds])
    w = np.maximum(np.stack([c for _, c in preds]) - 0.999, 1e-8)
    canon_z = (w * pts[..., 2]).sum(0) / w.sum(0)
    if s <= 1:
        return canon_z
    Hb, Wb = H // s, W // s

    def blockify(x):
        return x.reshape(x.shape[0], Hb, s, Wb, s)

    cyx = (slice(s // 2, None, s), slice(s // 2, None, s))
    xy = pts[..., :2]
    xy_c = xy[:, cyx[0], cyx[1]]
    z_c = pts[:, cyx[0], cyx[1], 2]
    dxy = (blockify(xy[..., 0]) - xy_c[..., 0][:, :, None, :, None],
           blockify(xy[..., 1]) - xy_c[..., 1][:, :, None, :, None])
    radius = np.maximum(np.sqrt(dxy[0] ** 2 + dxy[1] ** 2), 1e-8)
    dz = blockify(pts[..., 2]) - z_c[:, :, None, :, None]
    angle = np.arctan(dz / radius)
    wb = blockify(w)
    avg_angle = (wb * angle).sum(0) / wb.sum(0)
    rel = radius.mean(0) * np.tan(avg_angle)
    out = canon_z[cyx][:, None, :, None] + rel
    return out.reshape(H, W)


def canonical_views_from_pairs(V: int, pair_outputs: Dict[Tuple[int, int], Tuple],
                               mode: str = "avg-z", return_confs: bool = False):
    """Confidence-weighted canonical depths and focal inits per image: the
    z of every self-pointmap prediction (X11 when the image is first, X22
    when second) averaged, on the host; "avg-angle" takes the reference's
    block-angle canonicalisation instead."""
    if mode == "avg-angle":
        per_view = {}
        for (i, j), (out11, out21, out22, out12) in pair_outputs.items():
            for v, out in ((i, out11), (j, out22)):
                per_view.setdefault(v, []).append((_np(out["pts3d"][0]), _np(out["conf"][0])))
        depths_aa = np.stack([np.maximum(_avg_angle_depth(per_view[v]), 1e-3)
                              for v in range(V)])
        rest = canonical_views_from_pairs(V, pair_outputs, mode="avg-z",
                                          return_confs=return_confs)
        if return_confs:
            return depths_aa.astype(np.float32), rest[1], rest[2]
        return depths_aa.astype(np.float32), rest[1]
    depth_acc, conf_acc, count, first = {}, {}, {}, {}
    example = None
    for (i, j), (out11, out21, out22, out12) in pair_outputs.items():
        for v, out in ((i, out11), (j, out22)):
            pts = _np(out["pts3d"][0])
            z = pts[..., 2]
            c = _np(out["conf"][0])
            if example is None:
                example = z
            first.setdefault(v, pts)
            depth_acc.setdefault(v, np.zeros_like(z))
            conf_acc.setdefault(v, np.zeros_like(c))
            depth_acc[v] += z * c
            conf_acc[v] += c
            count[v] = count.get(v, 0) + 1
    H, W = example.shape
    depths = np.zeros((V, H, W), np.float32)
    focals = np.zeros(V, np.float32)
    for v in range(V):
        d = depth_acc[v] / np.maximum(conf_acc[v], 1e-8)
        depths[v] = np.maximum(d, 1e-3)
        # The focal from the first pair in which v takes part.
        focals[v] = estimate_focal_from_pointmap(first[v])
    if return_confs:
        confs = np.stack([conf_acc[v] / max(count[v], 1) for v in range(V)])
        return depths, focals, confs.astype(np.float32)
    return depths, focals


def clean_depth_confidences(w2c: np.ndarray, focals: np.ndarray, depthmaps: np.ndarray,
                            confs: np.ndarray, tol: float = 0.001,
                            bad_conf: float = 0.0) -> np.ndarray:
    """Cross-view depth-consistency cleanup (the reference's clean_depth): a
    pixel whose point lands in front of another view's depth surface by more
    than `tol` (relative) while less confident than that view's pixel gets
    confidence `bad_conf`. Centred principal point, fx == fy."""
    V, H, W = depthmaps.shape
    res = np.asarray(confs, np.float32).copy()
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    pts_w = np.empty((V, H * W, 3), np.float32)
    for i in range(V):
        z = depthmaps[i]
        pc = np.stack([(xs - cx) / focals[i] * z, (ys - cy) / focals[i] * z, z],
                      -1).reshape(-1, 3)
        c2w = np.linalg.inv(w2c[i])
        pts_w[i] = pc @ c2w[:3, :3].T + c2w[:3, 3]
    for i in range(V):
        for j in range(V):
            if i == j:
                continue
            pj = pts_w[i] @ np.asarray(w2c[j][:3, :3]).T + w2c[j][:3, 3]
            zj = pj[:, 2]
            safe = np.where(zj > 1e-9, zj, 1.0)
            u = np.round(pj[:, 0] / safe * focals[j] + cx).astype(np.int64)
            v = np.round(pj[:, 1] / safe * focals[j] + cy).astype(np.int64)
            msk = (zj > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            idx = np.where(msk)[0]
            ui, vi = u[idx], v[idx]
            ri = res[i].reshape(-1)
            bad = ((zj[idx] < (1.0 - tol) * depthmaps[j][vi, ui])
                   & (ri[idx] < res[j][vi, ui]))
            ri[idx[bad]] = np.minimum(ri[idx[bad]], bad_conf)
            res[i] = ri.reshape(H, W)
    return res


def relative_pose_from_pair(out11, out22, out12, conf_thresh: float = 1.5):
    """cam-j → cam-i rigid estimate: Umeyama of j's self points (frame j)
    onto j's points in frame i (X12)."""
    pj = _np(out22["pts3d"][0]).reshape(-1, 3)
    pj_in_i = _np(out12["pts3d"][0]).reshape(-1, 3)
    c = np.minimum(_np(out22["conf"][0]).reshape(-1), _np(out12["conf"][0]).reshape(-1))
    keep = c > conf_thresh
    if keep.sum() < 10:
        keep = np.argsort(c)[-100:]
    s, R, t = umeyama(pj[keep], pj_in_i[keep], with_scale=False)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


# -------------------------------------------------- posed-mode rectification
def rectify_to_center_pp(images, cameras):
    """Resample calibrated images so the principal point is centred and
    fx == fy, keeping (H, W): a symmetric crop about the principal point,
    trimmed to the W:H aspect, one bilinear remap (host numpy). Returns
    (images', cameras') on the images' and cameras' devices; views already
    centred pass through untouched."""
    from g4splat_torch.core.cameras import make_camera, stack_cameras

    dev = images.device if isinstance(images, torch.Tensor) else cameras.w2c.device
    imgs = _np(images).astype(np.float32)
    V, H, W = imgs.shape[:3]
    out_imgs = np.empty_like(imgs)
    out_cams = []
    vt, ut = np.mgrid[:H, :W].astype(np.float32)
    fxs, fys, cxs, cys = (_np(getattr(cameras, k)) for k in ("fx", "fy", "cx", "cy"))
    cam_dev = cameras.w2c.device
    for v in range(V):
        fx, fy, cx, cy = float(fxs[v]), float(fys[v]), float(cxs[v]), float(cys[v])
        centered = (abs(cx - (W - 1) / 2) < 1e-3 and abs(cy - (H - 1) / 2) < 1e-3
                    and abs(fx - fy) < 1e-6)
        if centered:
            out_imgs[v] = imgs[v]
            out_cams.append(make_camera(cameras.w2c[v], fx, fy, cx, cy, W, H, device=cam_dev))
            continue
        hx = min(cx, W - 1 - cx)
        hy = min(cy, H - 1 - cy)
        if hx / max(hy, 1e-6) > W / H:
            hx = hy * W / H
        else:
            hy = hx * H / W
        f = 0.5 * (fx + fy)
        f_t = f * (W - 1) / (2.0 * hx)
        x = (ut - (W - 1) / 2) / f_t
        y = (vt - (H - 1) / 2) / f_t
        out_imgs[v] = _bilinear_remap(imgs[v], fx * x + cx, fy * y + cy)
        out_cams.append(make_camera(cameras.w2c[v], f_t, f_t, (W - 1) / 2, (H - 1) / 2, W, H,
                                    device=cam_dev))
    return torch.as_tensor(out_imgs, device=dev), stack_cameras(out_cams)


def _bilinear_remap(img: np.ndarray, su: np.ndarray, sv: np.ndarray):
    """Sample img at float source coords (cv2.remap INTER_LINEAR, border
    clamp)."""
    H, W = img.shape[:2]
    u0 = np.clip(np.floor(su).astype(np.int64), 0, W - 1)
    v0 = np.clip(np.floor(sv).astype(np.int64), 0, H - 1)
    u1 = np.minimum(u0 + 1, W - 1)
    v1 = np.minimum(v0 + 1, H - 1)
    au = np.clip(su - u0, 0.0, 1.0)[..., None]
    av = np.clip(sv - v0, 0.0, 1.0)[..., None]
    top = img[v0, u0] * (1 - au) + img[v0, u1] * au
    bot = img[v1, u0] * (1 - au) + img[v1, u1] * au
    return top * (1 - av) + bot * av
