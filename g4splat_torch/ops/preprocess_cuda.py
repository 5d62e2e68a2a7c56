"""Splat preprocess as one CUDA pass per splat, forward and backward
(`csrc/preprocess.cu`), and its plain closed form in PyTorch.

`preprocess_splats` computes what `rasterize_common.preprocess` computes (the
reference's `FORWARD::preprocess`, forward.cu:151-253, with the SH colour of
forward.cu:20-71) inside one `torch.autograd.Function`: the surfel transform T
= world2pix · S, the camera-facing view normal, the dual conic's centre and
extent, the radius and tile rectangle, the SH colour at the active degree and
the culling mask. Its backward (the reference's `BACKWARD::preprocess`,
backward.cu:587-643) recomputes that chain from the saved inputs and turns
the cotangents of T, the centre, the colour and the normal into the
gradients of xyz, the activated scaling, the raw rotation, the SH
coefficients (or the override colours) and the screen-space centre offset
that densify reads. depth, radius and valid carry no gradient; opacity
passes through untouched, as in the torch chain. The camera gets no
gradient: `render` sends a camera that requires one to the torch chain.

`preprocess_splats` takes CUDA tensors and launches the kernels.
`forward_plain` / `backward_plain` are the closed forms vectorised over
slots, which repeat the kernels' arithmetic; `apply_forms` runs the same
Function on them, for the CPU tests. The forward's geometry (T, p_view, the
normal's flip, the conic, the extent, radius, tile rectangle and valid) is
written there as one elementwise torch op per rounding, in the order the
kernel takes with rounded intrinsics, so both give the same radius and valid
on the card. `rasterize_common.preprocess`, the torch chain, stays the CPU
path of `render` and the autograd oracle that both are tested against.

The kernels replace no TPU kernel: the JAX package's preprocess is XLA ops
(g4splat_tpu/ops/rasterize_common.py:121, no pl.pallas_call). They replace
the port's ~100 elementwise, `cat` and reduction passes over (P, ·) tensors,
and their autograd, at the 2.4M slots of training. Bytes bound both: the
forward reads 240 B a slot (xyz, scaling, rotation, opacity, 16 SH bands,
the offset) and writes 77 (T, centre, radius, depth, normal, rgb, valid);
the backward reads the inputs, valid and 68 B of cotangents and writes
236 B of gradients (`FWD_BYTES_PER_SLOT`, `BWD_BYTES_PER_SLOT`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from g4splat_torch.core import sh as sh_lib
from g4splat_torch.core.cameras import Camera
from g4splat_torch.core.transforms import normalize
from g4splat_torch.ops.cuda_build import KernelInfo
from g4splat_torch.ops.rasterize_common import (
    ALPHA_EPS,
    CUTOFF,
    TILE,
    Preprocessed,
    RenderConfig,
    float_to_int32,
)

PREPROCESS_FWD = KernelInfo(
    name="preprocess_fwd",
    source="g4splat_torch/csrc/preprocess.cu",
    replaces="none: XLA ops in g4splat_tpu/ops/rasterize_common.py:121 preprocess",
)
PREPROCESS_BWD = KernelInfo(
    name="preprocess_bwd",
    source="g4splat_torch/csrc/preprocess.cu",
    replaces="none: autograd of g4splat_tpu/ops/rasterize_common.py:121 preprocess",
)

# Bytes a slot at SH degree 3 with a centre offset (the training step's case).
# Forward: reads xyz 12, scaling 8, rotation 16, opacity 4, f_dc 12, f_rest
# 180, offset 8; writes T 36, centre 8, radius 4, depth 4, normal 12, rgb 12,
# valid 1. Backward: reads the five inputs (228), valid 1 and the cotangents
# of T, centre, rgb and normal (68); writes the gradients of xyz, scaling,
# rotation, f_dc, f_rest and the offset (236).
FWD_BYTES_PER_SLOT = 240 + 77
BWD_BYTES_PER_SLOT = 228 + 1 + 68 + 236

MAX_REST = 15             # f_rest's bands at SH degree 3, the kernels' most
NEAR_TEST = 0.2           # view z below which a splat is culled (forward.cu:166)
EPS_SQ = 1e-24            # normalize()'s eps², in the quaternion and the SH direction


def camera_requires_grad(camera: Camera) -> bool:
    return any(t.requires_grad for t in (camera.w2c, camera.fx, camera.fy, camera.cx,
                                         camera.cy))


def preprocess_splats(
    camera: Camera,
    xyz: torch.Tensor,
    scaling: torch.Tensor,
    rotation_raw: torch.Tensor,
    opacity: torch.Tensor,
    f_dc: torch.Tensor,
    f_rest: torch.Tensor,
    sh_degree: int = 0,
    colors: Optional[torch.Tensor] = None,
    config: Optional[RenderConfig] = None,
    center_offset: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """`rasterize_common.preprocess` in one autograd Function over the
    kernels, on CUDA tensors. f_dc (P, 1, 3) and f_rest (P, K, 3) are the
    scene's two SH tensors; `colors` (P, 3) replaces the SH colour where
    given."""
    if not xyz.is_cuda:
        raise ValueError("preprocess_splats runs the CUDA kernels; on CPU tensors use "
                         "rasterize_common.preprocess")
    return apply_forms((forward_cuda, backward_cuda), camera, xyz, scaling, rotation_raw,
                       opacity, f_dc, f_rest, sh_degree, colors, config, center_offset)


def apply_forms(forms, camera: Camera, xyz, scaling, rotation_raw, opacity, f_dc, f_rest,
                sh_degree=0, colors=None, config=None, center_offset=None) -> Preprocessed:
    """`preprocess_splats` with the Function's forward and backward given:
    (forward_cuda, backward_cuda) there, (forward_plain, backward_plain)
    where the CPU tests hold the closed forms against the torch chain."""
    config = config or RenderConfig()
    if camera_requires_grad(camera):
        raise ValueError("preprocess_splats gives the camera no gradient; use "
                         "rasterize_common.preprocess for a camera that requires one")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"SH degree must be 0-3, got {sh_degree}")
    nb = sh_lib.num_sh_coeffs(sh_degree)
    if colors is None and f_rest.shape[1] + 1 < nb:
        raise ValueError(f"SH degree {sh_degree} needs {nb - 1} bands in f_rest, got "
                         f"{f_rest.shape[1]}")
    geom = (int(sh_degree), float(config.scale_modifier), int(camera.width),
            int(camera.height))
    T, center, normal, rgb, radius, depth, valid = _Preprocess.apply(
        forms, xyz, scaling, rotation_raw, f_dc, f_rest, colors, center_offset,
        opacity.detach().reshape(-1), camera.w2c, camera.world2pix, geom)
    return Preprocessed(T=T, center=center, radius=radius, depth=depth, normal=normal,
                        opacity=opacity.reshape(-1), rgb=rgb, valid=valid)


class _Preprocess(torch.autograd.Function):
    """Inputs forms (the forward and backward functions), xyz, scaling,
    rotation_raw, f_dc, f_rest, colors (or None), center_offset (or None),
    then the non-differentiable opacity (P,), w2c (4, 4), world2pix (3, 4)
    and geom (sh_degree, scale_modifier, width, height). Outputs T, center,
    normal, rgb, radius, depth, valid."""

    @staticmethod
    def forward(ctx, forms, xyz, scaling, rotation_raw, f_dc, f_rest, colors, center_offset,
                opacity, w2c, world2pix, geom):
        args = (xyz, scaling, rotation_raw, f_dc, f_rest, colors, center_offset, opacity,
                w2c, world2pix)
        forward, ctx.backward_form = forms
        out = forward(*args, *geom)
        valid = out[-1]
        ctx.save_for_backward(xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c,
                              world2pix, valid)
        ctx.geom = geom
        ctx.has_offset = center_offset is not None
        ctx.mark_non_differentiable(*out[4:])
        return out

    @staticmethod
    def backward(ctx, gT, g_center, g_normal, g_rgb, *_):
        xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix, valid = \
            ctx.saved_tensors
        args = (xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix, valid,
                gT, g_center, g_rgb, g_normal, ctx.has_offset)
        deg, mod = ctx.geom[:2]
        return (None,) + ctx.backward_form(*args, deg, mod) + (None,) * 4


# ---------------------------------------------------------------- plain forms
def _dot3(row, v):
    """row[0]·v[0] + row[1]·v[1] + row[2]·v[2], rounded left to right."""
    return row[0] * v[0] + row[1] * v[1] + row[2] * v[2]


def _geometry(xyz, scaling, rotation_raw, w2c, world2pix, mod):
    """The forward chain up to T, p_view and the normal's flip, one rounded
    torch op at a time in the kernel's order (`geometry` in preprocess.cu).
    Matrices are nested lists [row][column] of (P,) columns."""
    p = xyz.unbind(-1)
    s0, s1 = (scaling * mod).unbind(-1)
    qw, qx, qy, qz = rotation_raw.unbind(-1)
    qn = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz + EPS_SQ)
    w, x, y, z = qw / qn, qx / qn, qy / qn, qz / qn
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    ax_u = [R[j][0] * s0 for j in range(3)]
    ax_v = [R[j][1] * s1 for j in range(3)]
    M = world2pix
    T = [[_dot3(M[i], ax_u), _dot3(M[i], ax_v), _dot3(M[i], p) + M[i, 3]] for i in range(3)]
    Rw, tw = w2c[:3, :3], w2c[:3, 3]
    pv = [_dot3(Rw[j], p) + tw[j] for j in range(3)]
    nv = [_dot3(Rw[j], [R[0][2], R[1][2], R[2][2]]) for j in range(3)]
    facing = _dot3(pv, nv) < 0                      # cos = −p_view·n > 0: keep n
    return dict(p=p, s=(s0, s1), q=(w, x, y, z), qn=qn, R=R, T=T, pv=pv, nv=nv,
                facing=facing)


def _conic(T):
    """dist, ok and 1/dist (1 where not ok) of the dual conic; its factors
    f = (9, 9, −1)/dist are (fu, fu, −inv)."""
    Tw = T[2]
    c2 = CUTOFF * CUTOFF
    dist = Tw[0] * Tw[0] * c2 + Tw[1] * Tw[1] * c2 - Tw[2] * Tw[2]
    ok = dist.abs() > 1e-12
    inv = torch.where(ok, dist, 1.0).reciprocal()
    return ok, inv, (inv * c2, inv * c2, -inv)


def _camera_center(w2c):
    """−R_w2cᵀ t_w2c, column by column (no Camera.c2w)."""
    Rw, tw = w2c[:3, :3], w2c[:3, 3]
    return torch.stack([-_dot3([Rw[0, k], Rw[1, k], Rw[2, k]], tw) for k in range(3)])


def _sh_basis(degree: int, d: torch.Tensor):
    """The real SH basis (P, nb) at unit directions d (P, 3), and its
    derivative by d (P, nb, 3) (forward.cu:20-71, sh.eval_sh's terms)."""
    x, y, z = d.unbind(-1)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows = [(sh_lib.C0 * one, (zero, zero, zero))]
    if degree >= 1:
        C1 = sh_lib.C1
        rows += [(-C1 * y, (zero, -C1 * one, zero)), (C1 * z, (zero, zero, C1 * one)),
                 (-C1 * x, (-C1 * one, zero, zero))]
    if degree >= 2:
        C2 = sh_lib.C2
        xx, yy, zz = x * x, y * y, z * z
        rows += [(C2[0] * x * y, (C2[0] * y, C2[0] * x, zero)),
                 (C2[1] * y * z, (zero, C2[1] * z, C2[1] * y)),
                 (C2[2] * (2 * zz - xx - yy), (-2 * C2[2] * x, -2 * C2[2] * y, 4 * C2[2] * z)),
                 (C2[3] * x * z, (C2[3] * z, zero, C2[3] * x)),
                 (C2[4] * (xx - yy), (2 * C2[4] * x, -2 * C2[4] * y, zero))]
    if degree >= 3:
        C3 = sh_lib.C3
        rows += [
            (C3[0] * y * (3 * xx - yy), (C3[0] * 6 * x * y, C3[0] * 3 * (xx - yy), zero)),
            (C3[1] * x * y * z, (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y)),
            (C3[2] * y * (4 * zz - xx - yy),
             (-2 * C3[2] * x * y, C3[2] * (4 * zz - xx - 3 * yy), 8 * C3[2] * y * z)),
            (C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             (-6 * C3[3] * x * z, -6 * C3[3] * y * z, C3[3] * (6 * zz - 3 * xx - 3 * yy))),
            (C3[4] * x * (4 * zz - xx - yy),
             (C3[4] * (4 * zz - 3 * xx - yy), -2 * C3[4] * x * y, 8 * C3[4] * x * z)),
            (C3[5] * z * (xx - yy), (2 * C3[5] * x * z, -2 * C3[5] * y * z, C3[5] * (xx - yy))),
            (C3[6] * x * (xx - 3 * yy), (C3[6] * 3 * (xx - yy), -6 * C3[6] * x * y, zero)),
        ]
    basis = torch.stack([b for b, _ in rows], -1)
    dbasis = torch.stack([torch.stack(g, -1) for _, g in rows], -2)
    return basis, dbasis


def _sh_terms(xyz, f_dc, f_rest, w2c, degree):
    """(v, dirs, basis, dbasis, coeffs (P, nb, 3), eval) of the SH colour."""
    v = xyz - _camera_center(w2c)
    dirs = normalize(v)
    basis, dbasis = _sh_basis(degree, dirs)
    nb = basis.shape[1]
    coeffs = torch.cat([f_dc, f_rest[:, :nb - 1]], 1)
    return v, dirs, basis, dbasis, coeffs, torch.einsum("pb,pbc->pc", basis, coeffs)


def forward_plain(xyz, scaling, rotation_raw, f_dc, f_rest, colors, center_offset, opacity,
                  w2c, world2pix, sh_degree, scale_modifier, width, height):
    """The kernel's forward in torch ops: (T (P, 3, 3), center (P, 2), normal
    (P, 3), rgb (P, 3), radius (P,), depth (P,), valid (P,) bool)."""
    g = _geometry(xyz, scaling, rotation_raw, w2c, world2pix, scale_modifier)
    T, pv = g["T"], g["pv"]
    normal = torch.stack([torch.where(g["facing"], n, -n) for n in g["nv"]], -1)
    ok, _, f = _conic(T)
    Tu, Tv, Tw = T
    cx = f[0] * Tu[0] * Tw[0] + f[1] * Tu[1] * Tw[1] + f[2] * Tu[2] * Tw[2]
    cy = f[0] * Tv[0] * Tw[0] + f[1] * Tv[1] * Tw[1] + f[2] * Tv[2] * Tw[2]
    if center_offset is not None:
        cx = cx + center_offset[:, 0]
        cy = cy + center_offset[:, 1]
    hx = cx * cx - (f[0] * Tu[0] * Tu[0] + f[1] * Tu[1] * Tu[1] + f[2] * Tu[2] * Tu[2])
    hy = cy * cy - (f[0] * Tv[0] * Tv[0] + f[1] * Tv[1] * Tv[1] + f[2] * Tv[2] * Tv[2])
    radius = torch.ceil(torch.maximum(torch.sqrt(torch.clamp(hx, min=1e-4)),
                                      torch.sqrt(torch.clamp(hy, min=1e-4))))
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    rmin_x = float_to_int32((cx - radius) / TILE).clamp(0, gx)
    rmin_y = float_to_int32((cy - radius) / TILE).clamp(0, gy)
    rmax_x = float_to_int32((cx + radius + TILE - 1) / TILE).clamp(0, gx)
    rmax_y = float_to_int32((cy + radius + TILE - 1) / TILE).clamp(0, gy)
    nonempty = (rmax_x - rmin_x) * (rmax_y - rmin_y) > 0
    valid = (pv[2] >= NEAR_TEST) & ok & nonempty & (opacity >= ALPHA_EPS)
    if colors is None:
        ev = _sh_terms(xyz, f_dc, f_rest, w2c, sh_degree)[-1]
        rgb = torch.clamp(ev + 0.5, min=0.0)
    else:
        rgb = colors
    center = torch.where(valid[:, None], torch.stack([cx, cy], -1), 0.0)
    T = torch.stack([torch.stack(row, -1) for row in T], -2)
    return T, center, normal, rgb, torch.where(valid, radius, 0.0), pv[2], valid


def backward_plain(xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix, valid,
                   gT, g_center, g_rgb, g_normal, has_offset, sh_degree, scale_modifier):
    """The kernel's backward in torch: the gradients of (xyz, scaling,
    rotation_raw, f_dc, f_rest, colors, center_offset), None for colors or
    the offset where not given and for f_dc / f_rest where colors are."""
    g = _geometry(xyz, scaling, rotation_raw, w2c, world2pix, scale_modifier)
    T, R = g["T"], g["R"]
    Tu, Tv, Tw = T
    _, inv, f = _conic(T)
    gT = [[gT[:, i, k] for k in range(3)] for i in range(3)]
    # The centre (culled slots' centre is a constant 0) into T through the conic.
    gc = g_center * valid[:, None].to(g_center.dtype)
    gcx, gcy = gc.unbind(-1)
    c2 = CUTOFF * CUTOFF
    a = [gcx * Tu[k] + gcy * Tv[k] for k in range(3)]
    g_dist = -(a[0] * Tw[0] * f[0] + a[1] * Tw[1] * f[1] + a[2] * Tw[2] * f[2]) * inv
    for k, tmp in enumerate((c2, c2, -1.0)):
        gT[0][k] = gT[0][k] + gcx * f[k] * Tw[k]
        gT[1][k] = gT[1][k] + gcy * f[k] * Tw[k]
        gT[2][k] = gT[2][k] + f[k] * a[k] + g_dist * 2 * tmp * Tw[k]
    # T = M·S: S's columns are (s0·R[:, 0], 0), (s1·R[:, 1], 0), (xyz, 1).
    M = world2pix
    gS = [[_dot3([M[0, j], M[1, j], M[2, j]], [gT[0][k], gT[1][k], gT[2][k]])
           for k in range(3)] for j in range(3)]
    s0, s1 = g["s"]
    g_scaling = torch.stack([_dot3([gS[j][0] for j in range(3)], [R[j][0] for j in range(3)]),
                             _dot3([gS[j][1] for j in range(3)], [R[j][1] for j in range(3)])],
                            -1) * scale_modifier
    Rw = w2c[:3, :3]
    g_nv = [torch.where(g["facing"], g_normal[:, j], -g_normal[:, j]) for j in range(3)]
    gR = [[gS[j][0] * s0, gS[j][1] * s1, _dot3([Rw[0, j], Rw[1, j], Rw[2, j]], g_nv)]
          for j in range(3)]
    w, x, y, z = g["q"]
    gw = 2 * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2] - y * gR[2][0]
              + x * gR[2][1])
    gx = 2 * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] - 2 * x * gR[1][1] - w * gR[1][2]
              + z * gR[2][0] + w * gR[2][1] - 2 * x * gR[2][2])
    gy = 2 * (-2 * y * gR[0][0] + x * gR[0][1] + w * gR[0][2] + x * gR[1][0] + z * gR[1][2]
              - w * gR[2][0] + z * gR[2][1] - 2 * y * gR[2][2])
    gz = 2 * (-2 * z * gR[0][0] - w * gR[0][1] + x * gR[0][2] + w * gR[1][0] - 2 * z * gR[1][1]
              + y * gR[1][2] + x * gR[2][0] + y * gR[2][1])
    gq = torch.stack([gw, gx, gy, gz], -1)
    qu = torch.stack(g["q"], -1)
    g_rot = (gq - (gq * qu).sum(-1, keepdim=True) * qu) / g["qn"][:, None]
    g_xyz = torch.stack([gS[j][2] for j in range(3)], -1)
    g_offset = gc if has_offset else None
    if colors is not None:
        return g_xyz, g_scaling, g_rot, None, None, g_rgb, g_offset
    v, d, basis, dbasis, coeffs, ev = _sh_terms(xyz, f_dc, f_rest, w2c, sh_degree)
    g_ev = torch.where(ev + 0.5 >= 0, g_rgb, 0.0)           # clamp(min=0)'s backward
    g_coeffs = basis[:, :, None] * g_ev[:, None, :]
    nb = basis.shape[1]
    g_rest = torch.zeros_like(f_rest)
    g_rest[:, :nb - 1] = g_coeffs[:, 1:]
    g_d = torch.einsum("pbk,pbc,pc->pk", dbasis, coeffs, g_ev)
    rn = torch.rsqrt(torch.sum(v * v, -1, keepdim=True) + EPS_SQ)
    g_xyz = g_xyz + rn * (g_d - (g_d * d).sum(-1, keepdim=True) * d)
    return g_xyz, g_scaling, g_rot, g_coeffs[:, :1], g_rest, None, g_offset


# ------------------------------------------------------------------- kernels
def _lib():
    """The kernels' library, its ctypes signatures declared once."""
    from g4splat_torch.ops.cuda_build import load

    lib = load("preprocess")
    if not getattr(lib, "_g4_bound", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.g4_preprocess_fwd.argtypes = [P] * 10 + [I] * 3 + [F] + [I] * 2 + [P] * 8
        lib.g4_preprocess_bwd.argtypes = [P] * 9 + [P, I] * 4 + [I] * 3 + [F] + [P] * 8
        for fn in (lib.g4_preprocess_fwd, lib.g4_preprocess_bwd):
            fn.restype = ctypes.c_int
        lib._g4_bound = True
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _f32(name: str, t: torch.Tensor, shape: Tuple[int, ...], dev) -> torch.Tensor:
    """t as a contiguous float32 tensor of `shape` on `dev`, or raise."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"{name} must be {shape} float32 on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.detach().contiguous()


def _inputs(xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix):
    P, dev = xyz.shape[0], xyz.device
    K = f_rest.shape[1]
    if K > MAX_REST:
        raise ValueError(f"the kernels take at most {MAX_REST} SH bands in f_rest, got {K}")
    ins = [_f32("xyz", xyz, (P, 3), dev), _f32("scaling", scaling, (P, 2), dev),
           _f32("rotation_raw", rotation_raw, (P, 4), dev), _f32("f_dc", f_dc, (P, 1, 3), dev),
           _f32("f_rest", f_rest, (P, K, 3), dev),
           None if colors is None else _f32("colors", colors, (P, 3), dev),
           _f32("w2c", w2c, (4, 4), dev), _f32("world2pix", world2pix, (3, 4), dev)]
    return P, K, dev, ins


def forward_cuda(xyz, scaling, rotation_raw, f_dc, f_rest, colors, center_offset, opacity,
                 w2c, world2pix, sh_degree, scale_modifier, width, height):
    """The forward kernel; returns what `forward_plain` returns."""
    P, K, dev, ins = _inputs(xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix)
    x, s, q, dc, rest, col, w2c_, M = ins
    opa = _f32("opacity", opacity, (P,), dev)
    off = None if center_offset is None else _f32("center_offset", center_offset, (P, 2), dev)
    T = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    center = torch.empty((P, 2), dtype=torch.float32, device=dev)
    normal = torch.empty((P, 3), dtype=torch.float32, device=dev)
    rgb = torch.empty((P, 3), dtype=torch.float32, device=dev)
    radius = torch.empty(P, dtype=torch.float32, device=dev)
    depth = torch.empty(P, dtype=torch.float32, device=dev)
    valid = torch.empty(P, dtype=torch.bool, device=dev)
    gx = (width + TILE - 1) // TILE
    gy = (height + TILE - 1) // TILE
    outs = (T, center, normal, rgb, radius, depth, valid)
    with torch.cuda.device(dev):
        err = _lib().g4_preprocess_fwd(
            x.data_ptr(), s.data_ptr(), q.data_ptr(), opa.data_ptr(), dc.data_ptr(),
            rest.data_ptr(), _ptr(col), _ptr(off), w2c_.data_ptr(), M.data_ptr(), P, K,
            int(sh_degree), float(scale_modifier), gx, gy, *(t.data_ptr() for t in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess_fwd launch failed: CUDA error {err}")
    PREPROCESS_FWD.count_launch()
    return outs


def _rows(name: str, t: torch.Tensor, P: int, width: int):
    """A cotangent as (P, width) float32 rows of unit inner stride (a view
    where it is one: B2's gradient table hands out column slices), and its
    row stride."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    r = t.reshape(P, width)
    if r.stride(1) != 1 and width > 1:
        r = r.contiguous()
    return r, r.stride(0)


def backward_cuda(xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix, valid,
                  gT, g_center, g_rgb, g_normal, has_offset, sh_degree, scale_modifier):
    """The backward kernel; returns what `backward_plain` returns."""
    P, K, dev, ins = _inputs(xyz, scaling, rotation_raw, f_dc, f_rest, colors, w2c, world2pix)
    x, s, q, dc, rest, col, w2c_, M = ins
    cots = [_rows(n, t, P, w) for n, t, w in (("gT", gT, 9), ("g_center", g_center, 2),
                                              ("g_rgb", g_rgb, 3), ("g_normal", g_normal, 3))]
    outs = [torch.empty((P, 3), dtype=torch.float32, device=dev),
            torch.empty((P, 2), dtype=torch.float32, device=dev),
            torch.empty((P, 4), dtype=torch.float32, device=dev),
            None if colors is not None else torch.empty((P, 1, 3), dtype=torch.float32,
                                                        device=dev),
            None if colors is not None else torch.empty((P, K, 3), dtype=torch.float32,
                                                        device=dev),
            None if colors is None else torch.empty((P, 3), dtype=torch.float32, device=dev),
            torch.empty((P, 2), dtype=torch.float32, device=dev) if has_offset else None]
    with torch.cuda.device(dev):
        err = _lib().g4_preprocess_bwd(
            x.data_ptr(), s.data_ptr(), q.data_ptr(), dc.data_ptr(), rest.data_ptr(),
            _ptr(col), valid.contiguous().data_ptr(), w2c_.data_ptr(), M.data_ptr(),
            *(v for r, stride in cots for v in (r.data_ptr(), stride)), P, K,
            int(sh_degree), float(scale_modifier), *(_ptr(t) for t in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"preprocess_bwd launch failed: CUDA error {err}")
    PREPROCESS_BWD.count_launch()
    return tuple(outs)
