"""Rotation / quaternion / projective transform utilities.

Conventions (shared with `g4splat_tpu.core.transforms`):

- Quaternions are ``(w, x, y, z)``, matching the reference PLY schema.
- Matrices are column-vector convention: ``p' = M @ p``.
- Functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`, gradient-safe at zero: rsqrt(Σv² + eps²)."""
    return v * torch.rsqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps * eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz quaternion → (…, 3, 3) rotation matrix (normalizes `q`)."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return rot.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) rotation matrix → (…, 4) wxyz unit quaternion with w >= 0.

    Branch-free Shepperd extraction: all four candidate quaternions, the one
    whose dominant component is largest kept (ties to the first, as JAX's
    argmax)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = torch.clamp(1 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1 - m00 - m11 + m22, min=0.0)
    cand = torch.stack(
        [
            torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
        ],
        dim=-2,
    )                                                   # (…, 4 candidates, 4)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 4)))
    q = normalize(q.squeeze(-2))
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions (broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def homogenize(p: torch.Tensor) -> torch.Tensor:
    """(…, 3) → (…, 4) with a trailing 1."""
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def transform_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A 4x4 column-vector transform's affine part applied to (…, 3) points."""
    return p @ m[:3, :3].T + m[:3, 3]


def project_points(m: torch.Tensor, p: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """A 4x4 projective transform applied to (…, 3) points, with the w-divide."""
    ph = homogenize(p) @ m.T
    return ph[..., :3] / (ph[..., 3:4] + eps)
