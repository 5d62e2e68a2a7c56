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
