"""Real spherical harmonics (degree ≤ 3) for view-dependent color.

Same basis and constants as the reference rasterizer's `computeColorFromSH`
(diff-surfel-rasterization/cuda_rasterizer/forward.cu:20-71).
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH color before the +0.5 shift / clamp.

    coeffs: (..., K, C) with K >= (degree+1)^2; dirs: (..., 3) unit vectors.
    Returns (..., C).
    """
    result = C0 * coeffs[..., 0, :]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (
            result
            - C1 * y * coeffs[..., 1, :]
            + C1 * z * coeffs[..., 2, :]
            - C1 * x * coeffs[..., 3, :]
        )
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * coeffs[..., 4, :]
                + C2[1] * yz * coeffs[..., 5, :]
                + C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
                + C2[3] * xz * coeffs[..., 7, :]
                + C2[4] * (xx - yy) * coeffs[..., 8, :]
            )
            if degree >= 3:
                result = (
                    result
                    + C3[0] * y * (3.0 * xx - yy) * coeffs[..., 9, :]
                    + C3[1] * xy * z * coeffs[..., 10, :]
                    + C3[2] * y * (4.0 * zz - xx - yy) * coeffs[..., 11, :]
                    + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeffs[..., 12, :]
                    + C3[4] * x * (4.0 * zz - xx - yy) * coeffs[..., 13, :]
                    + C3[5] * z * (xx - yy) * coeffs[..., 14, :]
                    + C3[6] * x * (xx - 3.0 * yy) * coeffs[..., 15, :]
                )
    return result


def sh_to_rgb(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH → RGB with the +0.5 shift and clamp-to-positive (forward.cu:63-70)."""
    return torch.clamp(eval_sh(degree, coeffs, dirs) + 0.5, min=0.0)


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term: color → degree-0 coefficient."""
    return (rgb - 0.5) / C0
