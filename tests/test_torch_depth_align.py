"""Parity of `g4splat_torch.ops.depth_align` with `g4splat_tpu.ops.depth_align`
on the CPU: the same seeded numpy inputs through both; aligned depths within
REL (1e-5) relative, the fitted (alpha, beta) within FIT_REL (1e-4) relative
(fp32 sums taken in another order, and the normal equations' denominator
Σw·s² − (Σw·s)²/Σw cancels); the RANSAC fit (the same `default_rng` draws,
host numpy on both sides) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g4splat_tpu.ops.depth_align as J
import g4splat_torch.ops.depth_align as T
from g4splat_torch.convert import camera_from
from g4splat_tpu.core.cameras import lookat_camera

REL = 1e-5
FIT_REL = 1e-4


def maps(seed, H=24, W=32):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 4.0, (H, W)).astype(np.float32)
    disp = (0.3 + 0.7 / depth + rng.normal(0, 0.01, (H, W))).astype(np.float32)
    mask = rng.uniform(size=(H, W)) > 0.3
    return disp, depth, mask


def close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-12), np.abs(a - b).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_fit(seed):
    rng = np.random.default_rng(seed)
    s, t = rng.normal(size=500).astype(np.float32), rng.normal(size=500).astype(np.float32)
    w = (rng.uniform(size=500) > 0.2).astype(np.float32)
    ja, jb = J.affine_fit(jnp.asarray(s), jnp.asarray(t), jnp.asarray(w))
    ta, tb = T.affine_fit(*(torch.from_numpy(x) for x in (s, t, w)))
    close(ja, ta, FIT_REL)
    close(jb, tb, FIT_REL)


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_linear_align(seed):
    disp, depth, mask = maps(seed)
    j = J.depth_linear_align(jnp.asarray(disp), jnp.asarray(depth), jnp.asarray(mask))
    t = T.depth_linear_align(torch.from_numpy(disp), torch.from_numpy(depth),
                             torch.from_numpy(mask))
    close(j[0], t[0])
    for a, b in zip(j[1:], t[1:]):
        close(a, b, FIT_REL)


def test_depth_space_and_fit_to_samples():
    disp, depth, mask = maps(3)
    j = J.depth_linear_align_depth_space(jnp.asarray(disp), jnp.asarray(depth),
                                         jnp.asarray(mask))
    t = T.depth_linear_align_depth_space(torch.from_numpy(disp), torch.from_numpy(depth),
                                         torch.from_numpy(mask))
    close(j[0], t[0])
    for a, b in zip(j[1:], t[1:]):
        close(a, b, FIT_REL)
    idx = np.arange(0, disp.size, 7)
    w = mask.reshape(-1)[idx].astype(np.float32)
    args = (disp, depth.reshape(-1)[idx], disp.reshape(-1)[idx], w)
    j = J.fit_disparity_to_depth(*(jnp.asarray(a) for a in args))
    t = T.fit_disparity_to_depth(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    close(j[0], t[0])
    for a, b in zip(j[1:], t[1:]):
        close(a, b, FIT_REL)


def test_ransac_same_draws():
    disp, depth, mask = maps(4)
    lin = (0.2 + 1.3 * depth).astype(np.float32)
    lin[::5, ::3] += 0.5                       # outliers
    j = J.depth_linear_align_ransac(depth, lin, mask)
    t = T.depth_linear_align_ransac(torch.from_numpy(depth), torch.from_numpy(lin),
                                    torch.from_numpy(mask))
    assert j[1:] == t[1:]
    np.testing.assert_array_equal(j[0], t[0])


def test_sample_disparity_at_points():
    disp, _, _ = maps(5)
    jc = lookat_camera([0.0, 0.0, -3.0], [0, 0, 0], [0, -1, 0], 30.0, 30.0, 32, 24)
    pts = np.random.default_rng(5).uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    j = J.sample_disparity_at_points(jnp.asarray(disp), jc, jnp.asarray(pts))
    t = T.sample_disparity_at_points(torch.from_numpy(disp), camera_from(jc, device="cpu"),
                                     torch.from_numpy(pts))
    close(j[0], t[0])
    np.testing.assert_array_equal(np.asarray(j[1]), t[1].numpy())
    close(j[2], t[2])
