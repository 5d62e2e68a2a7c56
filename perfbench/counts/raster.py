"""Work of the surfel rasterizer's forward (B1) and backward (B2) passes,
counted from the inputs and not from any implementation.

The pairs are the (pixel, splat) pairs the exact front-to-back rule
composites on these inputs: alpha ≥ 1/255, before the splat that takes the
transmittance under 1e-4. `perfbench.reference.surfel.render` counts them
(`n_pairs`). The operations per pair are those of the formula:

forward, per pair (58; 74 with the distortion channel):
  k = x·Tw − Tu and l = y·Tw − Tv: 12; their cross product: 9; the two
  divisions giving (u, v): 2; u² + v²: 3; the low-pass distance 2·(dx² +
  dy²) with dx, dy: 6; the min: 1; the intersection depth: 4; alpha
  (scale, exp, × opacity, clamp): 4; the weight and the new transmittance:
  3; colour, normal and depth accumulation: 14; distortion (the NDC depth,
  the pair term, both moments): 16.
backward, per pair (125; 157 with distortion): the forward's intersection
  and alpha recomputed (41); the weight's cotangent from colour, normal and
  depth (14); the colour, normal and depth gradients (7); the alpha
  gradient through the transmittance suffix (10); through exp and the min
  (6); the cross product's and the divisions' vector-Jacobian product back
  to the three T rows (41); the centre's gradient (6); distortion adds 32.

Bytes: every splat parameter read once (T 9, centre 2, opacity 1, colour
3, normal 3: 72 bytes), the binned list (4 bytes an entry, 8 a tile), each
output map written once (colour 3, normal 3, depth, alpha, median depth,
and distortion: 9 or 10 floats a pixel). The backward reads the splats, the
list, the maps and their cotangents, and writes 18 floats of gradient a
splat.
"""

from __future__ import annotations

from perfbench.counts.peaks import FP32_FLOPS, least_time

TILE = 16
FWD_OPS_PER_PAIR = 58
FWD_DIST_OPS_PER_PAIR = 16
BWD_OPS_PER_PAIR = 125
BWD_DIST_OPS_PER_PAIR = 32
SPLAT_BYTES = 72
GRAD_BYTES = 72


def _maps(width: int, height: int, dist: bool) -> int:
    return width * height * (10 if dist else 9)


def _tiles(width: int, height: int) -> int:
    return -(-width // TILE) * -(-height // TILE)


def b1_work(pairs: int, splats: int, entries: int, width: int, height: int, dist: bool):
    """(operations, bytes) of one forward pass."""
    ops = pairs * (FWD_OPS_PER_PAIR + (FWD_DIST_OPS_PER_PAIR if dist else 0))
    nbytes = (splats * SPLAT_BYTES + 4 * entries + 8 * _tiles(width, height)
              + 4 * _maps(width, height, dist))
    return ops, nbytes


def b2_work(pairs: int, splats: int, entries: int, width: int, height: int, dist: bool):
    """(operations, bytes) of one backward pass."""
    ops = pairs * (BWD_OPS_PER_PAIR + (BWD_DIST_OPS_PER_PAIR if dist else 0))
    nbytes = (splats * (SPLAT_BYTES + GRAD_BYTES) + 4 * entries + 8 * _tiles(width, height)
              + 2 * 4 * _maps(width, height, dist))
    return ops, nbytes


def b1_least_s(*args) -> float:
    return least_time(*b1_work(*args), FP32_FLOPS)


def b2_least_s(*args) -> float:
    return least_time(*b2_work(*args), FP32_FLOPS)
