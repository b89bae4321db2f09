"""Feature descriptors: SURF-64, BRIEF, NCC template.

Reference analog: boofcv-feature alg/feature/describe/DescribePointSurf
.java:67,169,235 (4x4 grid x 5x5 samples of Haar dx,dy -> 64-D),
DescribePointBrief.java (random-pair binary), DescribePointPixelRegionNCC
.java, plus orientation estimation alg/feature/orientation/*.

Design: every descriptor is a batched gather + reduction over all N
keypoints at once; BRIEF bit-packs with shifts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.ip import integral as ii_ops
from boofcv_tpu.ip.interpolate import bilinear


# ---------------- orientation (SURF average-gradient style) -------------

def orientation_average_haar(ii: jnp.ndarray, ys, xs, scales,
                             radius: int = 6) -> jnp.ndarray:
    """Average Haar-response orientation inside a radius-6s disc
    (OrientationAverageIntegral analog).  Returns angle [N] in radians."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]
    offs = np.array(offs)  # [M, 2]
    sum_dx = 0.0
    sum_dy = 0.0
    for dy, dx in offs:
        py = jnp.round(ys + dy * scales).astype(jnp.int32)
        px = jnp.round(xs + dx * scales).astype(jnp.int32)
        r = jnp.maximum(jnp.round(2 * scales).astype(jnp.int32), 1)
        gx = ii_ops.haar_x(ii, py, px, r)
        gy = ii_ops.haar_y(ii, py, px, r)
        w = math.exp(-0.5 * (dy * dy + dx * dx) / (radius * radius / 4.0))
        sum_dx = sum_dx + gx * w
        sum_dy = sum_dy + gy * w
    return jnp.arctan2(sum_dy, sum_dx)


# ---------------- SURF-64 ------------------------------------------------

def surf(ii: jnp.ndarray, ys, xs, scales, angles=None,
         widthLargeGrid: int = 4, widthSubRegion: int = 5) -> jnp.ndarray:
    """SURF-64 descriptor for N keypoints (DescribePointSurf.describe:169).

    4x4 subregions x 5x5 samples; per sample take Haar dx,dy (rotated),
    Gaussian-weighted; per subregion accumulate (sum dx, sum |dx|, sum dy,
    sum |dy|); L2-normalize the 64-vector.  angles=None => upright (U-SURF).
    """
    n = ys.shape[0]
    half = widthLargeGrid * widthSubRegion // 2  # 10 sample units
    # sample lattice in keypoint frame, centered
    u = np.arange(widthLargeGrid * widthSubRegion) - half + 0.5
    uu, vv = np.meshgrid(u, u, indexing="ij")   # [20, 20] (v=y, u=x)
    uu = jnp.asarray(uu.ravel(), dtype=jnp.float32)
    vv = jnp.asarray(vv.ravel(), dtype=jnp.float32)
    m = uu.shape[0]

    if angles is None:
        ca = jnp.ones_like(ys)
        sa = jnp.zeros_like(ys)
    else:
        ca = jnp.cos(angles)
        sa = jnp.sin(angles)

    s = jnp.asarray(scales, dtype=jnp.float32)
    # world offsets of each sample: rotate lattice, scale
    ox = (ca[:, None] * uu[None, :] - sa[:, None] * vv[None, :]) * s[:, None]
    oy = (sa[:, None] * uu[None, :] + ca[:, None] * vv[None, :]) * s[:, None]
    py = jnp.round(jnp.asarray(ys)[:, None] + oy).astype(jnp.int32)  # [N, M]
    px = jnp.round(jnp.asarray(xs)[:, None] + ox).astype(jnp.int32)

    r = jnp.maximum(jnp.round(s).astype(jnp.int32), 1)[:, None]
    gx = ii_ops.haar_x(ii, py, px, r)  # [N, M]
    gy = ii_ops.haar_y(ii, py, px, r)
    # rotate gradients into keypoint frame
    rgx = ca[:, None] * gx + sa[:, None] * gy
    rgy = -sa[:, None] * gx + ca[:, None] * gy

    # gaussian weight over the whole grid (sigma = 0.4 * grid half width ~ SURF's 3.3s)
    sigma = half * 0.84
    wgt = jnp.exp(-0.5 * (uu ** 2 + vv ** 2) / (sigma * sigma))[None, :]
    rgx = rgx * wgt
    rgy = rgy * wgt

    # accumulate into 4x4 cells
    side = widthLargeGrid * widthSubRegion
    cell = (jnp.arange(side) // widthSubRegion)
    cv, cu = jnp.meshgrid(cell, cell, indexing="ij")
    cell_id = (cv * widthLargeGrid + cu).ravel()  # [M]
    ncell = widthLargeGrid * widthLargeGrid
    onehot = (cell_id[None, :] == jnp.arange(ncell)[:, None]).astype(jnp.float32)  # [16, M]

    f_dx = jnp.einsum("cm,nm->nc", onehot, rgx)
    f_adx = jnp.einsum("cm,nm->nc", onehot, jnp.abs(rgx))
    f_dy = jnp.einsum("cm,nm->nc", onehot, rgy)
    f_ady = jnp.einsum("cm,nm->nc", onehot, jnp.abs(rgy))
    desc = jnp.stack([f_dx, f_adx, f_dy, f_ady], axis=-1).reshape(n, ncell * 4)
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True)
    return desc / jnp.maximum(norm, 1e-12)


# ---------------- BRIEF --------------------------------------------------

class BriefDefinition(NamedTuple):
    """Random point pairs (DescribePointBrief's BinaryCompareDefinition)."""
    ay: jnp.ndarray  # [B]
    ax: jnp.ndarray
    by: jnp.ndarray
    bx: jnp.ndarray


def brief_definition(num_bits: int = 512, radius: int = 16,
                     seed: int = 9898) -> BriefDefinition:
    """Gaussian-sampled pairs inside the patch (FactoryDescribePointAlgs
    .brief defaults: 512 bits, radius 16, gaussian sigma r/2)."""
    rng = np.random.default_rng(seed)
    sigma = radius / 2.0
    pts = rng.normal(0, sigma, size=(num_bits, 4))
    pts = np.clip(pts, -radius, radius)
    return BriefDefinition(*(jnp.asarray(pts[:, i], dtype=jnp.float32) for i in range(4)))


def brief(image_blurred: jnp.ndarray, ys, xs,
          definition: BriefDefinition) -> jnp.ndarray:
    """BRIEF binary descriptor, packed into int32 words [N, B/32].

    The reference blurs with a Gaussian first (DescribePointBrief takes a
    blurred image); pass that in.
    """
    ys = jnp.asarray(ys, dtype=jnp.float32)
    xs = jnp.asarray(xs, dtype=jnp.float32)
    va = bilinear(image_blurred, ys[:, None] + definition.ay[None, :],
                  xs[:, None] + definition.ax[None, :])
    vb = bilinear(image_blurred, ys[:, None] + definition.by[None, :],
                  xs[:, None] + definition.bx[None, :])
    bits = (va < vb).astype(jnp.int32)  # [N, B]
    n, b = bits.shape
    words = bits.reshape(n, b // 32, 32)
    shifts = jnp.arange(32, dtype=jnp.int32)
    return jnp.sum(words << shifts[None, None, :], axis=-1)


# ---------------- NCC template -------------------------------------------

def ncc_template(image: jnp.ndarray, ys, xs, radius: int = 5) -> jnp.ndarray:
    """Zero-mean unit-variance patch descriptor [N, (2r+1)^2]
    (DescribePointPixelRegionNCC analog)."""
    from boofcv_tpu.ip.interpolate import sample_rect_bilinear
    patches = sample_rect_bilinear(image, jnp.asarray(ys, jnp.float32),
                                   jnp.asarray(xs, jnp.float32), radius)
    n = patches.shape[0]
    flat = patches.reshape(n, -1)
    mu = jnp.mean(flat, axis=1, keepdims=True)
    sd = jnp.std(flat, axis=1, keepdims=True)
    return (flat - mu) / jnp.maximum(sd, 1e-8)
