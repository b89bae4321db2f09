"""Dense descriptors: HOG and dense SIFT grids.

Reference analog: boofcv-feature alg/feature/dense/ —
DescribeDenseHogAlg.java / DescribeDenseHogFastAlg (cell histograms +
block normalization), DescribeDenseSiftAlg (SIFT on a regular grid),
abst/feature/dense/DescribeImageDense.

Design: cell histograms = one one-hot-weighted reshape-sum over the
whole image (scatter-free); block normalization is a window-stack
concat + L2.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def hog(image, cell_size: int = 8, block_cells: int = 2,
        num_bins: int = 9, signed: bool = False):
    """HOG descriptor grid.

    Returns [BY, BX, block_cells*block_cells*num_bins] block descriptors
    (L2-normalized), BY = cells_y - block_cells + 1 etc.
    """
    img = jnp.asarray(image, jnp.float32)
    gy = jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0)
    gx = jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1)
    mag = jnp.hypot(gx, gy)
    period = 2 * np.pi if signed else np.pi
    ang = jnp.arctan2(gy, gx) % period
    h, w = img.shape
    cy = h // cell_size
    cx = w // cell_size
    mag = mag[: cy * cell_size, : cx * cell_size]
    ang = ang[: cy * cell_size, : cx * cell_size]
    # soft-assign into two adjacent orientation bins (standard HOG)
    pos = ang / period * num_bins - 0.5
    b0 = jnp.floor(pos).astype(jnp.int32) % num_bins
    b1 = (b0 + 1) % num_bins
    f = pos - jnp.floor(pos)
    onehot0 = jnp.eye(num_bins)[b0] * (mag * (1 - f))[..., None]
    onehot1 = jnp.eye(num_bins)[b1] * (mag * f)[..., None]
    votes = onehot0 + onehot1                    # [H, W, B]
    cells = votes.reshape(cy, cell_size, cx, cell_size, num_bins).sum((1, 3))
    # block normalization
    bc = block_cells
    by = cy - bc + 1
    bx = cx - bc + 1
    blocks = jnp.stack([
        cells[dy:dy + by, dx:dx + bx]
        for dy in range(bc) for dx in range(bc)], axis=2)   # [BY, BX, bc*bc, B]
    blocks = blocks.reshape(by, bx, bc * bc * num_bins)
    norm = jnp.linalg.norm(blocks, axis=-1, keepdims=True) + 1e-6
    return blocks / norm


def dense_sift(image, cell: int = 8, step: int = 8, max_side: int = 64):
    """SIFT descriptors on a regular grid (DescribeDenseSiftAlg).

    Returns (ys [N], xs [N], descriptors [N, 128]).
    """
    from boofcv_tpu.feature import sift as sift_mod
    img = jnp.asarray(image, jnp.float32)
    h, w = img.shape
    margin = 2 * cell
    gy = np.arange(margin, h - margin, step)
    gx = np.arange(margin, w - margin, step)
    yy, xx = np.meshgrid(gy, gx, indexing="ij")
    ys = jnp.asarray(yy.ravel(), jnp.float32)
    xs = jnp.asarray(xx.ravel(), jnp.float32)
    sig = jnp.full_like(ys, 1.6)
    ang = jnp.zeros_like(ys)          # upright dense SIFT
    desc = sift_mod.describe(img, ys, xs, sig, ang, width_sub=cell // 2)
    return ys, xs, desc
