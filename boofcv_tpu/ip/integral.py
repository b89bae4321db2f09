"""Integral images (reference analog: boofcv-ip alg/transform/ii/*).

BoofCV convention (IntegralImageOps.transform / ImplIntegralImageOps.java):
``II[y, x] = sum of I over rows 0..y, cols 0..x`` *inclusive* — so II has
the same shape as I and block sums use the exclusive corner trick with
clamped negative indices.  Here: two cumsums (HBM-bandwidth bound, XLA
lowers cumsum to an efficient scan).

Haar/box feature evaluation is 4 gathers per corner — used by the SURF
detector/descriptor (boofcv-feature FastHessianFeatureDetector,
DescribePointSurf).
"""

from __future__ import annotations

import jax.numpy as jnp


def transform(image: jnp.ndarray) -> jnp.ndarray:
    """Inclusive 2D prefix sum, same shape as input."""
    return jnp.cumsum(jnp.cumsum(image.astype(jnp.float32), axis=0), axis=1)


def _sample(ii: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """II at (y, x), where y/x may be -1 (=> 0) and are clamped to the image.

    Implements the reference's implicit zero row/col above/left of the image.
    """
    h, w = ii.shape
    yc = jnp.clip(y, 0, h - 1)
    xc = jnp.clip(x, 0, w - 1)
    vals = ii[yc, xc]
    valid = (y >= 0) & (x >= 0)
    return jnp.where(valid, vals, 0.0)


def block_sum(ii: jnp.ndarray, x0, y0, x1, y1) -> jnp.ndarray:
    """Sum of pixels in the inclusive rectangle [x0..x1] x [y0..y1].

    Matches IntegralImageOps.block_zero semantics (corners exclusive on the
    low side).  All of x0/y0/x1/y1 may be arrays (broadcast) — one fused
    gather expression per corner.
    """
    x0 = jnp.asarray(x0) - 1
    y0 = jnp.asarray(y0) - 1
    br = _sample(ii, y1, x1)
    tl = _sample(ii, y0, x0)
    tr = _sample(ii, y0, x1)
    bl = _sample(ii, y1, x0)
    return br + tl - tr - bl


def _shift_static(ii: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """II sampled at (y+dy, x+dx) for EVERY pixel with _sample's border
    semantics (implicit zeros above/left, clamp below/right) — pure
    pad+slice.  The gather formulation (ii[yc, xc] with full [H, W]
    index grids) serialized on the first target; static shifts compile
    to copies."""
    h, w = ii.shape
    if dy >= 0:
        out = jnp.pad(ii, ((0, dy), (0, 0)), mode="edge")[dy:dy + h]
    else:
        out = jnp.pad(ii, ((-dy, 0), (0, 0)))[:h]
    if dx >= 0:
        out = jnp.pad(out, ((0, 0), (0, dx)), mode="edge")[:, dx:dx + w]
    else:
        out = jnp.pad(out, ((0, 0), (-dx, 0)))[:, :w]
    return out


def block_sum_grid(ii: jnp.ndarray, x0: int, y0: int, x1: int,
                   y1: int) -> jnp.ndarray:
    """block_sum evaluated at every pixel: corner coordinates are STATIC
    offsets relative to the pixel (x0..y1 ints).  Returns [H, W]."""
    br = _shift_static(ii, y1, x1)
    tl = _shift_static(ii, y0 - 1, x0 - 1)
    tr = _shift_static(ii, y0 - 1, x1)
    bl = _shift_static(ii, y1, x0 - 1)
    return br + tl - tr - bl


def deriv_xx_grid(ii: jnp.ndarray, size: int) -> jnp.ndarray:
    """Whole-image deriv_xx (same filter layout, static shifts)."""
    b = size // 3
    r = size // 2
    hy = (2 * b - 1) // 2
    total = block_sum_grid(ii, -r, -hy, r, hy)
    mid = block_sum_grid(ii, -(b // 2), -hy, -(b // 2) + b - 1, hy)
    return total - 3.0 * mid


def deriv_yy_grid(ii: jnp.ndarray, size: int) -> jnp.ndarray:
    b = size // 3
    r = size // 2
    hx = (2 * b - 1) // 2
    total = block_sum_grid(ii, -hx, -r, hx, r)
    mid = block_sum_grid(ii, -hx, -(b // 2), hx, -(b // 2) + b - 1)
    return total - 3.0 * mid


def deriv_xy_grid(ii: jnp.ndarray, size: int) -> jnp.ndarray:
    b = size // 3
    tl = block_sum_grid(ii, -b, -b, -1, -1)
    tr = block_sum_grid(ii, 1, -b, b, -1)
    bl = block_sum_grid(ii, -b, 1, -1, b)
    br = block_sum_grid(ii, 1, 1, b, b)
    return tl + br - tr - bl


def haar_x(ii: jnp.ndarray, cy, cx, radius) -> jnp.ndarray:
    """Haar x-wavelet response at center (cy, cx): right half minus left half.

    Matches DerivativeIntegralImage.kernelHaarX region layout.
    """
    r = radius
    right = block_sum(ii, cx, cy - r, cx + r - 1, cy + r - 1)
    left = block_sum(ii, cx - r, cy - r, cx - 1, cy + r - 1)
    return right - left


def haar_y(ii: jnp.ndarray, cy, cx, radius) -> jnp.ndarray:
    r = radius
    bottom = block_sum(ii, cx - r, cy, cx + r - 1, cy + r - 1)
    top = block_sum(ii, cx - r, cy - r, cx + r - 1, cy - 1)
    return bottom - top


def deriv_xx(ii: jnp.ndarray, cy, cx, size) -> jnp.ndarray:
    """Approximate d^2/dx^2 box filter as used by SURF's Fast Hessian
    (DerivativeIntegralImage.kernelDerivXX, size = block size, e.g. 9).

    Layout: 3 vertical bands of width size/3, middle weighted -2.
    """
    b = size // 3                     # lobe width
    r = size // 2
    hy = (2 * b - 1) // 2             # lobe height is 2b-1 centered at cy
    total = block_sum(ii, cx - r, cy - hy, cx + r, cy + hy)
    mid = block_sum(ii, cx - b // 2, cy - hy, cx - b // 2 + b - 1, cy + hy)
    return total - 3.0 * mid


def deriv_yy(ii: jnp.ndarray, cy, cx, size) -> jnp.ndarray:
    b = size // 3
    r = size // 2
    hx = (2 * b - 1) // 2
    total = block_sum(ii, cx - hx, cy - r, cx + hx, cy + r)
    mid = block_sum(ii, cx - hx, cy - b // 2, cx + hx, cy - b // 2 + b - 1)
    return total - 3.0 * mid


def deriv_xy(ii: jnp.ndarray, cy, cx, size) -> jnp.ndarray:
    """d^2/dxdy box filter: four b x b blocks in the quadrants."""
    b = size // 3
    tl = block_sum(ii, cx - b, cy - b, cx - 1, cy - 1)
    tr = block_sum(ii, cx + 1, cy - b, cx + b, cy - 1)
    bl = block_sum(ii, cx - b, cy + 1, cx - 1, cy + b)
    br = block_sum(ii, cx + 1, cy + 1, cx + b, cy + b)
    return tl + br - tr - bl
