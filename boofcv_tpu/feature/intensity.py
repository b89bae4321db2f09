"""Corner/blob intensity images.

Reference analog: boofcv-feature alg/feature/detect/intensity/* —
FastCornerDetector.java:67 (FAST 9-12), HarrisCornerIntensity.java,
ShiTomasiCornerIntensity.java (structure tensor via ImplSsdCorner),
MedianCornerIntensity, HessianBlobIntensity, KitRosCornerIntensity.

Formulation: the FAST ring test becomes a 16-way shifted-compare with
a circular run-length test done bit-parallel over the whole image; the
structure-tensor detectors are two convs + elementwise eigen-math.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.core.border import BorderType, pad
from boofcv_tpu.ip import blur as _blur
from boofcv_tpu.ip import derivative as _deriv

# Bresenham circle of radius 3 — the FAST ring (FastCornerDetector uses
# the standard 16-pixel circle), clockwise from 12 o'clock.
_FAST_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
])


def _ring_stack(image: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] of ring-neighbor values (EXTENDED border)."""
    p = pad(image, 3, 3, BorderType.EXTENDED)
    h, w = image.shape
    return jnp.stack([p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                      for dx, dy in _FAST_RING], axis=0)


def fast(image: jnp.ndarray, pixel_tol: float = 20.0, min_continuous: int = 9):
    """FAST corner intensity (FastCornerDetector.java).

    Returns (intensity, is_corner): intensity = sum of |ring - center| over
    contributing pixels (matching the reference's score), corner where a
    circular run of >= min_continuous ring pixels is all brighter (or all
    darker) than center +/- pixel_tol.
    """
    img = image.astype(jnp.float32)
    ring = _ring_stack(img)  # [16, H, W]
    center = img[None]
    brighter = ring > center + pixel_tol  # [16, H, W]
    darker = ring < center - pixel_tol

    def max_circular_run(mask):
        # doubled-ring trick: max run length in circular 16 = max run in 32
        m = jnp.concatenate([mask, mask], axis=0).astype(jnp.int32)
        run = jnp.zeros_like(m[0])
        best = jnp.zeros_like(m[0])
        for i in range(32):
            run = jnp.where(m[i] > 0, run + 1, 0)
            best = jnp.maximum(best, run)
        return jnp.minimum(best, 16)

    run_b = max_circular_run(brighter)
    run_d = max_circular_run(darker)
    corner = (run_b >= min_continuous) | (run_d >= min_continuous)
    diff = jnp.abs(ring - center) - pixel_tol
    score_b = jnp.sum(jnp.where(brighter, diff, 0.0), axis=0)
    score_d = jnp.sum(jnp.where(darker, diff, 0.0), axis=0)
    intensity = jnp.where(corner, jnp.maximum(score_b, score_d), 0.0)
    return intensity, corner


def _structure_tensor(image: jnp.ndarray, radius: int = 2, weighted: bool = False):
    """Sums of (dx^2, dxy, dy^2) over a (2r+1) window (ImplSsdCorner)."""
    dx, dy = _deriv.sobel(image)
    xx, xy, yy = dx * dx, dx * dy, dy * dy
    if weighted:
        sxx = _blur.gaussian(xx, radius=radius, border=BorderType.EXTENDED)
        sxy = _blur.gaussian(xy, radius=radius, border=BorderType.EXTENDED)
        syy = _blur.gaussian(yy, radius=radius, border=BorderType.EXTENDED)
    else:
        # one depthwise separable box filter over the stacked (xx, xy, yy)
        # channels: 6 single-channel convs -> 2 grouped convs
        from jax import lax as _lax
        from boofcv_tpu.ip import convolve
        n = 2 * radius + 1
        stack = jnp.stack([xx, xy, yy])                      # [3, H, W]
        padded = jnp.stack([convolve.pad(c, radius, radius,
                                         BorderType.EXTENDED)
                            for c in stack])[None]           # [1, 3, H', W']
        kh = jnp.ones((3, 1, 1, n), jnp.float32)
        kv = jnp.ones((3, 1, n, 1), jnp.float32)
        t = _lax.conv_general_dilated(
            padded, kh, (1, 1), "VALID", feature_group_count=3,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=_lax.Precision.HIGHEST)
        t = _lax.conv_general_dilated(
            t, kv, (1, 1), "VALID", feature_group_count=3,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=_lax.Precision.HIGHEST)
        sxx, sxy, syy = t[0, 0], t[0, 1], t[0, 2]
    return sxx, sxy, syy


def shi_tomasi(image: jnp.ndarray, radius: int = 2, weighted: bool = False):
    """Shi-Tomasi min-eigenvalue intensity (ShiTomasiCornerIntensity.java)."""
    sxx, sxy, syy = _structure_tensor(image, radius, weighted)
    tr_half = (sxx + syy) * 0.5
    det_part = jnp.sqrt(jnp.maximum(tr_half * tr_half - (sxx * syy - sxy * sxy), 0.0))
    return tr_half - det_part


def harris(image: jnp.ndarray, radius: int = 2, kappa: float = 0.04,
           weighted: bool = False):
    """Harris corner response det - kappa*tr^2 (HarrisCornerIntensity.java)."""
    sxx, sxy, syy = _structure_tensor(image, radius, weighted)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - kappa * tr * tr


def kitros(image: jnp.ndarray):
    """Kitchen-Rosenfeld corner intensity (KitRosCornerIntensity.java)."""
    dx, dy = _deriv.sobel(image)
    dxx, dyy, dxy = _deriv.hessian_from_gradient(dx, dy)
    num = dxx * dy * dy + dyy * dx * dx - 2.0 * dxy * dx * dy
    den = dx * dx + dy * dy
    return jnp.where(den > 0, num / den, 0.0)


def hessian_det(image: jnp.ndarray):
    """Hessian-determinant blob intensity (HessianBlobIntensity.DETERMINANT)."""
    dxx, dyy, dxy = _deriv.hessian_three(image)
    return dxx * dyy - dxy * dxy


def hessian_trace(image: jnp.ndarray):
    """Laplacian-trace blob intensity (HessianBlobIntensity.TRACE)."""
    dxx, dyy, _ = _deriv.hessian_three(image)
    return jnp.abs(dxx + dyy)


def median_intensity(image: jnp.ndarray, radius: int = 2):
    """|I - median(I)| (MedianCornerIntensity.java)."""
    med = _blur.median(image.astype(jnp.float32), radius)
    return jnp.abs(image - med)
