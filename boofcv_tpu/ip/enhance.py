"""Image enhancement (reference analog: boofcv-ip alg/enhance/EnhanceImageOps.java).

Histogram equalization (global and local-window), sharpen-4/8.
"""

from __future__ import annotations

import jax.numpy as jnp

from boofcv_tpu.core.border import BorderType
from boofcv_tpu.ip import convolve, pixel_math as pm


def equalize_histogram(image: jnp.ndarray, max_value: int = 255) -> jnp.ndarray:
    """Global histogram equalization on integer-valued images
    (EnhanceImageOps.equalize + applyTransform)."""
    n = max_value + 1
    idx = jnp.clip(image.astype(jnp.int32), 0, max_value)
    hist = jnp.bincount(idx.ravel(), length=n)
    cdf = jnp.cumsum(hist)
    total = cdf[-1]
    lut = (cdf * max_value) // jnp.maximum(total, 1)
    return lut[idx].astype(image.dtype)


def equalize_local(image: jnp.ndarray, radius: int, max_value: int = 255) -> jnp.ndarray:
    """Local histogram equalization (EnhanceImageOps.equalizeLocal).

    Formulation: per-pixel rank transform — output = (count of window
    pixels <= center) scaled.  Equivalent to local CDF evaluated at the
    center pixel; computed with a windowed comparison sum.
    """
    r = radius
    from boofcv_tpu.core.border import pad
    padded = pad(image, r, r, BorderType.EXTENDED)
    h, w = image.shape
    nwin = (2 * r + 1) ** 2
    count = jnp.zeros((h, w), dtype=jnp.int32)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            count = count + (padded[dy:dy + h, dx:dx + w] <= image).astype(jnp.int32)
    return ((count * max_value) // nwin).astype(image.dtype)


_SHARPEN4 = jnp.array([[0, -1, 0],
                       [-1, 5, -1],
                       [0, -1, 0]], dtype=jnp.float32)
_SHARPEN8 = jnp.array([[-1, -1, -1],
                       [-1, 9, -1],
                       [-1, -1, -1]], dtype=jnp.float32)


def sharpen4(image: jnp.ndarray, lo: float = 0.0, hi: float = 255.0) -> jnp.ndarray:
    out = convolve.convolve2d(image.astype(jnp.float32), _SHARPEN4, BorderType.EXTENDED)
    return jnp.clip(out, lo, hi)


def sharpen8(image: jnp.ndarray, lo: float = 0.0, hi: float = 255.0) -> jnp.ndarray:
    out = convolve.convolve2d(image.astype(jnp.float32), _SHARPEN8, BorderType.EXTENDED)
    return jnp.clip(out, lo, hi)
