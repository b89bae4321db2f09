"""Blur filters (reference analog: boofcv-ip alg/filter/blur/BlurImageOps.java).

Gaussian and mean as separable convolutions; median via a vectorized
sliding-window rank select (the reference's histogram median collapses to a
sort over the window axis — fully parallel elementwise).
"""

from __future__ import annotations

import jax.numpy as jnp

from boofcv_tpu.core.border import BorderType, pad
from boofcv_tpu.core.kernel import gaussian_kernel, mean_kernel
from boofcv_tpu.ip import convolve


def gaussian(image: jnp.ndarray, sigma: float = -1.0, radius: int = -1,
             border: BorderType = BorderType.NORMALIZED) -> jnp.ndarray:
    """Gaussian blur.  BoofCV BlurImageOps.gaussian uses renormalized edges."""
    k = gaussian_kernel(sigma, radius, dtype=image.dtype if jnp.issubdtype(image.dtype, jnp.floating) else jnp.float32)
    img = image.astype(k.dtype)
    return convolve.separable(img, k, k, border)


def mean(image: jnp.ndarray, radius: int,
         border: BorderType = BorderType.NORMALIZED) -> jnp.ndarray:
    """Box blur (BlurImageOps.mean)."""
    k = mean_kernel(radius, dtype=jnp.float32)
    return convolve.separable(image.astype(jnp.float32), k, k, border)


def median(image: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Median filter (BlurImageOps.median) with EXTENDED border.

    Gathers the (2r+1)^2 window per pixel and takes the middle order
    statistic — O(w^2 log w) elementwise sort, no data-dependent control flow.
    """
    r = radius
    padded = pad(image, r, r, BorderType.EXTENDED)
    h, w = image.shape
    n = 2 * r + 1
    windows = jnp.stack(
        [padded[dy:dy + h, dx:dx + w] for dy in range(n) for dx in range(n)],
        axis=-1,
    )  # [H, W, n*n]
    return jnp.sort(windows, axis=-1)[..., (n * n) // 2]
