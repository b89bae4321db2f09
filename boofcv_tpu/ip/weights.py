"""Spatial weight functions (kernels for mean-shift, SSD corners, KLT).

Reference analog: boofcv-ip alg/weights/ — WeightPixelGaussian_F32 (2D
Gaussian pixel weight), WeightPixelUniform_F32, WeightDistance_F32 /
WeightDistanceSqGaussian_F32 (radial distance weights).

Design: weights are precomputed [2r+1, 2r+1] arrays multiplied into
batched patch reductions — the per-pixel virtual calls of the reference
collapse into one broadcasted multiply.
"""

from __future__ import annotations

import jax.numpy as jnp


def uniform_pixel(radius: int, dtype=jnp.float32):
    """WeightPixelUniform_F32: constant weight, sums to 1."""
    side = 2 * radius + 1
    return jnp.full((side, side), 1.0 / (side * side), dtype)


def gaussian_pixel(radius: int, sigma: float = -1.0, odd: bool = True,
                   dtype=jnp.float32, normalize: bool = True):
    """WeightPixelGaussian_F32: sampled (unnormalized-by-default in the
    reference; normalized here unless ``normalize=False``) 2D Gaussian."""
    if sigma <= 0:
        sigma = (radius * 2 + 1) / 6.0  # FactoryKernelGaussian sigmaForRadius
    xs = jnp.arange(-radius, radius + 1, dtype=jnp.float64)
    g = jnp.exp(-0.5 * (xs / sigma) ** 2)
    w = jnp.outer(g, g)
    if normalize:
        w = w / jnp.sum(w)
    return w.astype(dtype)


def distance_sq_gaussian(dist_sq, sigma: float):
    """WeightDistanceSqGaussian_F32: weight from *squared* distance."""
    return jnp.exp(-0.5 * dist_sq / (sigma * sigma)).astype(jnp.float32)


def distance_uniform(dist_sq, max_radius: float):
    """WeightDistanceUniform_F32: 1 inside the radius else 0."""
    inv = 1.0 / (max_radius * max_radius)
    return jnp.where(dist_sq <= max_radius * max_radius, inv, 0.0).astype(
        jnp.float32)
