"""Multi-band (Planar / Interleaved) image support for single-band ip ops.

Reference analog: the Planar<T> overloads spread across boofcv-ip
(GBlurImageOps / GConvolveImageOps / ConvertImage.java:38 / planar
variants of distort): the reference loops the single-band op over bands.
Batched: ONE ``vmap`` over the band axis — the bands become a leading
batch dimension of the same compiled kernel, so a 3-band blur is one
fused dispatch, not three.

Convention: interleaved [H, W, C] (the natural layout for IO and color
ops).  ``per_band`` transposes to band-major [C, H, W] for the vmap and
back — XLA fuses the transposes into the kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def per_band(fn, image, *args, band_axis: int = -1, **kwargs):
    """Apply a single-band ``fn(image2d, *args, **kwargs)`` across the
    band axis of a multi-band image via one vmap.

    Works for any pytree output (tuples like ``derivative.sobel``'s
    (dx, dy), pyramid lists): every [H', W'] leaf comes back with the
    band axis restored at ``band_axis``.
    """
    img = jnp.moveaxis(jnp.asarray(image), band_axis, 0)
    out = jax.vmap(lambda band: fn(band, *args, **kwargs))(img)
    return jax.tree_util.tree_map(
        lambda leaf: jnp.moveaxis(leaf, 0, band_axis), out)


def planar(fn):
    """Wrap a single-band op into a multi-band one: ``planar(blur.gaussian)
    (rgb, sigma=2)``.  2-D inputs pass through unchanged, so the wrapped
    op accepts both gray and planar images (the reference's G*Ops
    dispatch role)."""

    def wrapped(image, *args, band_axis: int = -1, **kwargs):
        image = jnp.asarray(image)
        if image.ndim == 2:
            return fn(image, *args, **kwargs)
        return per_band(fn, image, *args, band_axis=band_axis, **kwargs)

    wrapped.__name__ = f"planar_{getattr(fn, '__name__', 'op')}"
    wrapped.__doc__ = (f"Multi-band (vmap-over-bands) wrapper of "
                       f"{getattr(fn, '__name__', fn)}.")
    return wrapped


def average_bands(image, band_axis: int = -1) -> jnp.ndarray:
    """ConvertImage.average: planar -> gray by band mean."""
    return jnp.mean(jnp.asarray(image, jnp.float32), axis=band_axis)


def split_bands(image, band_axis: int = -1):
    """Interleaved -> list of single-band images (ConvertImage split)."""
    image = jnp.asarray(image)
    return [jnp.take(image, i, axis=band_axis)
            for i in range(image.shape[band_axis])]


def merge_bands(bands, band_axis: int = -1) -> jnp.ndarray:
    """List of single-band images -> interleaved (ConvertImage merge)."""
    return jnp.stack(bands, axis=band_axis)
