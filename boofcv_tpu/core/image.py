"""Image representation policy.

Reference analog: boofcv-types struct/image/* (ImageBase.java:30,
ImageGray.java:62, Planar.java) — 8 dtypes x 3 layouts with subimage views.
Here the entire hierarchy collapses: a gray image is an (H, W) array, an
interleaved/color image is (H, W, C), a "Planar" is (C, H, W) or simply a
batch axis, and a subimage is a slice.  Integer source data (U8/U16) is
converted to f32 at the edge — every compute-path op in this package is
float (f32 default, bf16 opt-in), which is both the accelerator-native choice and
what BoofCV's generated per-dtype code was emulating in fixed point.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ImageShape(NamedTuple):
    height: int
    width: int

    @property
    def hw(self) -> tuple[int, int]:
        return (self.height, self.width)


def to_float32(image) -> jnp.ndarray:
    """Convert any supported input (uint8/16, float) to f32 without rescaling.

    Matches BoofCV ConvertImage semantics (core/image/ConvertImage.java):
    value-preserving cast, so U8 [0,255] stays [0,255].
    """
    return jnp.asarray(image).astype(jnp.float32)


def to_uint8(image: jnp.ndarray) -> jnp.ndarray:
    """Clamp-and-round back to U8 (ConvertImage float->U8 semantics)."""
    return jnp.clip(jnp.round(image), 0, 255).astype(jnp.uint8)


def rescale_to_unit(image) -> jnp.ndarray:
    """U8 [0,255] -> f32 [0,1]."""
    return jnp.asarray(image).astype(jnp.float32) / 255.0
