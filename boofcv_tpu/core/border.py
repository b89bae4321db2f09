"""Image border rules.

Reference analog: boofcv-types struct/border/BorderType.java — virtual
out-of-bounds pixels with EXTENDED / REFLECT / WRAP / ZERO / NORMALIZED /
SKIP semantics.  Here these become either ``jnp.pad`` modes (when an op
pads up-front) or index-remap functions (when a kernel clamps/wraps gather
coordinates in-place).
"""

from __future__ import annotations

import enum

import jax.numpy as jnp


class BorderType(enum.Enum):
    """Out-of-bounds pixel rule (struct/border/BorderType.java:28)."""

    SKIP = "skip"           # do not compute output where the kernel leaves the image
    EXTENDED = "extended"   # replicate edge pixel
    NORMALIZED = "normalized"  # renormalize kernel over the valid support (convolution only)
    REFLECT = "reflect"     # mirror without repeating the edge pixel (BoofCV Reflect)
    WRAP = "wrap"           # periodic
    ZERO = "zero"           # constant 0


_PAD_MODES = {
    BorderType.EXTENDED: "edge",
    BorderType.REFLECT: "symmetric",  # BoofCV reflect duplicates edge: f(-1)=f(0)? see note below
    BorderType.WRAP: "wrap",
    BorderType.ZERO: "constant",
}

# NOTE on REFLECT: BoofCV's ImageBorder1D reflect (BorderIndex1D_Reflect) maps
# index -1 -> 1 (no edge duplication), which is numpy "reflect".  numpy
# "symmetric" maps -1 -> 0.  BoofCV uses the no-duplicate variant.
_PAD_MODES[BorderType.REFLECT] = "reflect"


def pad_mode(border: BorderType) -> str:
    """``jnp.pad`` mode string for a border rule (ZERO uses constant 0)."""
    try:
        return _PAD_MODES[border]
    except KeyError:
        raise ValueError(f"border {border} has no pad-mode equivalent") from None


def pad(image: jnp.ndarray, radius_y: int, radius_x: int,
        border: BorderType = BorderType.EXTENDED) -> jnp.ndarray:
    """Pad a (H, W) or (H, W, C) image by (radius_y, radius_x) on each side."""
    widths = [(radius_y, radius_y), (radius_x, radius_x)]
    widths += [(0, 0)] * (image.ndim - 2)
    mode = pad_mode(border)
    if mode == "constant":
        return jnp.pad(image, widths, mode="constant", constant_values=0)
    return jnp.pad(image, widths, mode=mode)


def clamp_index(idx: jnp.ndarray, size: int) -> jnp.ndarray:
    """EXTENDED border as an index remap."""
    return jnp.clip(idx, 0, size - 1)


def wrap_index(idx: jnp.ndarray, size: int) -> jnp.ndarray:
    return jnp.mod(idx, size)


def reflect_index(idx: jnp.ndarray, size: int) -> jnp.ndarray:
    """Reflect-without-duplication: -1 -> 1, size -> size-2."""
    period = 2 * (size - 1)
    idx = jnp.mod(idx, period)
    return jnp.where(idx >= size, period - idx, idx)
