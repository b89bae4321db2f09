"""Pixel interpolation (reference analog: boofcv-ip alg/interpolate/*).

Bilinear / nearest / bicubic point samplers, batched over arbitrary
coordinate arrays — one fused gather+lerp expression, the batched analog
of BilinearPixelS.java's per-pixel method.  Coordinates follow the BoofCV
convention: integer coordinates hit pixel centers, valid domain is
[0, W-1] x [0, H-1]; out-of-range samples clamp (EXTENDED border).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def nearest(image: jnp.ndarray, ys, xs) -> jnp.ndarray:
    h, w = image.shape[:2]
    yi = jnp.clip(jnp.round(ys).astype(jnp.int32), 0, h - 1)
    xi = jnp.clip(jnp.round(xs).astype(jnp.int32), 0, w - 1)
    return image[yi, xi]


def bilinear(image: jnp.ndarray, ys, xs) -> jnp.ndarray:
    """Bilinear sample at float coords; ys/xs any (matching) shape."""
    h, w = image.shape[:2]
    ys = jnp.asarray(ys)
    xs = jnp.asarray(xs)
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = (ys - y0).astype(image.dtype) if jnp.issubdtype(image.dtype, jnp.floating) else (ys - y0)
    fx = (xs - x0).astype(fy.dtype) if hasattr(fy, "dtype") else xs - x0
    # clamp each tap from the UNCLAMPED floor: deriving the second tap
    # from the clamped first (clip(x0i)+1) broke EXTENDED semantics for
    # coords in (-1, 0) — floor -1 clamped to 0 but the second tap
    # became pixel 1, interpolating toward the interior
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    v00 = image[y0i, x0i]
    v01 = image[y0i, x1i]
    v10 = image[y1i, x0i]
    v11 = image[y1i, x1i]
    if image.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _cubic_weights(t, a: float = -0.5):
    """Keys cubic convolution weights for offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    w_m1 = a * (t3 - 2 * t2 + t)
    w_0 = (a + 2) * t3 - (a + 3) * t2 + 1
    w_1 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w_2 = a * (t2 - t3)
    return w_m1, w_0, w_1, w_2


def bicubic(image: jnp.ndarray, ys, xs) -> jnp.ndarray:
    """Bicubic (Keys a=-0.5) sample, analog of PolynomialPixel bicubic use."""
    h, w = image.shape
    ys = jnp.asarray(ys)
    xs = jnp.asarray(xs)
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    ty = ys - y0
    tx = xs - x0
    wy = _cubic_weights(ty)
    wx = _cubic_weights(tx)
    acc = 0.0
    for iy, wyi in enumerate(wy):
        yy = jnp.clip(y0.astype(jnp.int32) + (iy - 1), 0, h - 1)
        row = 0.0
        for ix, wxi in enumerate(wx):
            xx = jnp.clip(x0.astype(jnp.int32) + (ix - 1), 0, w - 1)
            row = row + image[yy, xx] * wxi
        acc = acc + row * wyi
    return acc


def in_bounds(shape_hw, ys, xs, border: float = 0.0):
    """Mask of coordinates whose bilinear support is fully inside the image."""
    h, w = shape_hw
    return ((ys >= border) & (ys <= h - 1 - border)
            & (xs >= border) & (xs <= w - 1 - border))


def sample_rect_bilinear(image: jnp.ndarray, cy, cx, radius: int) -> jnp.ndarray:
    """Sample a (2r+1)^2 patch centered at float (cy, cx) with bilinear interp.

    Batched: cy/cx of shape [N] -> [N, 2r+1, 2r+1].  This is the batched
    analog of InterpolateRectangle (used by the KLT template sampler).

    Implementation: ONE flat gather of (P+1)^2 row-major offsets per track
    + a 4-term bilinear blend with per-track scalar weights.  Centers
    whose support leaves the image are clamped to the border (callers
    mask out-of-bounds tracks separately, as KLT does).
    """
    p = 2 * radius + 1
    h, w = image.shape
    img = image if jnp.issubdtype(image.dtype, jnp.floating) else image.astype(jnp.float32)
    y0f = jnp.floor(cy)
    x0f = jnp.floor(cx)
    fy = (cy - y0f).astype(img.dtype)
    fx = (cx - x0f).astype(img.dtype)
    yi = jnp.clip(y0f.astype(jnp.int32) - radius, 0, max(h - p - 1, 0))
    xi = jnp.clip(x0f.astype(jnp.int32) - radius, 0, max(w - p - 1, 0))
    dy = jnp.arange(p + 1, dtype=jnp.int32)
    dx = jnp.arange(p + 1, dtype=jnp.int32)
    flat = ((yi[:, None, None] + dy[None, :, None]) * w
            + (xi[:, None, None] + dx[None, None, :]))
    sl = jnp.take(img.ravel(), flat)                 # [N, P+1, P+1]
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    return ((1 - fy) * (1 - fx) * sl[:, :p, :p]
            + (1 - fy) * fx * sl[:, :p, 1:]
            + fy * (1 - fx) * sl[:, 1:, :p]
            + fy * fx * sl[:, 1:, 1:])


def sample_rect_bilinear_multi(images: jnp.ndarray, cy, cx,
                               radius: int) -> jnp.ndarray:
    """Like :func:`sample_rect_bilinear` for [C, H, W] stacks: one flat
    gather of (P+1)^2 offsets per track, shared across the C channels.
    Returns [C, N, P, P]."""
    p = 2 * radius + 1
    c, h, w = images.shape
    img = images if jnp.issubdtype(images.dtype, jnp.floating) else images.astype(jnp.float32)
    y0f = jnp.floor(cy)
    x0f = jnp.floor(cx)
    fy = (cy - y0f).astype(img.dtype)[None, :, None, None]
    fx = (cx - x0f).astype(img.dtype)[None, :, None, None]
    yi = jnp.clip(y0f.astype(jnp.int32) - radius, 0, max(h - p - 1, 0))
    xi = jnp.clip(x0f.astype(jnp.int32) - radius, 0, max(w - p - 1, 0))
    dy = jnp.arange(p + 1, dtype=jnp.int32)
    dx = jnp.arange(p + 1, dtype=jnp.int32)
    flat = ((yi[:, None, None] + dy[None, :, None]) * w
            + (xi[:, None, None] + dx[None, None, :]))
    sl = jnp.take(img.reshape(c, h * w), flat, axis=1)  # [C, N, P+1, P+1]
    return ((1 - fy) * (1 - fx) * sl[..., :p, :p]
            + (1 - fy) * fx * sl[..., :p, 1:]
            + fy * (1 - fx) * sl[..., 1:, :p]
            + fy * fx * sl[..., 1:, 1:])


@functools.partial(jax.jit, static_argnames=("wy", "wx", "pad"))
def gather_windows(image, oy, ox, wy: int, wx: int, pad: int = 0):
    """Copy [N, wy, wx] windows with integer top-left corners (oy, ox).

    Reads outside the image resolve to the nearest border pixel (EXTENDED
    border), for corners with -pad <= oy, oy + wy <= max(h, wy) + pad and
    likewise in x; corners beyond that range clamp into it.  One
    ``dynamic_slice`` per window, which XLA lowers to a single gather.
    """
    h, w = image.shape
    padded = jnp.pad(image, ((pad, pad + max(wy - h, 0)),
                             (pad, pad + max(wx - w, 0))), mode="edge")
    return jax.vmap(lambda a, b: lax.dynamic_slice(padded, (a, b), (wy, wx)))(
        oy.astype(jnp.int32) + pad, ox.astype(jnp.int32) + pad)
