"""Image warping / remap (reference analog: boofcv-ip alg/distort/*).

The reference's ImageDistort.apply (alg/distort/ImageDistortBasic_SB.java)
walks destination pixels, maps each through a Point2Transform, and
interpolates the source.  Batched: build the map once as two (H, W)
coordinate grids (the "cached" variant ImageDistortCache_SB is the
*default* here), then warp = one batched bilinear gather — ideal for
rectification and lens undistortion where the map is static per camera.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp

from boofcv_tpu.ip import interpolate


def make_warp_grid(transform: Callable, height: int, width: int,
                   dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate a dst->src pixel transform on the full grid.

    ``transform(xs, ys) -> (src_xs, src_ys)`` must be vectorized (pure jnp).
    Returns (map_y, map_x) each (H, W).
    """
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=dtype),
                          jnp.arange(width, dtype=dtype), indexing="ij")
    sx, sy = transform(xs, ys)
    return sy.astype(dtype), sx.astype(dtype)


def warp(image: jnp.ndarray, map_y: jnp.ndarray, map_x: jnp.ndarray,
         method: str = "bilinear", fill_value: float = 0.0) -> jnp.ndarray:
    """Apply a precomputed dst->src map; out-of-bounds -> fill_value."""
    if method == "bilinear":
        out = interpolate.bilinear(image, map_y, map_x)
    elif method == "nearest":
        out = interpolate.nearest(image, map_y, map_x)
    else:
        raise ValueError(method)
    h, w = image.shape[:2]
    valid = (map_y >= 0) & (map_y <= h - 1) & (map_x >= 0) & (map_x <= w - 1)
    if image.ndim == 3:
        valid = valid[..., None]
    return jnp.where(valid, out, fill_value)


def warp_affine(image: jnp.ndarray, a11, a12, a21, a22, tx, ty,
                out_shape=None, method="bilinear", fill_value=0.0):
    """Warp with dst->src affine map [x';y'] = A [x;y] + t
    (DistortImageOps.affine analog)."""
    h, w = out_shape if out_shape is not None else image.shape[:2]

    def tf(xs, ys):
        return a11 * xs + a12 * ys + tx, a21 * xs + a22 * ys + ty

    my, mx = make_warp_grid(tf, h, w)
    return warp(image, my, mx, method, fill_value)


def warp_homography(image: jnp.ndarray, H_dst_to_src: jnp.ndarray,
                    out_shape=None, method="bilinear", fill_value=0.0):
    """Warp with a dst->src homography (3x3)."""
    h, w = out_shape if out_shape is not None else image.shape[:2]
    Hm = jnp.asarray(H_dst_to_src, dtype=jnp.float32)

    def tf(xs, ys):
        d = Hm[2, 0] * xs + Hm[2, 1] * ys + Hm[2, 2]
        sx = (Hm[0, 0] * xs + Hm[0, 1] * ys + Hm[0, 2]) / d
        sy = (Hm[1, 0] * xs + Hm[1, 1] * ys + Hm[1, 2]) / d
        return sx, sy

    my, mx = make_warp_grid(tf, h, w)
    return warp(image, my, mx, method, fill_value)


def scale(image: jnp.ndarray, out_shape, method="bilinear"):
    """Resize (DistortImageOps.scale)."""
    h_out, w_out = out_shape
    h, w = image.shape[:2]
    sy = h / h_out
    sx = w / w_out

    def tf(xs, ys):
        # clamp into the valid source range: dst pixel j maps to j*s,
        # which for upscales pushes the last row/column past w-1 and the
        # warp's validity mask filled the whole max edge with 0
        return (jnp.minimum(xs * sx, w - 1.0),
                jnp.minimum(ys * sy, h - 1.0))

    my, mx = make_warp_grid(tf, h_out, w_out)
    return warp(image, my, mx, method)


def rotate(image: jnp.ndarray, angle: float, out_shape=None, method="bilinear"):
    """Rotate about the image center (DistortImageOps.rotate)."""
    h, w = image.shape[:2]
    oh, ow = out_shape if out_shape is not None else (h, w)
    c, s = jnp.cos(angle), jnp.sin(angle)
    cx_src, cy_src = (w - 1) / 2.0, (h - 1) / 2.0
    cx_dst, cy_dst = (ow - 1) / 2.0, (oh - 1) / 2.0

    def tf(xs, ys):
        x = xs - cx_dst
        y = ys - cy_dst
        return c * x - s * y + cx_src, s * x + c * y + cy_src

    my, mx = make_warp_grid(tf, oh, ow)
    return warp(image, my, mx, method)
