"""Convolution (reference analog: boofcv-ip alg/filter/convolve/*, 43k LoC).

The reference ships hand-unrolled per-dtype horizontal/vertical/2D loops
(noborder/ConvolveImageStandard_SB.java:44, ConvolveImageUnrolled_*),
plus border, normalized-border and renormalizing variants.  All of that
collapses here into `lax.conv_general_dilated` calls on padded inputs,
and XLA fuses the surrounding elementwise work.  Every convolution runs
at HIGHEST precision: a GPU's lower settings round f32 operands to TF32
(10 mantissa bits), which moves pyramid levels, gradients and corner
scores away from the CPU result.

Conventions:
* kernels are correlation kernels (BoofCV convolves with the kernel as
  written scanning left-to-right — i.e. correlation in signal terms; we
  preserve that, so results match the reference for symmetric AND
  asymmetric kernels without flipping).
* ``border=SKIP`` matches the reference's no-border variant: the output
  crop where the kernel does not fit keeps the *input* pixel values
  (ConvolveImageNoBorder leaves the destination border untouched; we copy
  the source there so the function stays pure).
* ``border=NORMALIZED`` renormalizes the kernel over its in-image support
  (normalized/ConvolveNormalized.java) — implemented by dividing by the
  convolution of a ones-image with ZERO padding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.core.border import BorderType, pad


def _conv2d_valid(image: jnp.ndarray, kernel2d: jnp.ndarray) -> jnp.ndarray:
    """VALID correlation of (H, W) image with (kh, kw) kernel."""
    img = image[jnp.newaxis, jnp.newaxis, :, :]
    ker = kernel2d[jnp.newaxis, jnp.newaxis, :, :].astype(image.dtype)
    out = lax.conv_general_dilated(
        img, ker, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


def horizontal(image: jnp.ndarray, kernel: jnp.ndarray,
               border: BorderType = BorderType.SKIP) -> jnp.ndarray:
    """1D horizontal convolution (ConvolveImageNoBorder.horizontal etc.)."""
    return _separable_axis(image, kernel, axis=1, border=border)


def vertical(image: jnp.ndarray, kernel: jnp.ndarray,
             border: BorderType = BorderType.SKIP) -> jnp.ndarray:
    """1D vertical convolution."""
    return _separable_axis(image, kernel, axis=0, border=border)


def _separable_axis(image, kernel, axis, border):
    kernel = jnp.asarray(kernel)
    radius = (kernel.shape[0] - 1) // 2
    k2 = kernel[jnp.newaxis, :] if axis == 1 else kernel[:, jnp.newaxis]
    ry, rx = (0, radius) if axis == 1 else (radius, 0)

    if border == BorderType.SKIP:
        core = _conv2d_valid(image, k2)
        out = jnp.asarray(image).astype(core.dtype)
        h, w = image.shape
        return out.at[ry:h - ry or None, rx:w - rx or None].set(core)
    if border == BorderType.NORMALIZED:
        padded = pad(image, ry, rx, BorderType.ZERO)
        num = _conv2d_valid(padded, k2)
        ones = jnp.ones_like(image)
        den = _conv2d_valid(pad(ones, ry, rx, BorderType.ZERO), k2)
        ksum = jnp.sum(kernel)
        return num * (ksum / den)
    padded = pad(image, ry, rx, border)
    return _conv2d_valid(padded, k2)


def convolve2d(image: jnp.ndarray, kernel2d: jnp.ndarray,
               border: BorderType = BorderType.SKIP) -> jnp.ndarray:
    """2D convolution (GConvolveImageOps.convolve)."""
    kernel2d = jnp.asarray(kernel2d)
    ry = (kernel2d.shape[0] - 1) // 2
    rx = (kernel2d.shape[1] - 1) // 2
    if border == BorderType.SKIP:
        core = _conv2d_valid(image, kernel2d)
        out = jnp.asarray(image).astype(core.dtype)
        h, w = image.shape
        return out.at[ry:h - ry or None, rx:w - rx or None].set(core)
    if border == BorderType.NORMALIZED:
        padded = pad(image, ry, rx, BorderType.ZERO)
        num = _conv2d_valid(padded, kernel2d)
        den = _conv2d_valid(pad(jnp.ones_like(image), ry, rx, BorderType.ZERO), kernel2d)
        ksum = jnp.sum(kernel2d)
        return num * (ksum / den)
    padded = pad(image, ry, rx, border)
    return _conv2d_valid(padded, kernel2d)


def separable(image: jnp.ndarray, kernel_x: jnp.ndarray, kernel_y: jnp.ndarray,
              border: BorderType = BorderType.EXTENDED) -> jnp.ndarray:
    """Separable conv: horizontal then vertical (BlurImageOps composition)."""
    tmp = horizontal(image, kernel_x, border)
    return vertical(tmp, kernel_y, border)


def convolve_down(image: jnp.ndarray, kernel: jnp.ndarray, skip: int,
                  axis: int) -> jnp.ndarray:
    """Convolve-and-decimate (ConvolveImageDownNoBorder) with EXTENDED border."""
    kernel = jnp.asarray(kernel)
    radius = (kernel.shape[0] - 1) // 2
    k2 = kernel[jnp.newaxis, :] if axis == 1 else kernel[:, jnp.newaxis]
    ry, rx = (0, radius) if axis == 1 else (radius, 0)
    padded = pad(image, ry, rx, BorderType.EXTENDED)
    img = padded[jnp.newaxis, jnp.newaxis]
    ker = k2[jnp.newaxis, jnp.newaxis].astype(image.dtype)
    strides = (1, skip) if axis == 1 else (skip, 1)
    out = lax.conv_general_dilated(
        img, ker, window_strides=strides, padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


def sparse_sample(image: jnp.ndarray, kernel2d: jnp.ndarray,
                  ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate a 2D kernel at N individual pixel centers (sparse convolve,
    ConvolveImageSparse).  ys/xs are integer arrays [N]; EXTENDED border."""
    kernel2d = jnp.asarray(kernel2d)
    kh, kw = kernel2d.shape
    ry, rx = (kh - 1) // 2, (kw - 1) // 2
    h, w = image.shape
    dy = jnp.arange(-ry, ry + 1)
    dx = jnp.arange(-rx, rx + 1)
    yy = jnp.clip(ys[:, None, None] + dy[None, :, None], 0, h - 1)
    xx = jnp.clip(xs[:, None, None] + dx[None, None, :], 0, w - 1)
    patches = image[yy, xx]  # [N, kh, kw]
    return jnp.einsum("nij,ij->n", patches.astype(kernel2d.dtype), kernel2d)
