"""Image derivatives (reference analog: boofcv-ip alg/filter/derivative/*).

Sobel / Prewitt / Three / Two gradients, Laplacian, Hessian stencils —
each a fixed small convolution.  BoofCV's convention (GradientSobel.java):
derivX responds positively to increasing intensity left->right, derivY
top->bottom, with the border handled by the caller-supplied ImageBorder
(we default to EXTENDED).
"""

from __future__ import annotations

import jax.numpy as jnp

from boofcv_tpu.core.border import BorderType
from boofcv_tpu.ip import convolve

# Correlation kernels matching BoofCV's generated stencils.
_SOBEL_SMOOTH = jnp.array([0.25, 0.5, 0.25], dtype=jnp.float32) * 4.0  # [1,2,1]
_DERIV_3 = jnp.array([-1.0, 0.0, 1.0], dtype=jnp.float32)


def sobel(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """Sobel gradient (GradientSobel.java).  Returns (derivX, derivY).

    BoofCV integer Sobel uses weights [-1,0,1] x [1,2,1]; float version
    uses 0.25/0.5 smoothing with +/-1 differentiation — we use the integer
    convention scaled to match the generated float code's magnitudes
    ([1,2,1] smoothing, [-1,0,1] difference).
    """
    img = image.astype(jnp.float32)
    if border == BorderType.EXTENDED:
        # fused path: both derivatives as ONE 2-output-channel 3x3 conv
        # (4 separable convs -> 1 op and one pass over the image); HIGHEST
        # for the reason given in ip/convolve.py
        from jax import lax as _lax
        d = jnp.array([-1.0, 0.0, 1.0], jnp.float32)
        s = jnp.array([1.0, 2.0, 1.0], jnp.float32)
        kx = s[:, None] * d[None, :]          # [3, 3] d/dx
        ky = d[:, None] * s[None, :]          # [3, 3] d/dy
        # conv_general_dilated cross-correlates — matching the library's
        # kernel convention (correlation, like the reference's loops)
        ker = jnp.stack([kx, ky])[:, None]                # [2, 1, 3, 3]
        padded = convolve.pad(img, 1, 1, border)[None, None]
        out = _lax.conv_general_dilated(
            padded, ker, window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=_lax.Precision.HIGHEST)
        return out[0, 0], out[0, 1]
    smooth = jnp.array([1.0, 2.0, 1.0], dtype=jnp.float32)
    dx = convolve.horizontal(img, _DERIV_3, border)
    dx = convolve.vertical(dx, smooth, border)
    dy = convolve.vertical(img, _DERIV_3, border)
    dy = convolve.horizontal(dy, smooth, border)
    return dx, dy


def prewitt(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """Prewitt gradient (GradientPrewitt.java): [1,1,1] smoothing."""
    img = image.astype(jnp.float32)
    smooth = jnp.array([1.0, 1.0, 1.0], dtype=jnp.float32)
    dx = convolve.horizontal(img, _DERIV_3, border)
    dx = convolve.vertical(dx, smooth, border)
    dy = convolve.vertical(img, _DERIV_3, border)
    dy = convolve.horizontal(dy, smooth, border)
    return dx, dy


def three(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """Central-difference gradient (GradientThree.java): [-0.5, 0, 0.5]."""
    img = image.astype(jnp.float32)
    k = jnp.array([-0.5, 0.0, 0.5], dtype=jnp.float32)
    return (convolve.horizontal(img, k, border),
            convolve.vertical(img, k, border))


def two0(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """Forward difference f(x+1)-f(x) (GradientTwo0.java)."""
    img = image.astype(jnp.float32)
    k = jnp.array([0.0, -1.0, 1.0], dtype=jnp.float32)
    return (convolve.horizontal(img, k, border),
            convolve.vertical(img, k, border))


def two1(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """Backward difference f(x)-f(x-1) (GradientTwo1.java)."""
    img = image.astype(jnp.float32)
    k = jnp.array([-1.0, 1.0, 0.0], dtype=jnp.float32)
    return (convolve.horizontal(img, k, border),
            convolve.vertical(img, k, border))


def laplacian(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """4-connected Laplacian (DerivativeLaplacian.java)."""
    k = jnp.array([[0.0, 1.0, 0.0],
                   [1.0, -4.0, 1.0],
                   [0.0, 1.0, 0.0]], dtype=jnp.float32)
    return convolve.convolve2d(image.astype(jnp.float32), k, border)


def hessian_three(image: jnp.ndarray, border: BorderType = BorderType.EXTENDED):
    """Second derivatives directly from the image (HessianThree.java).

    Returns (dxx, dyy, dxy).  BoofCV uses [0.5,0,-1,0,0.5] for dxx/dyy and
    a /4 cross kernel for dxy.
    """
    img = image.astype(jnp.float32)
    k2 = jnp.array([0.5, 0.0, -1.0, 0.0, 0.5], dtype=jnp.float32)
    dxx = convolve.horizontal(img, k2, border)
    dyy = convolve.vertical(img, k2, border)
    kxy = jnp.array([[0.25, 0.0, -0.25],
                     [0.0, 0.0, 0.0],
                     [-0.25, 0.0, 0.25]], dtype=jnp.float32)
    dxy = convolve.convolve2d(img, kxy, border)
    return dxx, dyy, dxy


def hessian_from_gradient(dx: jnp.ndarray, dy: jnp.ndarray,
                          border: BorderType = BorderType.EXTENDED):
    """Hessian via differentiating the gradient (HessianFromGradient.java,
    Sobel variant).  Returns (dxx, dyy, dxy)."""
    dxx, dxy = sobel(dx, border)
    _, dyy = sobel(dy, border)
    return dxx, dyy, dxy


def gradient_magnitude_angle(dx: jnp.ndarray, dy: jnp.ndarray):
    mag = jnp.sqrt(dx * dx + dy * dy)
    angle = jnp.arctan2(dy, dx)
    return mag, angle
