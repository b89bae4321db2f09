"""Discrete wavelet transform + wavelet denoising.

Reference analog: boofcv-ip alg/transform/wavelet/ (WaveletTransformOps,
Haar/Daub4/biorthogonal coefficient sets in FactoryWaveletDaub /
FactoryWaveletHaar) and alg/denoise/wavelet/ (DenoiseVisuShrink,
DenoiseBayesShrink, DenoiseSureShrink threshold rules).

Design: each DWT level = strided separable convolutions (one fused
program); thresholding rules are elementwise on the coefficient images.
Images are padded to even sizes per level internally.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp
from jax import lax


WAVELETS = {
    "haar": np.array([1.0, 1.0]) / math.sqrt(2.0),
    "daub4": np.array([(1 + math.sqrt(3)), (3 + math.sqrt(3)),
                       (3 - math.sqrt(3)), (1 - math.sqrt(3))]) / (4 * math.sqrt(2)),
}


def _filters(name: str):
    lo = np.asarray(WAVELETS[name], np.float64)
    n = len(lo)
    hi = np.array([(-1) ** i * lo[n - 1 - i] for i in range(n)])
    return jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32)


def _analysis_1d(x, lo, hi, axis):
    """Periodic downsampling filter bank along axis: returns (approx, detail)."""
    n = x.shape[axis]
    k = lo.shape[0]
    # periodic extension
    idx = (jnp.arange(n + k - 1)) % n
    xe = jnp.take(x, idx, axis=axis)

    def corr(f):
        # correlation then stride-2 (keep even phases)
        slices = []
        for i in range(k):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(i, i + n)
            slices.append(xe[tuple(sl)] * f[i])
        y = sum(slices)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n, 2)
        return y[tuple(sl)]

    return corr(lo), corr(hi)


def _synthesis_1d(a, d, lo, hi, axis):
    """Inverse of _analysis_1d: x[m] = sum_i lo[i] ya[(m-i) mod n] +
    hi[i] yd[(m-i) mod n] with ya/yd the zero-upsampled subbands — exact
    periodic perfect reconstruction for orthonormal QMF pairs."""
    k = lo.shape[0]

    def up(x):
        shape = list(x.shape)
        shape[axis] = shape[axis] * 2
        out = jnp.zeros(shape, x.dtype)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, None, 2)
        return out.at[tuple(sl)].set(x)

    ya = up(a)
    yd = up(d)

    def conv(x, f):
        acc = 0
        for i in range(k):
            acc = acc + f[i] * jnp.roll(x, i, axis=axis)
        return acc

    return conv(ya, lo) + conv(yd, hi)


def dwt2(image, wavelet: str = "haar"):
    """One-level 2D DWT: returns (LL, (LH, HL, HH)).

    Odd dimensions are edge-padded to even first: the filter bank is
    exactly invertible on the PADDED image, so ``idwt2(..., out_shape=
    image.shape)`` recovers the original exactly (without the pad, the
    analysis kept ceil(n/2) samples while synthesis rebuilt
    2*ceil(n/2), and every odd-sized multi-level decomposition crashed
    on a shape mismatch)."""
    lo, hi = _filters(wavelet)
    img = jnp.asarray(image, jnp.float32)
    if img.shape[0] % 2:
        img = jnp.concatenate([img, img[-1:]], axis=0)
    if img.shape[1] % 2:
        img = jnp.concatenate([img, img[:, -1:]], axis=1)
    a, d = _analysis_1d(img, lo, hi, axis=1)
    aa, ad = _analysis_1d(a, lo, hi, axis=0)
    da, dd = _analysis_1d(d, lo, hi, axis=0)
    return aa, (da, ad, dd)


def idwt2(ll, bands, wavelet: str = "haar", out_shape=None):
    """Inverse of :func:`dwt2`; ``out_shape`` crops the dwt2 padding."""
    lo, hi = _filters(wavelet)
    da, ad, dd = bands
    # undo axis-0 splits of the two column banks, then the axis-1 split
    a = _synthesis_1d(ll, ad, lo, hi, axis=0)
    d = _synthesis_1d(da, dd, lo, hi, axis=0)
    x = _synthesis_1d(a, d, lo, hi, axis=1)
    if out_shape is not None:
        x = x[:out_shape[0], :out_shape[1]]
    return x


def wavedec2(image, wavelet: str = "haar", levels: int = 3):
    """Multi-level decomposition: (LL_n, [bands_n, ..., bands_1])."""
    coeffs = []
    cur = jnp.asarray(image, jnp.float32)
    for _ in range(levels):
        cur, bands = dwt2(cur, wavelet)
        coeffs.append(bands)
    return cur, coeffs[::-1]


def waverec2(ll, coeffs, wavelet: str = "haar", out_shape=None):
    """Inverse of :func:`wavedec2`.  Per-level output sizes come from
    the next-finer bands (each analysis level's input shape is the
    subband shape of the level below); ``out_shape`` crops the finest
    level to the original image size (odd-size support)."""
    cur = ll
    for i, bands in enumerate(coeffs):
        if i + 1 < len(coeffs):
            nxt = coeffs[i + 1][0].shape
        else:
            nxt = out_shape
        cur = idwt2(cur, bands, wavelet, out_shape=nxt)
    return cur


# ---------------------------------------------------------------------------
# Denoising threshold rules (alg/denoise/wavelet/)
# ---------------------------------------------------------------------------

def _soft(x, t):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


def _noise_sigma(hh):
    """Robust noise estimate: median(|HH|)/0.6745 (standard, as used by
    the reference's shrinkage rules)."""
    return jnp.median(jnp.abs(hh)) / 0.6745


def denoise_visu(image, wavelet: str = "haar", levels: int = 3):
    """VisuShrink: universal threshold sigma*sqrt(2 log n)
    (DenoiseVisuShrink_F32)."""
    ll, coeffs = wavedec2(image, wavelet, levels)
    sigma = _noise_sigma(coeffs[-1][2])
    n = image.shape[0] * image.shape[1]
    t = sigma * jnp.sqrt(2.0 * jnp.log(n))
    out = [tuple(_soft(b, t) for b in bands) for bands in coeffs]
    return waverec2(ll, out, wavelet,
                    out_shape=jnp.asarray(image).shape)


def denoise_sure(image, wavelet: str = "haar", levels: int = 3):
    """SureShrink: per-subband threshold minimizing Stein's unbiased risk
    estimate (DenoiseSureShrink_F32), with the standard hybrid fallback to
    the universal threshold when the subband is too sparse.

    SURE(t) = n - 2*#{|y|<=t} + sum(min(|y|, t)^2) evaluated at every
    candidate t = |y_(k)| (all sorted magnitudes — one vectorized sweep,
    no data-dependent shapes).
    """
    ll, coeffs = wavedec2(image, wavelet, levels)
    sigma = _noise_sigma(coeffs[-1][2])
    sigma = jnp.maximum(sigma, 1e-12)

    def sure_threshold(b):
        y = (b / sigma).ravel()
        n = y.shape[0]
        a = jnp.sort(y * y)
        cum = jnp.cumsum(a)
        k = jnp.arange(1, n + 1, dtype=jnp.float32)
        # risk at t^2 = a[k-1]: n - 2k + cum[k-1] + (n-k)*a[k-1]
        risk = (n - 2.0 * k) + cum + (n - k) * a
        t2 = a[jnp.argmin(risk)]
        t_sure = jnp.sqrt(t2)
        # hybrid rule: universal threshold if signal energy is too small
        t_univ = jnp.sqrt(2.0 * jnp.log(jnp.asarray(n, jnp.float32)))
        energy = (cum[-1] - n) / n
        magic = (jnp.log2(jnp.asarray(n, jnp.float32)) ** 1.5) / jnp.sqrt(
            jnp.asarray(n, jnp.float32))
        t = jnp.where(energy <= magic, t_univ, jnp.minimum(t_sure, t_univ))
        return t * sigma

    out = [tuple(_soft(b, sure_threshold(b)) for b in bands)
           for bands in coeffs]
    return waverec2(ll, out, wavelet,
                    out_shape=jnp.asarray(image).shape)


def denoise_bayes(image, wavelet: str = "haar", levels: int = 3):
    """BayesShrink: per-subband t = sigma^2 / sigma_x
    (DenoiseBayesShrink_F32)."""
    ll, coeffs = wavedec2(image, wavelet, levels)
    sigma = _noise_sigma(coeffs[-1][2])
    s2 = sigma * sigma
    out = []
    for bands in coeffs:
        thr_bands = []
        for b in bands:
            var_y = jnp.mean(b * b)
            sig_x = jnp.sqrt(jnp.maximum(var_y - s2, 1e-12))
            t = s2 / sig_x
            thr_bands.append(_soft(b, t))
        out.append(tuple(thr_bands))
    return waverec2(ll, out, wavelet,
                    out_shape=jnp.asarray(image).shape)
