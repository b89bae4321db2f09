"""Object trackers: circulant (KCF-style), mean-shift likelihood, SFOT-lite.

Reference analog: boofcv-recognition alg/tracker/ —
circulant/CirculantTracker.java (dense FFT correlation tracker),
meanshift/TrackerMeanShiftLikelihood.java (back-projection mean-shift),
tld/TldTracker.java (covered separately later).

Design: circulant is the natural first pick — training and detection
are elementwise ops in the Fourier domain (jnp.fft on device); mean-shift
is an iterated weighted-centroid reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.ip.interpolate import bilinear


class CirculantState(NamedTuple):
    """CirculantTracker work state (alphaf/template in Fourier domain)."""
    alphaf: jnp.ndarray     # [H, W] complex
    template: jnp.ndarray   # [H, W] f32 (z in the paper)
    cy: jnp.ndarray         # scalar center
    cx: jnp.ndarray
    size: int               # region size (square)


def _hann2d(n: int) -> jnp.ndarray:
    w = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(n) / (n - 1))
    return w[:, None] * w[None, :]


def _gauss_response(n: int, sigma_factor: float = 0.0625) -> jnp.ndarray:
    sigma = jnp.sqrt(jnp.float32(n * n)) * sigma_factor
    # build directly in the shifted frame with WRAPPED distances so the
    # peak sits exactly at (0, 0) for any n (rolling a grid centered at
    # the half-integer (n-1)/2 left an even-size target peaking between
    # indices 0 and 1 — a +0.5 px per-frame drift bias in the tracker)
    y = (jnp.arange(n) + n // 2) % n - n // 2
    d2 = y[:, None] ** 2 + y[None, :] ** 2
    return jnp.exp(-0.5 * d2 / (sigma ** 2))


def _get_window(image, cy, cx, n):
    d = jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0
    yy = cy + d[:, None]
    xx = cx + d[None, :]
    win = bilinear(image.astype(jnp.float32), yy, xx)
    win = win / 255.0 - 0.5
    return win * _hann2d(n)


def _gaussian_kernel_correlation(x, y, sigma: float = 0.2):
    """k = exp(-|x-y|^2 / sigma^2 n) evaluated densely via FFT
    (CirculantTracker.dense_gauss_kernel)."""
    n = x.shape[0] * x.shape[1]
    xf = jnp.fft.fft2(x)
    yf = jnp.fft.fft2(y)
    xyf = xf * jnp.conj(yf)
    xy = jnp.real(jnp.fft.ifft2(xyf))
    xx = jnp.sum(x * x)
    yy = jnp.sum(y * y)
    d2 = jnp.maximum(xx + yy - 2.0 * xy, 0.0) / n
    return jnp.exp(-d2 / (sigma ** 2))


def circulant_init(image, cy: float, cx: float, size: int = 64,
                   lambda_: float = 1e-4) -> CirculantState:
    """Initialize on the first frame (CirculantTracker.initialize)."""
    z = _get_window(jnp.asarray(image), jnp.float32(cy), jnp.float32(cx), size)
    k = _gaussian_kernel_correlation(z, z)
    yf = jnp.fft.fft2(_gauss_response(size))
    alphaf = yf / (jnp.fft.fft2(k) + lambda_)
    return CirculantState(alphaf, z, jnp.float32(cy), jnp.float32(cx), size)


def circulant_track(state: CirculantState, image,
                    interp_factor: float = 0.075,
                    lambda_: float = 1e-4) -> CirculantState:
    """One frame: detect peak, move center, update model
    (CirculantTracker.performTracking)."""
    n = state.size
    x = _get_window(jnp.asarray(image), state.cy, state.cx, n)
    k = _gaussian_kernel_correlation(x, state.template)
    resp = jnp.real(jnp.fft.ifft2(state.alphaf * jnp.fft.fft2(k)))
    idx = jnp.argmax(resp)
    py = idx // n
    px = idx % n
    # responses are circular: displacement in [-n/2, n/2)
    dy = jnp.where(py > n // 2, py - n, py).astype(jnp.float32)
    dx = jnp.where(px > n // 2, px - n, px).astype(jnp.float32)
    cy = state.cy + dy
    cx = state.cx + dx
    # retrain at the new location, blend
    z = _get_window(jnp.asarray(image), cy, cx, n)
    k2 = _gaussian_kernel_correlation(z, z)
    yf = jnp.fft.fft2(_gauss_response(n))
    alphaf_new = yf / (jnp.fft.fft2(k2) + lambda_)
    a = interp_factor
    return CirculantState(
        (1 - a) * state.alphaf + a * alphaf_new,
        (1 - a) * state.template + a * z, cy, cx, n)


# ---------------------------------------------------------------------------
# Mean-shift likelihood tracker
# ---------------------------------------------------------------------------

class MeanShiftState(NamedTuple):
    hist: jnp.ndarray   # [B] target intensity histogram (normalized)
    cy: jnp.ndarray
    cx: jnp.ndarray
    radius: int
    num_bins: int


def meanshift_init(image, cy, cx, radius: int = 15,
                   num_bins: int = 32) -> MeanShiftState:
    """Build a DISCRIMINATIVE histogram: P(fg | bin) from a foreground
    patch vs a surrounding background ring (the reference's likelihood
    models — e.g. LikelihoodHueSatHistInd — are similarly normalized)."""
    img = jnp.asarray(image, jnp.float32)
    h, w = img.shape

    def patch_hist(r_in, r_out):
        ys = jnp.clip(jnp.arange(int(cy) - r_out, int(cy) + r_out + 1), 0, h - 1)
        xs = jnp.clip(jnp.arange(int(cx) - r_out, int(cx) + r_out + 1), 0, w - 1)
        patch = img[ys[:, None], xs[None, :]]
        dy = jnp.arange(-r_out, r_out + 1)
        ring = (jnp.abs(dy[:, None]) > r_in) | (jnp.abs(dy[None, :]) > r_in)
        mask = ring if r_in > 0 else jnp.ones_like(ring, bool)
        bins = jnp.clip((patch / 256.0 * num_bins).astype(jnp.int32), 0,
                        num_bins - 1)
        hist = jnp.zeros((num_bins,)).at[bins.ravel()].add(
            mask.ravel().astype(jnp.float32))
        return hist / jnp.maximum(jnp.sum(hist), 1e-12)

    fg = patch_hist(0, radius)
    bg = patch_hist(radius, 2 * radius)
    likelihood = fg / (fg + bg + 1e-6)
    return MeanShiftState(likelihood, jnp.float32(cy), jnp.float32(cx),
                          radius, num_bins)


def meanshift_track(state: MeanShiftState, image, iterations: int = 10):
    """Back-projection weighted centroid iteration
    (TrackerMeanShiftLikelihood.process)."""
    img = jnp.asarray(image, jnp.float32)
    h, w = img.shape
    bins = jnp.clip((img / 256.0 * state.num_bins).astype(jnp.int32), 0,
                    state.num_bins - 1)
    likelihood = state.hist[bins]                        # [H, W]
    r = state.radius
    d = jnp.arange(-r, r + 1, dtype=jnp.float32)
    cy, cx = state.cy, state.cx
    for _ in range(iterations):
        yy = jnp.clip(jnp.round(cy + d).astype(jnp.int32), 0, h - 1)
        xx = jnp.clip(jnp.round(cx + d).astype(jnp.int32), 0, w - 1)
        wgt = likelihood[yy[:, None], xx[None, :]]
        tot = jnp.sum(wgt) + 1e-12
        cy = jnp.sum(wgt * (cy + d[:, None])) / tot
        cx = jnp.sum(wgt * (cx + d[None, :])) / tot
    return state._replace(cy=cy, cx=cx)


# ---------------------------------------------------------------------------
# SFOT: sparse-flow object tracker
# ---------------------------------------------------------------------------

class SfotState(NamedTuple):
    """Rotated-rectangle region (RectangleRotate_F64 analog)."""
    cy: jnp.ndarray
    cx: jnp.ndarray
    height: jnp.ndarray
    width: jnp.ndarray
    yaw: jnp.ndarray


def sfot_init(cy, cx, height, width, yaw=0.0) -> SfotState:
    f = lambda v: jnp.asarray(v, jnp.float32)
    return SfotState(f(cy), f(cx), f(height), f(width), f(yaw))


def _sfot_grid(state: SfotState, grid: int):
    """Grid of sample points inside the rotated rectangle."""
    u = (jnp.arange(grid, dtype=jnp.float32) + 0.5) / grid - 0.5
    uy, ux = jnp.meshgrid(u * state.height, u * state.width, indexing="ij")
    c, s = jnp.cos(state.yaw), jnp.sin(state.yaw)
    xs = state.cx + c * ux.ravel() - s * uy.ravel()
    ys = state.cy + s * ux.ravel() + c * uy.ravel()
    return ys, xs


def sfot_track(prev_image, image, state: SfotState, grid: int = 9,
               scales=(1, 2, 4), template_radius: int = 3,
               min_tracks: int = 8):
    """Sparse-flow object tracking step (alg/tracker/sfot/
    SparseFlowObjectTracker.java): KLT a grid of points inside the region,
    then update the rotated rectangle with MEDIAN statistics — median
    translation, median pairwise distance ratio (scale), median pairwise
    angle change (rotation) — the Median-Flow recipe the reference uses.

    All points track as one batched pyramidal GN; the O(K^2) pairwise
    medians are tiny fixed-shape reductions.  Returns (state, ok).
    """
    from boofcv_tpu.core.pyramid import PyramidConfig
    from boofcv_tpu.ip import pyramid_ops
    from boofcv_tpu.feature import klt

    cfgp = PyramidConfig(scales=tuple(scales))
    p_prev = pyramid_ops.pyramid_average(
        jnp.asarray(prev_image, jnp.float32), cfgp)
    p_cur = pyramid_ops.pyramid_average(
        jnp.asarray(image, jnp.float32), cfgp)
    grads = pyramid_ops.gradient(p_prev)
    ys, xs = _sfot_grid(state, grid)
    cfg = klt.KltConfig(template_radius=template_radius)
    tmpl = klt.sample_templates(p_prev, grads, ys, xs, scales,
                                template_radius)
    nys, nxs, fault = klt.track_pyramid(p_cur, tmpl, ys, xs, scales, cfg)
    ok = fault == klt.TRACK_OK
    n_ok = jnp.sum(ok)

    def masked_median(v, m):
        big = jnp.float32(3.4e38)
        s = jnp.sort(jnp.where(m, v, big))
        k = jnp.maximum(jnp.sum(m) - 1, 0)
        lo = s[k // 2]
        hi = s[(k + 1) // 2]
        return 0.5 * (lo + hi)

    dty = masked_median(nys - ys, ok)
    dtx = masked_median(nxs - xs, ok)

    # pairwise scale + rotation medians over valid pairs
    pdx0 = xs[:, None] - xs[None, :]
    pdy0 = ys[:, None] - ys[None, :]
    pdx1 = nxs[:, None] - nxs[None, :]
    pdy1 = nys[:, None] - nys[None, :]
    k2 = grid * grid
    iu = jnp.triu_indices(k2, k=1)
    pm = (ok[:, None] & ok[None, :])[iu]
    d0 = jnp.sqrt(pdx0[iu] ** 2 + pdy0[iu] ** 2)
    d1 = jnp.sqrt(pdx1[iu] ** 2 + pdy1[iu] ** 2)
    pm = pm & (d0 > 2.0)
    ratio = jnp.where(d0 > 1e-6, d1 / jnp.maximum(d0, 1e-6), 1.0)
    scale = masked_median(ratio, pm)
    dang = jnp.arctan2(pdy1[iu], pdx1[iu]) - jnp.arctan2(pdy0[iu], pdx0[iu])
    dang = jnp.arctan2(jnp.sin(dang), jnp.cos(dang))   # wrap to [-pi, pi]
    drot = masked_median(dang, pm)
    # no valid pair (all baselines under the 2 px gate, e.g. a tiny
    # region): masked_median returns its float-max sentinel, which
    # multiplied into height/width destroyed the tracker state — keep
    # translation but hold scale/rotation instead
    has_pairs = jnp.any(pm)
    scale = jnp.where(has_pairs, scale, 1.0)
    drot = jnp.where(has_pairs, drot, 0.0)

    good = n_ok >= min_tracks
    new = SfotState(
        cy=jnp.where(good, state.cy + dty, state.cy),
        cx=jnp.where(good, state.cx + dtx, state.cx),
        height=jnp.where(good, state.height * scale, state.height),
        width=jnp.where(good, state.width * scale, state.width),
        yaw=jnp.where(good, state.yaw + drot, state.yaw))
    return new, good


# ---------------------------------------------------------------------------
# Comaniciu 2003 kernel-based mean-shift (scale-adaptive)
# ---------------------------------------------------------------------------

class ComaniciuState(NamedTuple):
    """TrackerMeanShiftComaniciu2003 analog state."""
    q: jnp.ndarray       # [B] key-frame (target) histogram, normalized
    cy: jnp.ndarray
    cx: jnp.ndarray
    ry: jnp.ndarray      # region half-height
    rx: jnp.ndarray      # region half-width
    ry0: float           # original half sizes (minimum-size clamp)
    rx0: float
    num_bins: int
    max_value: float     # intensity range top (reference maxPixelValue)


def _comaniciu_hist(img, cy, cx, ry, rx, num_bins, n: int = 24,
                    max_value: float = 256.0):
    """Epanechnikov-weighted intensity histogram of an axis-aligned
    region sampled on a fixed n x n normalized grid (the reference's
    LocalWeightedHistogramRotRect with rotation fixed to 0).

    Returns (hist [B], bins [n, n], kern [n, n])."""
    u = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, u, indexing="ij")
    kern = jnp.maximum(0.0, 1.0 - (uu * uu + vv * vv))   # Epanechnikov
    yy = cy + uu * ry
    xx = cx + vv * rx
    vals = bilinear(img, yy, xx)
    bins = jnp.clip((vals / max_value * num_bins).astype(jnp.int32), 0,
                    num_bins - 1)
    hist = jnp.zeros((num_bins,), jnp.float32).at[bins.ravel()].add(
        kern.ravel())
    return hist / jnp.maximum(jnp.sum(hist), 1e-12), bins, kern


def comaniciu_init(image, cy, cx, ry, rx, num_bins: int = 32,
                   max_pixel_value: float | None = None) -> ComaniciuState:
    """``max_pixel_value``: top of the intensity range used for binning
    (the reference's maxPixelValue).  Default None auto-detects the
    [0, 1] float convention vs 8-bit [0, 255] from the key frame so
    float images don't collapse into bin 0."""
    img = jnp.asarray(image, jnp.float32)
    if max_pixel_value is None:
        max_pixel_value = 1.0 if float(jnp.max(img)) <= 1.0 else 256.0
    q, _, _ = _comaniciu_hist(img, jnp.float32(cy), jnp.float32(cx),
                              jnp.float32(ry), jnp.float32(rx), num_bins,
                              max_value=max_pixel_value)
    return ComaniciuState(q, jnp.float32(cy), jnp.float32(cx),
                          jnp.float32(ry), jnp.float32(rx),
                          float(ry), float(rx), num_bins,
                          float(max_pixel_value))


def _comaniciu_shift(img, q, cy, cx, ry, rx, num_bins, iterations,
                     min_change, max_value: float = 256.0):
    """Mean-shift to the Bhattacharyya-maximizing location at ONE scale.

    Sample weights w_i = sqrt(q[b_i] / p[b_i]) (Comaniciu 2003 eq. 25);
    with the Epanechnikov profile the shift is the w-weighted centroid.
    Runs a fixed-iteration lax-friendly loop with convergence freezing.
    Returns (cy, cx, bhattacharyya)."""
    n = 24
    u = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, u, indexing="ij")
    cy = jnp.asarray(cy, jnp.float32)
    cx = jnp.asarray(cx, jnp.float32)
    ry = jnp.asarray(ry, jnp.float32)
    rx = jnp.asarray(rx, jnp.float32)

    def body(_, st):
        cy, cx, frozen = st
        p, bins, kern = _comaniciu_hist(img, cy, cx, ry, rx, num_bins, n,
                                        max_value=max_value)
        w = jnp.sqrt(q[bins] / jnp.maximum(p[bins], 1e-12)) * kern
        tot = jnp.sum(w) + 1e-12
        ny = jnp.sum(w * (cy + uu * ry)) / tot
        nx = jnp.sum(w * (cx + vv * rx)) / tot
        small = jnp.hypot(ny - cy, nx - cx) < min_change
        cy2 = jnp.where(frozen, cy, ny)
        cx2 = jnp.where(frozen, cx, nx)
        return cy2, cx2, frozen | small

    cy, cx, _ = jax.lax.fori_loop(
        0, iterations, body, (cy, cx, jnp.asarray(False)))
    p, _, _ = _comaniciu_hist(img, cy, cx, ry, rx, num_bins, n,
                              max_value=max_value)
    bh = jnp.sum(jnp.sqrt(p * q))
    return cy, cx, bh


def comaniciu_track(state: ComaniciuState, image, max_iterations: int = 30,
                    min_change: float = 1e-2, scale_change: float = 0.1,
                    gamma: float = 0.1, minimum_size_ratio: float = 0.25,
                    update_histogram: bool = False) -> ComaniciuState:
    """One frame of TrackerMeanShiftComaniciu2003.process.

    Runs mean-shift at three scales (1 -/+ scale_change), keeps the
    scale with the best Bhattacharyya similarity, blends it with the
    previous scale by ``gamma`` (closer to 0 trusts the new estimate),
    clamps to ``minimum_size_ratio`` of the original size, and
    optionally refreshes the key histogram.
    """
    img = jnp.asarray(image, jnp.float32)
    scales = (1.0 - scale_change, 1.0, 1.0 + scale_change) \
        if scale_change > 0 else (1.0,)
    results = []
    for s in scales:
        ry = state.ry * s
        rx = state.rx * s
        cy, cx, bh = _comaniciu_shift(img, state.q, state.cy, state.cx,
                                      ry, rx, state.num_bins,
                                      max_iterations, min_change,
                                      max_value=state.max_value)
        results.append((float(bh), float(cy), float(cx), float(ry),
                        float(rx)))
    bh, cy, cx, ry, rx = max(results)
    # scale damping + minimum-size clamp
    ry = gamma * float(state.ry) + (1.0 - gamma) * ry
    rx = gamma * float(state.rx) + (1.0 - gamma) * rx
    ry = max(ry, minimum_size_ratio * state.ry0)
    rx = max(rx, minimum_size_ratio * state.rx0)
    q = state.q
    if update_histogram:
        q, _, _ = _comaniciu_hist(img, jnp.float32(cy), jnp.float32(cx),
                                  jnp.float32(ry), jnp.float32(rx),
                                  state.num_bins,
                                  max_value=state.max_value)
    return state._replace(q=q, cy=jnp.float32(cy), cx=jnp.float32(cx),
                          ry=jnp.float32(ry), rx=jnp.float32(rx))
