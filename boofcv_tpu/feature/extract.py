"""Non-maximum suppression + N-best selection.

Reference analog: boofcv-feature alg/feature/detect/extract/NonMaxBlock.java
(strict/relaxed block nonmax), SelectNBestFeatures.java, and the
GeneralFeatureDetector pipeline (alg/feature/detect/interest/
GeneralFeatureDetector.java:47).

Formulation: nonmax = compare against a max-pool of the neighborhood;
"N best" = top_k over the masked intensity image.  Output is the standard
fixed-capacity detection set: ys, xs, scores, valid-mask, all shape [N].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class Detections(NamedTuple):
    """Fixed-capacity feature set (analog of QueueCorner + intensity)."""
    ys: jnp.ndarray      # [N] int32 (or f32 after subpixel)
    xs: jnp.ndarray      # [N]
    scores: jnp.ndarray  # [N] f32
    valid: jnp.ndarray   # [N] bool

    @property
    def capacity(self) -> int:
        return self.ys.shape[0]


def _window_max(intensity: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Max over (2r+1)^2 neighborhood via reduce_window."""
    n = 2 * radius + 1
    return lax.reduce_window(
        intensity, -jnp.inf, lax.max,
        window_dimensions=(n, n), window_strides=(1, 1), padding="SAME",
    )


def nonmax_mask(intensity: jnp.ndarray, radius: int = 2,
                threshold: float = 0.0, border: int = 0,
                strict: bool = True) -> jnp.ndarray:
    """Boolean local-maximum mask (NonMaxBlock strict semantics).

    strict=True requires the pixel to be >= neighborhood max AND unique
    enough: BoofCV's strict mode rejects plateaus; we approximate plateau
    rejection by requiring the pixel to equal the window max and be
    strictly greater than the window max with itself excluded.  For speed
    we implement: I == windowmax(I) and I > threshold, with plateau ties
    broken by raster order via a tiny index epsilon.
    """
    h, w = intensity.shape
    wmax = _window_max(intensity, radius)
    mask = (intensity >= wmax) & (intensity > threshold)
    if strict:
        # break plateau ties: keep only the raster-first of equal maxima by
        # adding a monotone decreasing epsilon ramp before comparison
        ramp = (jnp.arange(h * w, dtype=jnp.float32).reshape(h, w))
        eps = jnp.finfo(jnp.float32).eps
        tie = intensity - ramp * eps * jnp.maximum(jnp.abs(intensity), 1.0)
        mask = mask & (tie >= _window_max(tie, radius))
    if border > 0:
        edge = jnp.zeros_like(mask)
        edge = edge.at[border:h - border, border:w - border].set(True)
        mask = mask & edge
    return mask


def select_n_best(intensity: jnp.ndarray, mask: jnp.ndarray,
                  max_features: int) -> Detections:
    """Top-k detections from a masked intensity image (SelectNBestFeatures)."""
    h, w = intensity.shape
    flat = jnp.where(mask, intensity, -jnp.inf).ravel()
    scores, idx = lax.top_k(flat, max_features)
    valid = jnp.isfinite(scores)
    ys = (idx // w).astype(jnp.int32)
    xs = (idx % w).astype(jnp.int32)
    safe_scores = jnp.where(valid, scores, 0.0)
    return Detections(jnp.where(valid, ys, 0), jnp.where(valid, xs, 0),
                      safe_scores, valid)


def detect(intensity: jnp.ndarray, max_features: int, radius: int = 2,
           threshold: float = 0.0, border: int = 0) -> Detections:
    """intensity -> nonmax -> top-k (GeneralFeatureDetector.process:107)."""
    mask = nonmax_mask(intensity, radius, threshold, border)
    return select_n_best(intensity, mask, max_features)


def subpixel_quadratic(intensity: jnp.ndarray, det: Detections) -> tuple:
    """2D quadratic peak interpolation around each detection.

    Analog of the reference's polynomial subpixel step (used by SURF/SIFT
    detectors).  Returns float (ys, xs).
    """
    h, w = intensity.shape
    y = det.ys
    x = det.xs
    yc = jnp.clip(y, 1, h - 2)
    xc = jnp.clip(x, 1, w - 2)

    def at(dy, dx):
        return intensity[yc + dy, xc + dx]

    dx_ = (at(0, 1) - at(0, -1)) * 0.5
    dy_ = (at(1, 0) - at(-1, 0)) * 0.5
    dxx = at(0, 1) - 2 * at(0, 0) + at(0, -1)
    dyy = at(1, 0) - 2 * at(0, 0) + at(-1, 0)
    ox = jnp.where(dxx != 0, -dx_ / dxx, 0.0)
    oy = jnp.where(dyy != 0, -dy_ / dyy, 0.0)
    ox = jnp.clip(ox, -0.5, 0.5)
    oy = jnp.clip(oy, -0.5, 0.5)
    return (yc + oy).astype(jnp.float32), (xc + ox).astype(jnp.float32)


def detect_tracks(image, max_features: int, radius: int = 6,
                  threshold: float = 1.0, border: int = 12,
                  shi_tomasi_radius: int = 2):
    """Shi-Tomasi corner detection for KLT track seeding — the shared
    recipe of the 2D-motion host drivers (stitch2d, mono-plane VO,
    overhead VO), previously copy-pasted in each.

    Returns (ys [N] f32, xs [N] f32, valid [N] bool).
    """
    import jax.numpy as jnp
    from boofcv_tpu.feature import intensity as _intensity

    inten = _intensity.shi_tomasi(image, radius=shi_tomasi_radius)
    det = detect(inten, max_features=max_features, radius=radius,
                 threshold=threshold, border=border)
    return (det.ys.astype(jnp.float32), det.xs.astype(jnp.float32),
            det.valid)
