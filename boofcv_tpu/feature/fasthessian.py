"""SURF Fast-Hessian detector on the integral image.

Reference analog: boofcv-feature alg/feature/detect/interest/
FastHessianFeatureDetector.java:85,156,198,230 — Hessian-determinant blob
responses computed with box filters over the integral image at a ladder of
filter sizes, 3x3x3 scale-space nonmax, quadratic subpixel refinement.

Design: all (pixel, size) responses for an octave are evaluated as a
dense batched gather over the integral image (sizes stacked on a leading
axis), nonmax = reduce_window over the stack, detections = top_k.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
from jax import lax

from boofcv_tpu.ip import integral as ii_ops
from boofcv_tpu.feature.extract import Detections, _window_max


class ScaleDetections(NamedTuple):
    ys: jnp.ndarray      # [N] f32 (subpixel)
    xs: jnp.ndarray      # [N] f32
    scales: jnp.ndarray  # [N] f32 (SURF scale = 1.2 * size / 9)
    scores: jnp.ndarray  # [N]
    valid: jnp.ndarray   # [N] bool


def hessian_response(ii: jnp.ndarray, size: int) -> jnp.ndarray:
    """Hessian-det response image for one box-filter size (full resolution).

    det = Dxx*Dyy - (0.9*Dxy)^2, normalized by filter area^2 (as in the
    SURF paper / the reference's implementation).
    """
    h, w = ii.shape
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    # static-shift whole-image responses: pad+slice compiles to copies
    # instead of a gather with computed indices (ii[grid])
    dxx = ii_ops.deriv_xx_grid(ii, size)
    dyy = ii_ops.deriv_yy_grid(ii, size)
    dxy = ii_ops.deriv_xy_grid(ii, size)
    norm = 1.0 / (size * size)
    dxx = dxx * norm
    dyy = dyy * norm
    dxy = dxy * norm
    det = dxx * dyy - (0.9 * dxy) ** 2
    # mask the border where the filter sticks out
    r = size // 2 + 1
    valid = (ys >= r) & (ys < h - r) & (xs >= r) & (xs < w - r)
    return jnp.where(valid, det, -jnp.inf)


def detect(ii: jnp.ndarray, max_features: int,
           sizes: Sequence[int] = (9, 15, 21, 27),
           nonmax_radius: int = 1, threshold: float = 0.0) -> ScaleDetections:
    """Single-octave scale-space detection (detectOctave :198).

    The reference ladders sizes per octave {9,15,21,27}, {15,27,39,51}, ...
    Call this per octave and merge, or use :func:`detect_multi_octave`.
    """
    stack = jnp.stack([hessian_response(ii, s) for s in sizes], axis=0)  # [S, H, W]
    n_s, h, w = stack.shape
    # 3x3x3 nonmax: max over scale triplet and spatial window
    wmax = jnp.stack([_window_max(stack[i], nonmax_radius) for i in range(n_s)], axis=0)
    neigh_max = jnp.full_like(stack, -jnp.inf)
    for i in range(n_s):
        lo, hi = max(0, i - 1), min(n_s, i + 2)
        neigh_max = neigh_max.at[i].set(jnp.max(wmax[lo:hi], axis=0))
    is_peak = (stack >= neigh_max) & (stack > threshold)
    # only interior scales can be scale-space maxima (reference skips ends)
    interior = jnp.zeros((n_s, 1, 1), dtype=bool).at[1:-1].set(True)
    is_peak = is_peak & interior

    flat = jnp.where(is_peak, stack, -jnp.inf).reshape(-1)
    scores, idx = lax.top_k(flat, max_features)
    valid = jnp.isfinite(scores)
    si = idx // (h * w)
    rem = idx % (h * w)
    ys = (rem // w).astype(jnp.float32)
    xs = (rem % w).astype(jnp.float32)

    # quadratic subpixel in x, y and scale (FastHessian :230)
    sizes_arr = jnp.asarray(sizes, dtype=jnp.float32)

    def center_val(s, y, x):
        sc = jnp.clip(s, 0, n_s - 1)
        yc = jnp.clip(y, 1, h - 2)
        xc = jnp.clip(x, 1, w - 2)
        return stack[sc, yc, xc]

    yi = ys.astype(jnp.int32)
    xi = xs.astype(jnp.int32)
    v = center_val(si, yi, xi)
    dx = (center_val(si, yi, xi + 1) - center_val(si, yi, xi - 1)) * 0.5
    dy = (center_val(si, yi + 1, xi) - center_val(si, yi - 1, xi)) * 0.5
    dxx = center_val(si, yi, xi + 1) - 2 * v + center_val(si, yi, xi - 1)
    dyy = center_val(si, yi + 1, xi) - 2 * v + center_val(si, yi - 1, xi)
    # peaks bordering the -inf masked rim give non-finite derivatives; the
    # reference skips subpixel there (checkMax fails) — emit offset 0
    safe_div = lambda num, den: jnp.nan_to_num(
        jnp.where(den != 0, -num / den, 0.0), nan=0.0, posinf=0.0, neginf=0.0)
    ox = jnp.clip(safe_div(dx, dxx), -0.5, 0.5)
    oy = jnp.clip(safe_div(dy, dyy), -0.5, 0.5)

    ds_ = (center_val(si + 1, yi, xi) - center_val(si - 1, yi, xi)) * 0.5
    dss = center_val(si + 1, yi, xi) - 2 * v + center_val(si - 1, yi, xi)
    os_ = jnp.clip(safe_div(ds_, dss), -0.5, 0.5)
    size_step = sizes_arr[1] - sizes_arr[0] if n_s > 1 else 6.0
    size_interp = sizes_arr[jnp.clip(si, 0, n_s - 1)] + os_ * size_step
    scale = 1.2 * size_interp / 9.0

    safe = lambda a: jnp.where(valid, a, 0.0)
    return ScaleDetections(safe(ys + oy), safe(xs + ox), safe(scale),
                           jnp.where(valid, scores, 0.0), valid)


def detect_multi_octave(ii: jnp.ndarray, max_features_per_octave: int,
                        num_octaves: int = 3) -> ScaleDetections:
    """Reference-style octave ladder: sizes {9,15,21,27} + 12*2^o steps."""
    all_out = []
    for o in range(num_octaves):
        step = 6 * (2 ** o)
        # reference ladder (FastHessianFeatureDetector octave sizes):
        # {9,15,21,27}, {15,27,39,51}, {27,51,75,99} — each octave's
        # first size is the previous octave's second, i.e. base = step+3
        # (the old 9 + 3*step//2 gave {27,39,51,63} for octave 1,
        # skipping the mid-scale band entirely)
        sizes = tuple(step + 3 + i * step for i in range(4))
        all_out.append(detect(ii, max_features_per_octave, sizes))
    return ScaleDetections(
        jnp.concatenate([o.ys for o in all_out]),
        jnp.concatenate([o.xs for o in all_out]),
        jnp.concatenate([o.scales for o in all_out]),
        jnp.concatenate([o.scores for o in all_out]),
        jnp.concatenate([o.valid for o in all_out]),
    )
