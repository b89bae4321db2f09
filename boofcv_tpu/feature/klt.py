"""Batched pyramidal KLT tracker.

Reference analog: boofcv-feature alg/tracker/klt/KltTracker.java:55
(inverse-compositional translation-only KLT, per-feature Gauss-Newton on a
square template), PyramidKltTracker.java:37 (coarse-to-fine over the
pyramid), KltTrackFault.java (per-track fault codes).

Design (SURVEY §7 stage 2): ALL tracks are advanced simultaneously —
track state is a fixed-capacity [N] pool; each GN iteration is a batched
bilinear patch gather + batched 2x2 solve (vmap across features), levels
unrolled coarse-to-fine, iterations via lax.fori_loop.  One jit, zero
host sync per frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.ip.interpolate import (gather_windows, sample_rect_bilinear,
                                       sample_rect_bilinear_multi)


# Fault codes (KltTrackFault analog)
TRACK_OK = 0
FAULT_OUT_OF_BOUNDS = 1
FAULT_FAILED = 2          # singular Gauss-Newton system
FAULT_DRIFTED = 3         # did not converge
FAULT_LARGE_ERROR = 4     # per-pixel SSD error above maxPerPixelError


@dataclass(frozen=True)
class KltConfig:
    """PkltConfig analog (struct/pyramid config lives separately)."""
    template_radius: int = 3
    max_iterations: int = 8
    max_per_pixel_error: float = 25.0
    min_determinant: float = 0.001
    convergence_tol: float = 0.01  # pixels at the level's scale
    # "windowed": ONE window gather per level per track, then every GN
    # iteration resamples inside the window with two 2-tap interpolation
    # matmuls — no gather on the iteration critical path.  "gather":
    # flat image gather per iteration (the equivalence-test oracle).
    method: str = "windowed"


class KltTemplates(NamedTuple):
    """Per-track templates at every pyramid level.

    desc[level]: [N, P, P] grayscale template; grad_x/grad_y likewise.
    Stored per level exactly like PyramidKltFeature in the reference.
    """
    desc: Tuple[jnp.ndarray, ...]
    grad_x: Tuple[jnp.ndarray, ...]
    grad_y: Tuple[jnp.ndarray, ...]


def _patch_coords(cy, cx, radius):
    d = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    yy = cy[:, None, None] + d[None, :, None]
    xx = cx[:, None, None] + d[None, None, :]
    return yy, xx


def sample_templates(pyramid: Sequence[jnp.ndarray],
                     grads: Tuple[Sequence[jnp.ndarray], Sequence[jnp.ndarray]],
                     ys: jnp.ndarray, xs: jnp.ndarray,
                     scales: Sequence[int], radius: int) -> KltTemplates:
    """Sample template + gradient patches at every level for N features.

    ys/xs are level-0 (full-res) float coordinates.  Analog of
    PointTrackerKltPyramid.addNewTracks setting descriptions.
    """
    dxs, dys = grads
    desc, gx, gy = [], [], []
    for lvl, s in enumerate(scales):
        cy = ys / s
        cx = xs / s
        stack = jnp.stack([pyramid[lvl], dxs[lvl], dys[lvl]])
        d, g1, g2 = sample_rect_bilinear_multi(stack, cy, cx, radius)
        desc.append(d)
        gx.append(g1)
        gy.append(g2)
    return KltTemplates(tuple(desc), tuple(gx), tuple(gy))


def _interp_matrix(frac, base, p, wsz, dtype):
    """[N, p, wsz] two-tap bilinear row-interpolation matrix.

    M[n, i, a] = (1-frac[n]) * [a == base[n]+i] + frac[n] * [a == base[n]+i+1]
    so that (M @ window_rows) linearly interpolates p samples at positions
    base+frac, base+frac+1, ... inside a wsz-wide window.
    """
    a = jnp.arange(wsz, dtype=jnp.int32)[None, None, :]
    i = jnp.arange(p, dtype=jnp.int32)[None, :, None]
    lo = base[:, None, None] + i
    f = frac[:, None, None].astype(dtype)
    return ((a == lo).astype(dtype) * (1 - f)
            + (a == lo + 1).astype(dtype) * f)


def window_shape(radius: int):
    """(WY, WX) of the windowed level's per-track window: room for the
    (P+1)-span bilinear support plus ~8 px of drift in y and ~4 px in x."""
    return (24, 16) if 2 * radius + 3 <= 16 else (32, 32)


def _track_level_windowed(image, desc, gx, gy, cy, cx, cfg: KltConfig):
    """One KLT level, gather-free GN loop (see KltConfig.method).

    Gathers each track's (WY, WX) neighborhood once, centered on the
    track, then every GN iteration resamples the (P, P) patch at the
    current sub-pixel position as  Wy @ window @ Wx^T  with 2-tap
    interpolation matrices — batched matmuls instead of gathers.  Tracks
    whose motion within the level exceeds the window margin (~8 px in y,
    ~4 px in x, beyond KLT's convergence basin anyway) clamp to the
    window edge and are caught by the out-of-bounds fault.
    """
    n = desc.shape[0]
    r = cfg.template_radius
    p = 2 * r + 1
    wy_sz, wx_sz = window_shape(r)
    h, w = image.shape
    img = image if jnp.issubdtype(image.dtype, jnp.floating) \
        else image.astype(jnp.float32)
    dt = jnp.float32

    gxx = jnp.sum(gx * gx, axis=(1, 2))
    gxy = jnp.sum(gx * gy, axis=(1, 2))
    gyy = jnp.sum(gy * gy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    area = p * p
    ok_det = det / area >= cfg.min_determinant
    safe_det = jnp.where(det == 0, 1.0, det)

    cy = cy.astype(dt)
    cx = cx.astype(dt)
    # window origins: the (P+1)-span bilinear support sits in the middle
    # of the window, clamped into the image
    oy = jnp.clip(jnp.floor(cy).astype(jnp.int32) - r - (wy_sz - p - 1) // 2,
                  0, max(h - wy_sz, 0))
    ox = jnp.clip(jnp.floor(cx).astype(jnp.int32) - r - (wx_sz - p - 1) // 2,
                  0, max(w - wx_sz, 0))
    py0 = cy - r - oy.astype(dt)
    px0 = cx - r - ox.astype(dt)
    win = gather_windows(img, oy, ox, wy_sz, wx_sz)

    # in-window patch top-left positions and their clamp bounds
    margin_y = wy_sz - p - 1
    margin_x = wx_sz - p - 1

    def resample(py, px):
        py = jnp.clip(py, 0.0, margin_y)
        px = jnp.clip(px, 0.0, margin_x)
        by = jnp.floor(py)
        bx = jnp.floor(px)
        wym = _interp_matrix(py - by, by.astype(jnp.int32), p, wy_sz, dt)
        wxm = _interp_matrix(px - bx, bx.astype(jnp.int32), p, wx_sz, dt)
        t = jnp.einsum("nab,njb->naj", win, wxm,
                       precision=lax.Precision.HIGHEST)
        return jnp.einsum("nia,naj->nij", wym, t,
                          precision=lax.Precision.HIGHEST)

    def body(state):
        it, py, px, done, _ = state
        cur = resample(py, px)
        err = cur - desc
        pp = jnp.mean(jnp.abs(err), axis=(1, 2))
        bx_ = jnp.sum(err * gx, axis=(1, 2))
        by_ = jnp.sum(err * gy, axis=(1, 2))
        dx = (gyy * bx_ - gxy * by_) / safe_det
        dy = (gxx * by_ - gxy * bx_) / safe_det
        step_y = jnp.where(done, 0.0, dy)
        step_x = jnp.where(done, 0.0, dx)
        py = py - step_y
        px = px - step_x
        conv = (jnp.abs(dx) < cfg.convergence_tol) \
            & (jnp.abs(dy) < cfg.convergence_tol)
        return it + 1, py, px, done | conv, pp

    def cond(state):
        it, _, _, done, _ = state
        return (it < cfg.max_iterations) & ~jnp.all(done)

    done0 = jnp.zeros((n,), bool)
    pp0 = jnp.zeros((n,), dt)
    _, py, px, _, per_pixel = lax.while_loop(
        cond, body, (jnp.int32(0), py0, px0, done0, pp0))

    cy_out = jnp.clip(py, 0.0, margin_y) + r + oy.astype(dt)
    cx_out = jnp.clip(px, 0.0, margin_x) + r + ox.astype(dt)
    in_bounds = ((cy_out >= r) & (cy_out <= h - 1 - r)
                 & (cx_out >= r) & (cx_out <= w - 1 - r)
                 # clamped against the window edge == failed to converge
                 & (py > 0) & (py < margin_y) & (px > 0) & (px < margin_x))
    fault = jnp.full((n,), TRACK_OK, dtype=jnp.int32)
    fault = jnp.where(per_pixel > cfg.max_per_pixel_error,
                      FAULT_LARGE_ERROR, fault)
    fault = jnp.where(~ok_det, FAULT_FAILED, fault)
    fault = jnp.where(~in_bounds, FAULT_OUT_OF_BOUNDS, fault)
    return cy_out, cx_out, fault


def _track_level(image, desc, gx, gy, cy, cx, cfg: KltConfig):
    """One level of inverse-compositional KLT for all N tracks at once —
    the per-iteration flat-gather XLA formulation (the windowed path is
    the production one; this is kept as the equivalence-test oracle).

    image: [h, w]; desc/gx/gy: [N, P, P]; cy/cx: [N] initial positions at
    this level's scale.  Returns (cy, cx, fault).
    """
    n = desc.shape[0]
    r = cfg.template_radius
    h, w = image.shape

    # Inverse-compositional: Hessian from template gradients, constant
    # across iterations (KltTracker precomputes Gxx,Gxy,Gyy at :147).
    gxx = jnp.sum(gx * gx, axis=(1, 2))
    gxy = jnp.sum(gx * gy, axis=(1, 2))
    gyy = jnp.sum(gy * gy, axis=(1, 2))
    det = gxx * gyy - gxy * gxy
    # reference compares det/area against minDeterminant (KltTracker.java:251)
    area = (2 * r + 1) ** 2
    ok_det = det / area >= cfg.min_determinant

    def body(_, state):
        cy, cx, done, _ = state
        cur = sample_rect_bilinear(image, cy, cx, r)
        err = cur - desc  # [N, P, P]
        # per-pixel error at the CURRENT position, carried out of the loop
        # so the fault check needs no extra gather after convergence (at
        # the exit the step is ~0, so this equals the final-position error)
        pp = jnp.mean(jnp.abs(err), axis=(1, 2))
        bx = jnp.sum(err * gx, axis=(1, 2))
        by = jnp.sum(err * gy, axis=(1, 2))
        safe_det = jnp.where(det == 0, 1.0, det)
        dx = (gyy * bx - gxy * by) / safe_det
        dy = (gxx * by - gxy * bx) / safe_det
        step = jnp.where(done[:, None], 0.0, jnp.stack([dy, dx], axis=1))
        cy = cy - step[:, 0]
        cx = cx - step[:, 1]
        converged = (jnp.abs(dx) < cfg.convergence_tol) & (jnp.abs(dy) < cfg.convergence_tol)
        return cy, cx, done | converged, pp

    done0 = jnp.zeros((n,), dtype=bool)
    # float32 regardless of image dtype: the loop body produces float
    # residual means, and a uint8 pyramid made the while_loop carry
    # dtypes mismatch (the windowed path casts its image; this gather
    # path is the equivalence-test oracle and must accept the same
    # inputs)
    pp0 = jnp.zeros((n,), jnp.float32)
    # while_loop with an all-converged early exit: tracks typically settle
    # in 3-5 GN steps, so running the full max_iterations (masked) wasted
    # ~3x the gather bandwidth of the level
    def cond(state):
        it, _, _, done, _ = state
        return (it < cfg.max_iterations) & ~jnp.all(done)

    def wbody(state):
        # two GN steps per trip: halves the serialized loop-condition
        # round-trips (the all-converged reduction) per gather
        it, cy, cx, done, pp = state
        cy, cx, done, pp = body(it, (cy, cx, done, pp))
        cy, cx, done, pp = body(it, (cy, cx, done, pp))
        return it + 2, cy, cx, done, pp

    _, cy, cx, converged, per_pixel = lax.while_loop(
        cond, wbody, (jnp.int32(0), cy, cx, done0, pp0))
    in_bounds = ((cy >= r) & (cy <= h - 1 - r) & (cx >= r) & (cx <= w - 1 - r))

    # NOTE: running out of iterations is NOT a fault — the reference's
    # KltTracker accepts the iteration-limit estimate and only rejects on
    # bounds / singular system / residual error (KltTracker.java:251).
    fault = jnp.full((n,), TRACK_OK, dtype=jnp.int32)
    fault = jnp.where(per_pixel > cfg.max_per_pixel_error, FAULT_LARGE_ERROR, fault)
    fault = jnp.where(~ok_det, FAULT_FAILED, fault)
    fault = jnp.where(~in_bounds, FAULT_OUT_OF_BOUNDS, fault)
    return cy, cx, fault


def track_pyramid(pyramid: Sequence[jnp.ndarray], templates: KltTemplates,
                  ys: jnp.ndarray, xs: jnp.ndarray,
                  scales: Sequence[int], cfg: KltConfig):
    """Coarse-to-fine tracking of all N features (PyramidKltTracker.track:113).

    ys/xs: [N] full-resolution positions.  Returns (ys, xs, fault) — fault
    is the worst fault seen at any level (OK if all levels tracked).
    Level implementation follows cfg.method ("windowed" default — see
    KltConfig; "gather" keeps the per-iteration flat-gather XLA path for
    the equivalence tests).
    """
    if cfg.method not in ("windowed", "gather"):
        raise ValueError(
            f"unknown KltConfig.method {cfg.method!r}: 'windowed' or "
            "'gather'")
    n = ys.shape[0]
    fault = jnp.full((n,), TRACK_OK, dtype=jnp.int32)
    num_levels = len(scales)
    cy = ys / scales[-1]
    cx = xs / scales[-1]
    for lvl in range(num_levels - 1, -1, -1):
        s = scales[lvl]
        if cfg.method != "gather":
            cy_l, cx_l, f = _track_level_windowed(
                pyramid[lvl], templates.desc[lvl], templates.grad_x[lvl],
                templates.grad_y[lvl], cy, cx, cfg)
        else:
            cy_l, cx_l, f = _track_level(
                pyramid[lvl], templates.desc[lvl], templates.grad_x[lvl],
                templates.grad_y[lvl], cy, cx, cfg)
        # tracks that fault keep their pre-level position (will be dropped)
        good = f == TRACK_OK
        cy = jnp.where(good, cy_l, cy)
        cx = jnp.where(good, cx_l, cx)
        fault = jnp.maximum(fault, f)
        if lvl > 0:
            ratio = s / scales[lvl - 1]
            cy = cy * ratio
            cx = cx * ratio
    return cy, cx, fault
