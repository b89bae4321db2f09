"""Dense optical flow.

Reference analog: boofcv-feature alg/flow/ — HornSchunck.java /
HornSchunckPyramid.java (variational), DenseOpticalFlowBlockPyramid.java
(block matching), DenseOpticalFlowKlt.java (per-pixel KLT).

Design: Horn-Schunck's Jacobi relaxation is an elementwise stencil
iterated under lax.fori_loop — pure elementwise work; the pyramid wrapper upsamples
flow coarse-to-fine.  Block flow evaluates a (2r+1)^2 search
neighborhood as a stacked shift-and-SAD volume, argmin over the
displacement axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.core.pyramid import PyramidConfig
from boofcv_tpu.ip import pyramid_ops
from boofcv_tpu.ip.interpolate import bilinear


def _shift_edge(f, dy, dx):
    """f sampled at (y+dy, x+dx) with EDGE clamping — jnp.roll wraps
    opposite edges together, creating false brightness-constancy
    constraints at borders (a large image fraction at coarse pyramid
    levels, where the corrupted flow seeds every finer level)."""
    h, w = f.shape
    p = jnp.pad(f, 1, mode="edge")
    return p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]


def _gradients_hs(i1, i2):
    """Horn-Schunck derivative estimates (average of forward diffs in the
    two frames, HornSchunck.java's kernel)."""
    dx = 0.5 * (_shift_edge(i1, 0, 1) - _shift_edge(i1, 0, -1)
                + _shift_edge(i2, 0, 1) - _shift_edge(i2, 0, -1)) * 0.5
    dy = 0.5 * (_shift_edge(i1, 1, 0) - _shift_edge(i1, -1, 0)
                + _shift_edge(i2, 1, 0) - _shift_edge(i2, -1, 0)) * 0.5
    dt = i2 - i1
    return dx, dy, dt


def _laplacian_avg(f):
    """6/12-weighted neighborhood average used by Horn-Schunck."""
    up = _shift_edge(f, -1, 0)
    dn = _shift_edge(f, 1, 0)
    lf = _shift_edge(f, 0, -1)
    rt = _shift_edge(f, 0, 1)
    d1 = _shift_edge(f, -1, -1)
    d2 = _shift_edge(f, -1, 1)
    d3 = _shift_edge(f, 1, -1)
    d4 = _shift_edge(f, 1, 1)
    return (up + dn + lf + rt) / 6.0 + (d1 + d2 + d3 + d4) / 12.0


def horn_schunck(image1, image2, alpha: float = 20.0,
                 iterations: int = 200, init_flow=None):
    """Single-level Horn-Schunck (HornSchunck.java).  Returns (u, v)."""
    i1 = image1.astype(jnp.float32)
    i2 = image2.astype(jnp.float32)
    dx, dy, dt = _gradients_hs(i1, i2)
    a2 = jnp.float32(alpha * alpha)
    if init_flow is None:
        u0 = jnp.zeros_like(i1)
        v0 = jnp.zeros_like(i1)
    else:
        u0, v0 = init_flow

    def body(_, uv):
        u, v = uv
        ub = _laplacian_avg(u)
        vb = _laplacian_avg(v)
        num = dx * ub + dy * vb + dt
        den = a2 + dx * dx + dy * dy
        u = ub - dx * num / den
        v = vb - dy * num / den
        return u, v

    return lax.fori_loop(0, iterations, body, (u0, v0))


def _warp_image(image, u, v):
    h, w = image.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    return bilinear(image, ys + v, xs + u)


def horn_schunck_pyramid(image1, image2, alpha: float = 20.0,
                         iterations: int = 100,
                         scales=(1, 2, 4, 8)):
    """Coarse-to-fine Horn-Schunck with warping (HornSchunckPyramid.java).

    Returns (u, v) at full resolution.
    """
    cfg = PyramidConfig(scales=tuple(scales))
    p1 = pyramid_ops.pyramid_average(image1.astype(jnp.float32), cfg)
    p2 = pyramid_ops.pyramid_average(image2.astype(jnp.float32), cfg)
    u = jnp.zeros_like(p1[-1])
    v = jnp.zeros_like(p1[-1])
    for lvl in range(len(scales) - 1, -1, -1):
        i1 = p1[lvl]
        i2 = p2[lvl]
        if u.shape != i1.shape:
            ratio = scales[lvl + 1] / scales[lvl]
            h, w = i1.shape
            ys = jnp.arange(h, dtype=jnp.float32) / ratio
            xs = jnp.arange(w, dtype=jnp.float32) / ratio
            yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
            u = bilinear(u, yy, xx) * ratio
            v = bilinear(v, yy, xx) * ratio
        # warp second image by current flow, solve for residual flow
        i2w = _warp_image(i2, u, v)
        du, dv = horn_schunck(i1, i2w, alpha, iterations)
        u = u + du
        v = v + dv
    return u, v


def _image_grad(f):
    """Central-difference gradient with edge-clamped borders (roll-based
    wraparound creates false constraints that poison coarse pyramid
    levels, where the border is a large image fraction)."""
    fp = jnp.pad(f, 1, mode="edge")
    fy = 0.5 * (fp[2:, 1:-1] - fp[:-2, 1:-1])
    fx = 0.5 * (fp[1:-1, 2:] - fp[1:-1, :-2])
    return fx, fy


def _box_filter(f, r):
    """(2r+1)^2 box sum via two cumsum passes (separable, elementwise only)."""
    c = jnp.cumsum(jnp.pad(f, ((r + 1, r), (0, 0))), axis=0)
    f = c[2 * r + 1:, :] - c[:-2 * r - 1, :]
    c = jnp.cumsum(jnp.pad(f, ((0, 0), (r + 1, r))), axis=1)
    return c[:, 2 * r + 1:] - c[:, :-2 * r - 1]


def brox_warping(image1, image2, alpha: float = 0.04, gamma: float = 2.0,
                 scales=(1, 2, 4, 8), outer_iterations: int = 5,
                 inner_iterations: int = 50, eps: float = 1e-3):
    """Brox et al. 2004 warping flow (BroxWarpingSpacial.java analog).

    Brightness + gradient constancy data terms with the robust penalty
    Psi(s^2) = sqrt(s^2 + eps^2), TV-like smoothness, coarse-to-fine with
    warping.  The reference solves the linearized system with SOR
    (ImplBroxWarpingSpacial); here the lagged-nonlinearity fixed point is
    iterated with Jacobi sweeps — same fixed point, fully parallel on the
    device (SOR's sequential sweep order would serialize).

    Returns (u, v) at full resolution.
    """
    cfg = PyramidConfig(scales=tuple(scales))
    # normalize intensities to [0, 1] — the robust-penalty balance between
    # data and smoothness terms (alpha default) assumes unit-range images
    # (the reference converts to f32 and its defaults assume the same)
    i1 = image1.astype(jnp.float32)
    i2 = image2.astype(jnp.float32)
    scale = jnp.maximum(jnp.maximum(jnp.max(jnp.abs(i1)),
                                    jnp.max(jnp.abs(i2))), 1e-6)
    p1 = pyramid_ops.pyramid_average(i1 / scale, cfg)
    p2 = pyramid_ops.pyramid_average(i2 / scale, cfg)
    e2 = jnp.float32(eps * eps)
    u = jnp.zeros_like(p1[-1])
    v = jnp.zeros_like(p1[-1])

    def level_solve(i1, i2, u, v):
        i1x, i1y = _image_grad(i1)

        def outer(_, uv):
            u, v = uv
            i2w = _warp_image(i2, u, v)
            i2x, i2y = _image_grad(i2w)
            # linearize around the warp: residuals for brightness and
            # both gradient-constancy channels
            it = i2w - i1
            itx = i2x - i1x
            ity = i2y - i1y
            i2xx, i2xy = _image_grad(i2x)
            i2yx, i2yy = _image_grad(i2y)

            def inner(_, duv):
                du, dv = duv
                # robust data weights (lagged nonlinearity)
                r_b = it + i2x * du + i2y * dv
                r_gx = itx + i2xx * du + i2xy * dv
                r_gy = ity + i2yx * du + i2yy * dv
                w_b = jax.lax.rsqrt(r_b * r_b + e2)
                w_g = jax.lax.rsqrt(r_gx * r_gx + r_gy * r_gy + e2)
                # robust smoothness weight on total flow gradient
                ux, uy = _image_grad(u + du)
                vx, vy = _image_grad(v + dv)
                w_s = jax.lax.rsqrt(ux * ux + uy * uy + vx * vx
                                    + vy * vy + e2)
                # Jacobi update of the Euler-Lagrange normal equations
                a11 = w_b * i2x * i2x + gamma * w_g * (i2xx * i2xx
                                                       + i2yx * i2yx)
                a12 = w_b * i2x * i2y + gamma * w_g * (i2xx * i2xy
                                                       + i2yx * i2yy)
                a22 = w_b * i2y * i2y + gamma * w_g * (i2xy * i2xy
                                                       + i2yy * i2yy)
                b1 = -(w_b * i2x * it + gamma * w_g * (i2xx * itx
                                                       + i2yx * ity))
                b2 = -(w_b * i2y * it + gamma * w_g * (i2xy * itx
                                                       + i2yy * ity))
                # smoothness: alpha * div(w_s grad(u+du)); discretized with
                # neighbor averages weighted by w_s midpoints
                def smooth_terms(f, df):
                    tot = f + df
                    s = 0.0
                    wsum = 0.0
                    for ax, sh in ((0, 1), (0, -1), (1, 1), (1, -1)):
                        wn = 0.5 * (w_s + jnp.roll(w_s, sh, ax))
                        s = s + wn * jnp.roll(tot, sh, ax)
                        wsum = wsum + wn
                    return s, wsum
                su, wsu = smooth_terms(u, du)
                sv, wsv = smooth_terms(v, dv)
                A11 = a11 + alpha * wsu
                A22 = a22 + alpha * wsv
                B1 = b1 + alpha * (su - wsu * u)
                B2 = b2 + alpha * (sv - wsv * v)
                det = A11 * A22 - a12 * a12
                det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
                du = (A22 * B1 - a12 * B2) / det
                dv = (A11 * B2 - a12 * B1) / det
                return du, dv

            du, dv = lax.fori_loop(0, inner_iterations, inner,
                                   (jnp.zeros_like(u), jnp.zeros_like(v)))
            return u + du, v + dv

        return lax.fori_loop(0, outer_iterations, outer, (u, v))

    for lvl in range(len(scales) - 1, -1, -1):
        i1 = p1[lvl]
        if u.shape != i1.shape:
            ratio = scales[lvl + 1] / scales[lvl]
            h, w = i1.shape
            yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) / ratio,
                                  jnp.arange(w, dtype=jnp.float32) / ratio,
                                  indexing="ij")
            u = bilinear(u, yy, xx) * ratio
            v = bilinear(v, yy, xx) * ratio
        u, v = level_solve(i1, p2[lvl], u, v)
    return u, v


def dense_klt(image1, image2, radius: int = 3, scales=(1, 2, 4),
              iterations: int = 10):
    """Dense pyramidal Lucas-Kanade flow (DenseOpticalFlowKlt.java analog:
    every pixel is a KLT feature).

    Design: instead of per-feature patch gathers, the per-pixel 2x2
    structure tensor and mismatch vector are BOX-FILTERED whole images —
    each GN iteration is a handful of fused elementwise maps + cumsum box
    sums, identical math to tracking a (2r+1)^2 template at every pixel.
    Returns (u, v, valid).
    """
    cfg = PyramidConfig(scales=tuple(scales))
    p1 = pyramid_ops.pyramid_average(image1.astype(jnp.float32), cfg)
    p2 = pyramid_ops.pyramid_average(image2.astype(jnp.float32), cfg)
    u = jnp.zeros_like(p1[-1])
    v = jnp.zeros_like(p1[-1])

    def level_solve(i1, i2, u, v):
        ix, iy = _image_grad(i1)
        gxx = _box_filter(ix * ix, radius)
        gxy = _box_filter(ix * iy, radius)
        gyy = _box_filter(iy * iy, radius)
        det = gxx * gyy - gxy * gxy
        ok = det > 1e-6

        # Per-pixel GN with the reference KltTracker's stop rules, batched:
        # freeze once the step is tiny (converged) or once the windowed SSD
        # stops improving (the batched analog of the LARGE_ERROR fault —
        # without it unconverged pixels oscillate with growing amplitude
        # and their garbage propagates through coarse-to-fine upsampling).
        big = jnp.float32(3.4e38)

        def body(_, state):
            u, v, ub, vb, best, active = state
            e = _warp_image(i2, u, v) - i1
            ssd = _box_filter(e * e, radius)
            improved = ssd <= best
            take = improved & active
            ub = jnp.where(take, u, ub)
            vb = jnp.where(take, v, vb)
            best = jnp.where(take, ssd, best)
            active = active & improved
            bx = _box_filter(ix * e, radius)
            by = _box_filter(iy * e, radius)
            sd = jnp.where(ok, det, 1.0)
            du = jnp.clip(-(gyy * bx - gxy * by) / sd, -1.0, 1.0)
            dv = jnp.clip(-(gxx * by - gxy * bx) / sd, -1.0, 1.0)
            upd = active & ok
            u = u + jnp.where(upd, du, 0.0)
            v = v + jnp.where(upd, dv, 0.0)
            active = active & (jnp.abs(du) + jnp.abs(dv) > 0.02)
            return u, v, ub, vb, best, active

        _, _, u, v, _, _ = lax.fori_loop(
            0, iterations, body,
            (u, v, u, v, jnp.full_like(i1, big), jnp.ones_like(ok)))
        return u, v, ok

    ok = None
    for lvl in range(len(scales) - 1, -1, -1):
        i1 = p1[lvl]
        if u.shape != i1.shape:
            ratio = scales[lvl + 1] / scales[lvl]
            h, w = i1.shape
            yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) / ratio,
                                  jnp.arange(w, dtype=jnp.float32) / ratio,
                                  indexing="ij")
            u = bilinear(u, yy, xx) * ratio
            v = bilinear(v, yy, xx) * ratio
        u, v, ok = level_solve(i1, p2[lvl], u, v)
    return u, v, ok


def block_flow(image1, image2, search_radius: int = 4,
               region_radius: int = 3):
    """Dense block-matching flow (DenseOpticalFlowBlockPyramid): for each
    pixel the displacement in [-r, r]^2 minimizing SAD over a
    (2*region_radius+1)^2 window.  Returns (u, v, sad)."""
    i1 = image1.astype(jnp.float32)
    i2 = image2.astype(jnp.float32)
    h, w = i1.shape
    rr = region_radius
    sads = []
    disps = []
    sr = search_radius
    # pad with a large sentinel so displacement candidates that fall
    # off-image score terribly instead of matching WRAPPED content from
    # the opposite edge (jnp.roll previously let e.g. bottom-edge pixels
    # "match" the top of the image; the reference clamps the search
    # region to bounds)
    i2p = jnp.pad(i2, sr, constant_values=1e6)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            shifted = i2p[sr + dy: sr + dy + h, sr + dx: sr + dx + w]
            e = jnp.abs(i1 - shifted)
            e = jnp.minimum(e, 1e6)
            # box sum
            c = jnp.cumsum(jnp.pad(e, ((rr, rr), (rr, rr))), axis=0)
            c = jnp.pad(c, ((1, 0), (0, 0)))
            e = c[2 * rr + 1:, :] - c[: -2 * rr - 1, :]
            c = jnp.cumsum(e, axis=1)
            c = jnp.pad(c, ((0, 0), (1, 0)))
            e = c[:, 2 * rr + 1:] - c[:, : -2 * rr - 1]
            sads.append(e)
            disps.append((dx, dy))
    vol = jnp.stack(sads, axis=0)
    best = jnp.argmin(vol, axis=0)
    dxs = jnp.asarray([d[0] for d in disps], jnp.float32)
    dys = jnp.asarray([d[1] for d in disps], jnp.float32)
    return dxs[best], dys[best], jnp.min(vol, axis=0)
