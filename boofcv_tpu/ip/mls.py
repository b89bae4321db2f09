"""Moving-least-squares point-controlled image deformation.

Reference analog: boofcv-ip alg/distort/mls/ImageDeformPointMLS_F32.java
(Schaefer et al. 2006 — affine / similarity / rigid variants, evaluated
on a coarse grid then interpolated).

Design: the per-grid-point solve is closed-form and fully batched
over the grid (no loops over control points either); the dense warp is
the usual inverse-map bilinear gather.
"""

from __future__ import annotations

import jax.numpy as jnp

from boofcv_tpu.ip.interpolate import bilinear


def _weights(v, p, alpha: float = 2.0):
    """w_i = 1/|p_i - v|^(2 alpha): v [..., 2], p [K, 2] -> [..., K]."""
    d2 = jnp.sum((v[..., None, :] - p) ** 2, axis=-1)
    return 1.0 / jnp.maximum(d2, 1e-9) ** (alpha / 1.0)


def mls_affine(src_pts, dst_pts, height: int, width: int,
               alpha: float = 2.0):
    """Dense backward map for affine MLS deformation.

    src_pts/dst_pts: [K, 2] (x, y) control points — the OUTPUT image's
    pixel v maps back to f(v) in the source.  We build the map from
    dst->src control pairs so the warp pulls source pixels.
    Returns (map_y, map_x) [H, W].
    """
    p = jnp.asarray(dst_pts, jnp.float32)   # control in output space
    q = jnp.asarray(src_pts, jnp.float32)   # where they come from
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32), indexing="ij")
    v = jnp.stack([xs, ys], axis=-1)        # [H, W, 2]
    w = _weights(v, p, alpha)               # [H, W, K]
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    pstar = jnp.einsum("hwk,kj->hwj", w, p) / wsum
    qstar = jnp.einsum("hwk,kj->hwj", w, q) / wsum
    ph = p - pstar[..., None, :]            # [H, W, K, 2]
    qh = q - qstar[..., None, :]
    # M = (sum w p^ p^T)^-1 (sum w p^ q^T); f(v) = (v - p*) M + q*
    A = jnp.einsum("hwk,hwki,hwkj->hwij", w, ph, ph)
    B = jnp.einsum("hwk,hwki,hwkj->hwij", w, ph, qh)
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
    Ainv = jnp.stack([
        jnp.stack([A[..., 1, 1], -A[..., 0, 1]], -1),
        jnp.stack([-A[..., 1, 0], A[..., 0, 0]], -1)], -2) / det[..., None, None]
    M = Ainv @ B
    rel = v - pstar
    f = jnp.einsum("hwi,hwij->hwj", rel, M) + qstar
    return f[..., 1], f[..., 0]


def mls_similarity(src_pts, dst_pts, height: int, width: int,
                   alpha: float = 2.0):
    """Similarity-constrained MLS backward map (rotation+scale)."""
    p = jnp.asarray(dst_pts, jnp.float32)
    q = jnp.asarray(src_pts, jnp.float32)
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32), indexing="ij")
    v = jnp.stack([xs, ys], axis=-1)
    w = _weights(v, p, alpha)
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    pstar = jnp.einsum("hwk,kj->hwj", w, p) / wsum
    qstar = jnp.einsum("hwk,kj->hwj", w, q) / wsum
    ph = p - pstar[..., None, :]
    qh = q - qstar[..., None, :]
    mu = jnp.einsum("hwk,hwki->hw", w, ph * ph)
    mu = jnp.maximum(mu, 1e-9)
    rel = v - pstar                          # [H, W, 2]
    relp = jnp.stack([rel[..., 1], -rel[..., 0]], axis=-1)   # -perp
    php = jnp.stack([ph[..., 1], -ph[..., 0]], axis=-1)
    # A_i = w_i [p^; -p^perp] [v-p*; -(v-p*)perp]^T (2x2), f = sum q^ A_i / mu + q*
    r1 = jnp.stack([jnp.einsum("hwki,hwi->hwk", ph, rel),
                    jnp.einsum("hwki,hwi->hwk", ph, relp)], axis=-1)
    r2 = jnp.stack([jnp.einsum("hwki,hwi->hwk", php, rel),
                    jnp.einsum("hwki,hwi->hwk", php, relp)], axis=-1)
    Ai = jnp.stack([r1, r2], axis=-2)        # [H, W, K, 2, 2]
    f = jnp.einsum("hwk,hwki,hwkij->hwj", w, qh, Ai) / mu[..., None] + qstar
    return f[..., 1], f[..., 0]


def deform(image, src_pts, dst_pts, kind: str = "affine",
           alpha: float = 2.0):
    """Warp image so that src control points land on dst points."""
    h, w = image.shape[:2]
    fn = {"affine": mls_affine, "similarity": mls_similarity}[kind]
    my, mx = fn(src_pts, dst_pts, h, w, alpha)
    return bilinear(jnp.asarray(image, jnp.float32), my, mx)
