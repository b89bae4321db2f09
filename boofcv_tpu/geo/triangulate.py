"""Triangulation of 3D points from observations.

Reference analog: boofcv-geo alg/geo/triangulate/ —
Triangulate2ViewsGeometricMetric.java (midpoint closest-point),
TriangulateMetricLinearDLT.java:46 (N-view homogeneous DLT), and the
nonlinear reprojection refiners.

Design: all functions broadcast over leading batch axes so every track
in a scene triangulates as one batched 4x4 eigendecomposition / 3x3 solve.
Observations are *normalized image coordinates* (K^-1 pixels) as in the
reference's metric triangulation.
"""

from __future__ import annotations

import jax.numpy as jnp


def triangulate_two_view_linear(p1, p2, R, t):
    """Linear (DLT) two-view triangulation in camera-1 frame.

    View 1 is (I, 0); view 2 is (R, t) mapping camera-1 points to camera-2
    (x2 = R x1 + t).  p1, p2: [..., N, 2] normalized coords.  Returns
    [..., N, 3].
    """
    p1 = p1.astype(jnp.float64)
    p2 = p2.astype(jnp.float64)
    R = R.astype(jnp.float64)
    t = t.astype(jnp.float64)
    # Projection rows: P1 = [I|0], P2 = [R|t]
    # A X = 0 with rows: x1*P1[2]-P1[0]; y1*P1[2]-P1[1]; same for view 2.
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    # rows for P1
    r0 = jnp.stack([-o, z, x1, z], axis=-1)
    r1 = jnp.stack([z, -o, y1, z], axis=-1)
    # rows for P2: x2*(R[2]·X + t2) - (R[0]·X + t0) = 0
    Rb = jnp.broadcast_to(R[..., None, :, :], p1.shape[:-1] + (3, 3))
    tb = jnp.broadcast_to(t[..., None, :], p1.shape[:-1] + (3,))
    r2 = jnp.concatenate([x2[..., None] * Rb[..., 2, :] - Rb[..., 0, :],
                          (x2 * tb[..., 2] - tb[..., 0])[..., None]], axis=-1)
    r3 = jnp.concatenate([y2[..., None] * Rb[..., 2, :] - Rb[..., 1, :],
                          (y2 * tb[..., 2] - tb[..., 1])[..., None]], axis=-1)
    A = jnp.stack([r0, r1, r2, r3], axis=-2)  # [..., N, 4, 4]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w, v = jnp.linalg.eigh(AtA)
    X = v[..., :, 0]
    wcomp = X[..., 3]
    return X[..., :3] / jnp.where(jnp.abs(wcomp) < 1e-12, 1e-12, wcomp)[..., None]


def triangulate_two_view_midpoint(p1, p2, R, t):
    """Closest-point ("geometric midpoint") triangulation
    (Triangulate2ViewsGeometricMetric.java).  Frames as in
    :func:`triangulate_two_view_linear`.  Returns [..., N, 3].
    """
    p1 = p1.astype(jnp.float64)
    p2 = p2.astype(jnp.float64)
    # ray 1: origin 0, direction d1=(x1,y1,1)
    d1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], axis=-1)
    # ray 2 in camera-1 frame: origin c2 = -R^T t, direction d2 = R^T (x2,y2,1)
    Rt = jnp.swapaxes(R, -1, -2).astype(jnp.float64)
    c2 = -(Rt @ t.astype(jnp.float64)[..., None])[..., 0]
    d2h = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)
    d2 = d2h @ R.astype(jnp.float64)  # (R^T d2h) with batching: d2h @ R == R^T applied rowwise
    # solve min ||a*d1 - (c2 + b*d2)||
    d11 = jnp.sum(d1 * d1, axis=-1)
    d22 = jnp.sum(d2 * d2, axis=-1)
    d12 = jnp.sum(d1 * d2, axis=-1)
    c2b = jnp.broadcast_to(c2[..., None, :], d1.shape)
    rc1 = jnp.sum(d1 * c2b, axis=-1)
    rc2 = jnp.sum(d2 * c2b, axis=-1)
    den = d11 * d22 - d12 * d12
    den = jnp.where(jnp.abs(den) < 1e-30, 1e-30, den)
    a = (rc1 * d22 - rc2 * d12) / den
    b = (rc1 * d12 - rc2 * d11) / den
    P1 = a[..., None] * d1
    P2 = c2b + b[..., None] * d2
    return (P1 + P2) * 0.5


def triangulate_nview_linear(obs, Rs, ts, weights=None):
    """N-view homogeneous DLT (TriangulateMetricLinearDLT.java:46).

    obs: [V, N, 2] normalized observations across V views;
    Rs: [V, 3, 3], ts: [V, 3] world->camera transforms;
    weights: optional [V, N] (0 masks an observation out).
    Returns [N, 3] world points.
    """
    obs = obs.astype(jnp.float64)
    Rs = Rs.astype(jnp.float64)
    ts = ts.astype(jnp.float64)
    x = obs[..., 0]  # [V, N]
    y = obs[..., 1]
    # rows: x*(R[2]·X + t2) - (R[0]·X + t0); y*(...) - (R[1]...)
    rx = x[..., None] * Rs[:, None, 2, :] - Rs[:, None, 0, :]   # [V, N, 3]
    ry = y[..., None] * Rs[:, None, 2, :] - Rs[:, None, 1, :]
    cx = x * ts[:, None, 2] - ts[:, None, 0]                     # [V, N]
    cy = y * ts[:, None, 2] - ts[:, None, 1]
    rowx = jnp.concatenate([rx, cx[..., None]], axis=-1)         # [V, N, 4]
    rowy = jnp.concatenate([ry, cy[..., None]], axis=-1)
    if weights is not None:
        w = weights.astype(jnp.float64)[..., None]
        rowx = rowx * w
        rowy = rowy * w
    A = jnp.concatenate([rowx, rowy], axis=0)                    # [2V, N, 4]
    A = jnp.moveaxis(A, 0, 1)                                     # [N, 2V, 4]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w_, v = jnp.linalg.eigh(AtA)
    X = v[..., :, 0]
    wc = X[..., 3]
    return X[..., :3] / jnp.where(jnp.abs(wc) < 1e-12, 1e-12, wc)[..., None]


def reprojection_error(X, obs, Rs, ts):
    """Squared reprojection error in normalized coords.

    X: [N, 3] world points; obs: [V, N, 2]; Rs/ts: [V, 3, 3]/[V, 3].
    Returns [V, N].
    """
    Xc = jnp.einsum("vij,nj->vni", Rs, X) + ts[:, None, :]
    z = Xc[..., 2]
    proj = Xc[..., :2] / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)[..., None]
    return jnp.sum((proj - obs) ** 2, axis=-1)
