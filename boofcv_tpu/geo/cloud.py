"""Point-cloud utilities + nearest-neighbor search.

Reference analog: boofcv-geo alg/cloud/PointCloudUtils.java (filtering,
statistics) and alg/nn/KdTreePoint3D_F64.java (ddogleg KD-trees).

Design: NN queries are batched distance matrices (one matmul-shaped
reduction) — at SLAM-scale cloud sizes this suits an accelerator better
than tree traversal; filtering/statistics are masked reductions.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def statistics(points, valid=None):
    """mean / stdev / axis-aligned bounds (PointCloudUtils.statistics)."""
    pts = jnp.asarray(points, jnp.float64)
    if valid is None:
        valid = jnp.ones(pts.shape[:-1], bool)
    w = valid.astype(jnp.float64)[..., None]
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w, axis=0) / n
    var = jnp.sum(w * (pts - mean) ** 2, axis=0) / n
    big = 1e300
    lo = jnp.min(jnp.where(valid[..., None], pts, big), axis=0)
    hi = jnp.max(jnp.where(valid[..., None], pts, -big), axis=0)
    return {"mean": mean, "stdev": jnp.sqrt(var), "min": lo, "max": hi,
            "count": jnp.sum(valid)}


def filter_radius_outliers(points, num_neighbors: int = 8,
                           max_mean_distance: float = 1.0, valid=None):
    """Keep points whose mean distance to their k nearest neighbors is
    below the threshold (statistical outlier removal;
    PointCloudUtils.filter analog)."""
    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    d2 = (jnp.sum(pts * pts, 1)[:, None] - 2.0 * pts @ pts.T
          + jnp.sum(pts * pts, 1)[None, :])
    d2 = jnp.where(valid[None, :], d2, jnp.inf)
    d2 = d2.at[jnp.arange(n), jnp.arange(n)].set(jnp.inf)
    k = min(num_neighbors, n - 1)
    nn_d2, _ = jax.lax.top_k(-d2, k)
    mean_d = jnp.mean(jnp.sqrt(jnp.maximum(-nn_d2, 0.0)), axis=1)
    return valid & (mean_d <= max_mean_distance)


def nearest_neighbors(queries, points, k: int = 1, valid=None):
    """Batched k-NN: returns (indices [Q, k], distances [Q, k])."""
    q = jnp.asarray(queries, jnp.float32)
    p = jnp.asarray(points, jnp.float32)
    d2 = (jnp.sum(q * q, 1)[:, None] - 2.0 * q @ p.T
          + jnp.sum(p * p, 1)[None, :])
    if valid is not None:
        d2 = jnp.where(valid[None, :], d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2, k)
    return idx, jnp.sqrt(jnp.maximum(-neg, 0.0))


def prune_far_points(points, max_distance: float, origin=None, valid=None):
    """Mask points beyond a range from the origin (cloud pruning)."""
    pts = jnp.asarray(points, jnp.float64)
    o = jnp.zeros((3,), jnp.float64) if origin is None else jnp.asarray(origin)
    d = jnp.linalg.norm(pts - o, axis=-1)
    keep = d <= max_distance
    if valid is not None:
        keep = keep & valid
    return keep


def downsample_voxel(points, voxel: float):
    """Voxel-grid downsample (host-side; returns representative points)."""
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(idx)]
