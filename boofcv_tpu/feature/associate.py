"""Descriptor association.

Reference analog: boofcv-feature alg/feature/associate/AssociateGreedy.java
:46,65 (brute-force greedy with backwards validation), ScoreAssociation
implementations (DescriptorDistance.java:37-164), EnsureUniqueAssociation.

Design (SURVEY §2.3): the all-pairs score matrix is ONE matmul
(euclidean-sq via the |a|^2+|b|^2-2ab expansion is one matmul), and
greedy-with-backwards-validation becomes mutual-nearest-neighbor: row
argmin + col argmin agreeing — order-independent and equivalent in effect.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
from jax import lax


class Matches(NamedTuple):
    """Fixed-capacity association set (analog of FastQueue<AssociatedIndex>)."""
    src: jnp.ndarray     # [N] int32 index into source set
    dst: jnp.ndarray     # [N] int32 index into destination set
    score: jnp.ndarray   # [N] f32 fit score (lower better)
    valid: jnp.ndarray   # [N] bool


def score_euclidean_sq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[Na, D] x [Nb, D] -> [Na, Nb] squared euclidean, matmul-shaped."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    a2 = jnp.sum(a * a, axis=1, keepdims=True)
    b2 = jnp.sum(b * b, axis=1, keepdims=True)
    ab = jnp.dot(a, b.T, precision=lax.Precision.HIGHEST)
    return jnp.maximum(a2 + b2.T - 2.0 * ab, 0.0)


def score_sad(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Sum of absolute differences (DescriptorDistance.sad)."""
    return jnp.sum(jnp.abs(a[:, None, :] - b[None, :, :]), axis=-1)


def score_ncc(a: jnp.ndarray, b: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Negative NCC as a *distance* (lower = better), for zero-mean
    descriptors (NccFeature convention: mean/sigma stored separately in the
    reference; here descriptors are pre-normalized)."""
    am = a - jnp.mean(a, axis=1, keepdims=True)
    bm = b - jnp.mean(b, axis=1, keepdims=True)
    an = am / (jnp.linalg.norm(am, axis=1, keepdims=True) + eps)
    bn = bm / (jnp.linalg.norm(bm, axis=1, keepdims=True) + eps)
    return -jnp.dot(an, bn.T, precision=lax.Precision.HIGHEST)


def score_hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distance between packed-int descriptor rows [N, W] int32."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pc = (x * 0x01010101) >> 24
    return jnp.sum(pc, axis=-1).astype(jnp.float32)


def associate_mutual(scores: jnp.ndarray,
                     valid_a: jnp.ndarray | None = None,
                     valid_b: jnp.ndarray | None = None,
                     max_error: float = jnp.inf) -> Matches:
    """Mutual-nearest-neighbor association from a [Na, Nb] score matrix.

    Equivalent to AssociateGreedy with backwardsValidation=true: src i and
    dst j match iff j = argmin_j S[i, j] and i = argmin_i S[i, j] and
    S[i, j] <= max_error.  Output capacity = Na (one candidate per source).
    """
    na, nb = scores.shape
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    s = scores.astype(jnp.float32)
    if valid_a is not None:
        s = jnp.where(valid_a[:, None], s, big)
    if valid_b is not None:
        s = jnp.where(valid_b[None, :], s, big)
    best_j = jnp.argmin(s, axis=1)               # [Na]
    best_i = jnp.argmin(s, axis=0)               # [Nb]
    row_min = jnp.min(s, axis=1)                 # [Na]
    mutual = best_i[best_j] == jnp.arange(na)
    ok = mutual & (row_min <= max_error) & (row_min < big)
    return Matches(
        src=jnp.arange(na, dtype=jnp.int32),
        dst=best_j.astype(jnp.int32),
        score=row_min,
        valid=ok,
    )


def associate_greedy(scores: jnp.ndarray, max_error: float = jnp.inf,
                     backwards: bool = True) -> Matches:
    """AssociateGreedy semantics; with backwards validation this equals
    mutual-NN (the reference's forward pass picks each row's min; the
    backward pass keeps pairs that are also the column min)."""
    if backwards:
        return associate_mutual(scores, max_error=max_error)
    na = scores.shape[0]
    best_j = jnp.argmin(scores, axis=1)
    row_min = jnp.min(scores, axis=1)
    return Matches(jnp.arange(na, dtype=jnp.int32), best_j.astype(jnp.int32),
                   row_min, row_min <= max_error)


def associate_ratio_test(scores: jnp.ndarray, ratio: float = 0.8,
                         max_error: float = jnp.inf) -> Matches:
    """Lowe ratio-test association (ScoreRatioAssociation analog)."""
    na = scores.shape[0]
    neg = -scores
    top2, idx2 = lax.top_k(neg, 2)               # [Na, 2] best (least) scores
    best = -top2[:, 0]
    second = -top2[:, 1]
    ok = (best <= ratio * second) & (best <= max_error)
    return Matches(jnp.arange(na, dtype=jnp.int32), idx2[:, 0].astype(jnp.int32),
                   best, ok)


def associate_mutual_2d(scores: jnp.ndarray, xy_a: jnp.ndarray,
                        xy_b: jnp.ndarray, max_distance: float,
                        valid_a=None, valid_b=None,
                        max_error: float = jnp.inf) -> Matches:
    """Mutual-NN with a 2D image-distance gate
    (AssociateDescription2D / AssociateMaxDistanceNaive analog): pairs
    farther apart than ``max_distance`` pixels are never matched.  The
    gate folds into the score matrix as an additive mask, so the whole
    association stays one matmul-shaped pass."""
    d2 = (jnp.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, -1)
          .astype(jnp.float32))
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    gated = jnp.where(d2 <= jnp.float32(max_distance) ** 2,
                      scores.astype(jnp.float32), big)
    return associate_mutual(gated, valid_a, valid_b, max_error=max_error)


def associate_mutual_tiled(desc_a: jnp.ndarray, desc_b: jnp.ndarray,
                           tile: int = 2048,
                           valid_a: jnp.ndarray | None = None,
                           valid_b: jnp.ndarray | None = None,
                           max_error: float = jnp.inf) -> Matches:
    """Mutual-NN association WITHOUT materializing the [Na, Nb] score
    matrix — association at scale (AssociateNearestNeighbor's role;
    the reference reaches for KD-trees, the answer here is a streamed
    matmul).

    The destination set is processed in ``tile``-column blocks under
    ``lax.scan``: each step computes one [Na, tile] Euclidean block as
    one matmul and folds it into running row/column argmins.  Peak memory is
    O(Na * tile) instead of O(Na * Nb) — 100k x 100k features run in
    ~100 MB-scale tiles instead of a 40 GB matrix.  Scores are squared
    Euclidean (the dominant descriptor metric); results are identical to
    ``associate_mutual(score_euclidean_sq(a, b))``.
    """
    na, d = desc_a.shape
    nb = desc_b.shape[0]
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    a = desc_a.astype(jnp.float32)
    a2 = jnp.sum(a * a, axis=1)
    pad = (-nb) % tile
    b = jnp.concatenate(
        [desc_b.astype(jnp.float32),
         jnp.zeros((pad, d), jnp.float32)]) if pad else \
        desc_b.astype(jnp.float32)
    vb = jnp.ones((nb,), bool) if valid_b is None else valid_b
    vb = jnp.concatenate([vb, jnp.zeros((pad,), bool)]) if pad else vb
    n_tiles = b.shape[0] // tile
    b_tiles = b.reshape(n_tiles, tile, d)
    vb_tiles = vb.reshape(n_tiles, tile)

    va = jnp.ones((na,), bool) if valid_a is None else valid_a

    def step(carry, inp):
        row_min, best_j = carry
        t, (bt, vbt) = inp
        s = (a2[:, None] + jnp.sum(bt * bt, axis=1)[None, :]
             - 2.0 * jnp.matmul(a, bt.T,
                                precision=lax.Precision.HIGHEST))
        # HIGHEST matches score_euclidean_sq — at a reduced-precision f32
        # default (TF32 on a GPU) near-duplicate descriptors tie-break
        # differently between the tiled and full-matrix paths
        s = jnp.maximum(s, 0.0)
        s = jnp.where(va[:, None] & vbt[None, :], s, big)
        # row (a-side) running min
        tmin = jnp.min(s, axis=1)
        targ = (jnp.argmin(s, axis=1) + t * tile).astype(jnp.int32)
        upd = tmin < row_min
        row_min = jnp.where(upd, tmin, row_min)
        best_j = jnp.where(upd, targ, best_j)
        # column (b-side) min within this tile is exact already
        col_min = jnp.min(s, axis=0)
        col_arg = jnp.argmin(s, axis=0).astype(jnp.int32)
        return (row_min, best_j), (col_min, col_arg)

    (row_min, best_j), (col_min_t, col_arg_t) = lax.scan(
        step, (jnp.full((na,), big), jnp.zeros((na,), jnp.int32)),
        (jnp.arange(n_tiles), (b_tiles, vb_tiles)))
    best_i = col_arg_t.reshape(-1)[:nb]              # [Nb]
    mutual = best_i[best_j] == jnp.arange(na)
    ok = mutual & (row_min <= max_error) & (row_min < big) & va
    return Matches(jnp.arange(na, dtype=jnp.int32), best_j.astype(jnp.int32),
                   row_min, ok)


def associate_three_by_pairs(desc1: jnp.ndarray, desc2: jnp.ndarray,
                             desc3: jnp.ndarray, score=score_euclidean_sq,
                             max_error: float = jnp.inf,
                             valid1=None, valid2=None, valid3=None):
    """Three-view association by composing pairwise matches
    (AssociateThreeByPairs.java:38 analog).

    Associates 1<->2 and 2<->3 (mutual-NN), composes i -> j -> k, then
    verifies each surviving triple with a direct 1<->3 association —
    exactly the reference's structure (associate 1-2, match survivors
    against 3, sanity-check the closure).  Returns
    (idx1, idx2, idx3, valid) int32 arrays of capacity N1.
    """
    m12 = associate_mutual(score(desc1, desc2), valid1, valid2,
                           max_error=max_error)
    m23 = associate_mutual(score(desc2, desc3), valid2, valid3,
                           max_error=max_error)
    m13 = associate_mutual(score(desc1, desc3), valid1, valid3,
                           max_error=max_error)
    j = m12.dst                                     # [N1] 1 -> 2
    # compose with 2 -> 3 (gather m23 rows at j)
    k = m23.dst[j]                                  # [N1] 1 -> 3 via 2
    chain_ok = m12.valid & m23.valid[j]
    # closure: direct 1 -> 3 must agree
    closure = m13.valid & (m13.dst == k)
    valid = chain_ok & closure
    return (jnp.arange(desc1.shape[0], dtype=jnp.int32), j, k, valid)


def associate_nearest_neighbor_kdtree(desc_a, desc_b, max_error: float = np.inf,
                                      mutual: bool = True,
                                      eps: float = 0.0) -> Matches:
    """Host-side (approximate) KD-tree association —
    AssociateNearestNeighbor.java API parity.

    The batched answer to association at scale is
    :func:`associate_mutual_tiled` (streamed matmuls); this wrapper
    exists for host-only pipelines and API completeness, backed by
    scipy's cKDTree.  ``eps`` > 0 allows approximate neighbors (the
    reference's best-bin-first K-D search is likewise approximate).
    Scores are squared Euclidean, matching the matmul paths.
    """
    from scipy.spatial import cKDTree

    a = np.asarray(desc_a, np.float64)
    b = np.asarray(desc_b, np.float64)
    tree_b = cKDTree(b)
    dist, idx = tree_b.query(a, k=1, eps=eps)
    valid = np.isfinite(dist)
    if mutual:
        tree_a = cKDTree(a)
        _, back = tree_a.query(b[idx], k=1, eps=eps)
        valid &= back == np.arange(len(a))
    d2 = dist ** 2
    valid &= d2 <= max_error
    return Matches(jnp.arange(len(a), dtype=jnp.int32),
                   jnp.asarray(idx, jnp.int32),
                   jnp.asarray(d2, jnp.float32), jnp.asarray(valid))
