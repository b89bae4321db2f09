"""Bag-of-visual-words scene classification.

Reference analog: boofcv-recognition alg/scene/ —
ClassifierKNearestNeighborsBow.java, FeatureToWordHistogram_F64.java,
with k-means clustering from boofcv-learning (alg/bow/ClusterVisualWords).

Design: k-means is the canonical batched workload — assignment is
one [N, K] distance matmul, update one segment-sum; histogram encoding
and kNN classification are the same two primitives again.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


def kmeans(key, points, k: int, iterations: int = 25):
    """Plain k-means (ClusterVisualWords analog).  points: [N, D]."""
    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    idx = jax.random.choice(key, n, (k,), replace=False)
    centers = pts[idx]

    def step(centers, _):
        d = (jnp.sum(pts * pts, 1)[:, None]
             - 2.0 * pts @ centers.T
             + jnp.sum(centers * centers, 1)[None, :])
        lab = jnp.argmin(d, axis=1)
        onehot = jax.nn.one_hot(lab, k, dtype=jnp.float32)
        sums = onehot.T @ pts
        counts = jnp.sum(onehot, 0)[:, None]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), centers)
        return new, None

    centers, _ = jax.lax.scan(step, centers, None, length=iterations)
    return centers


def assign_words(features, vocabulary):
    """[N] nearest-word index per feature (one matmul)."""
    f = jnp.asarray(features, jnp.float32)
    v = jnp.asarray(vocabulary, jnp.float32)
    d = (jnp.sum(f * f, 1)[:, None] - 2.0 * f @ v.T
         + jnp.sum(v * v, 1)[None, :])
    return jnp.argmin(d, axis=1)


def word_histogram(features, vocabulary, normalize: bool = True):
    """BOW histogram (FeatureToWordHistogram)."""
    k = vocabulary.shape[0]
    words = assign_words(features, vocabulary)
    hist = jnp.zeros((k,), jnp.float32).at[words].add(1.0)
    if normalize:
        hist = hist / jnp.maximum(jnp.sum(hist), 1.0)
    return hist


class BowClassifier(NamedTuple):
    """kNN over training histograms (ClassifierKNearestNeighborsBow)."""
    vocabulary: jnp.ndarray     # [K, D]
    train_hists: jnp.ndarray    # [M, K]
    train_labels: jnp.ndarray   # [M]
    num_neighbors: int


def train_bow(key, feature_sets, labels, vocab_size: int = 64,
              num_neighbors: int = 5) -> BowClassifier:
    """feature_sets: list of [Ni, D] descriptor arrays (one per image)."""
    allf = jnp.concatenate([jnp.asarray(f, jnp.float32)
                            for f in feature_sets], 0)
    vocab = kmeans(key, allf, vocab_size)
    hists = jnp.stack([word_histogram(f, vocab) for f in feature_sets])
    return BowClassifier(vocab, hists, jnp.asarray(labels, jnp.int32),
                         num_neighbors)


def classify_bow(clf: BowClassifier, features):
    """Predict the label of one image's descriptor set."""
    h = word_histogram(features, clf.vocabulary)
    d = jnp.sum((clf.train_hists - h[None, :]) ** 2, axis=1)
    nn = jnp.argsort(d)[: clf.num_neighbors]
    votes = clf.train_labels[nn]
    counts = jnp.zeros((int(jnp.max(clf.train_labels)) + 1,)).at[votes].add(1.0)
    return int(jnp.argmax(counts))
