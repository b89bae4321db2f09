"""Template matching.

Reference analog: boofcv-feature alg/feature/detect/template/
TemplateMatching.java + TemplateIntensityImage / methods SSD, SAD, NCC
(TemplateDiffSquared, TemplateNCC).

Design: correlation-style scores are computed as convolutions /
box-filter compositions over the whole image at once; peak extraction
reuses feature.extract nonmax+top-k.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from boofcv_tpu.feature import extract


def _valid_correlate(image, kernel):
    img = image[None, None]
    ker = kernel[None, None].astype(image.dtype)
    out = lax.conv_general_dilated(
        img, ker, (1, 1), "VALID", dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return out[0, 0]


def _box_sum(image, th, tw):
    ones = jnp.ones((th, tw), image.dtype)
    return _valid_correlate(image, ones)


def match_ssd(image, template):
    """-SSD score map ([H-th+1, W-tw+1]; higher = better).

    ssd = sum(I^2) - 2 corr(I, T) + sum(T^2) via box sums + one conv.
    """
    image = image.astype(jnp.float32)
    template = template.astype(jnp.float32)
    th, tw = template.shape
    corr = _valid_correlate(image, template)
    i2 = _box_sum(image * image, th, tw)
    t2 = jnp.sum(template * template)
    return -(i2 - 2.0 * corr + t2)


def match_sad(image, template):
    """-SAD score map (computed exactly by shift-accumulate; O(th*tw)
    shifted adds — the template is small)."""
    image = image.astype(jnp.float32)
    template = template.astype(jnp.float32)
    th, tw = template.shape
    h, w = image.shape
    oh, ow = h - th + 1, w - tw + 1
    acc = jnp.zeros((oh, ow), jnp.float32)
    for dy in range(th):
        for dx in range(tw):
            acc = acc + jnp.abs(image[dy:dy + oh, dx:dx + ow] - template[dy, dx])
    return -acc


def match_ncc(image, template, eps: float = 1e-8):
    """Normalized cross-correlation score map in [-1, 1] (TemplateNCC)."""
    image = image.astype(jnp.float32)
    template = template.astype(jnp.float32)
    th, tw = template.shape
    n = th * tw
    tmean = jnp.mean(template)
    tz = template - tmean
    tnorm = jnp.sqrt(jnp.sum(tz * tz) + eps)
    corr = _valid_correlate(image, tz)
    isum = _box_sum(image, th, tw)
    i2sum = _box_sum(image * image, th, tw)
    ivar = i2sum - isum * isum / n
    inorm = jnp.sqrt(jnp.maximum(ivar, eps))
    return corr / (inorm * tnorm)


def find_matches(score_map, max_matches: int = 5, radius: int = 2,
                 threshold: float = -jnp.inf):
    """Top-N peaks of a score map (TemplateMatching.process).  Returned
    coordinates are the template's top-left corner."""
    return extract.detect(score_map, max_features=max_matches,
                          radius=radius, threshold=threshold)
