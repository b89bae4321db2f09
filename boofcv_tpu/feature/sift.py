"""SIFT: difference-of-Gaussian detector + gradient-histogram descriptor.

Reference analog: boofcv-feature alg/feature/detect/interest/
SiftScaleSpace.java + SiftDetector.java:83,165 (DoG scale-space extrema,
edge rejection, subpixel interpolation), alg/feature/describe/
DescribePointSift.java + DescribeSiftCommon (4x4x8 soft-binned
histograms), OrientationHistogramSift.

Design: the whole DoG stack for an octave is one [S, H, W] tensor;
extrema = reduce-window over the 3x3x3 neighborhood; descriptors are
batched gather + soft-binned scatter-adds over all keypoints at once.
The octave ladder (SiftScaleSpace.java:51) is a Python-level unrolled
loop — shapes halve per octave, so each octave is its own
statically-shaped XLA subgraph and dead detection slots carry a
``valid`` mask (fixed capacities, no dynamic shapes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.core.border import BorderType
from boofcv_tpu.ip import blur as blur_mod
from boofcv_tpu.feature.extract import Detections
from boofcv_tpu.ip.interpolate import bilinear


class SiftKeypoints(NamedTuple):
    ys: jnp.ndarray
    xs: jnp.ndarray
    sigmas: jnp.ndarray
    scores: jnp.ndarray
    valid: jnp.ndarray


def gaussian_scale_stack(image, sigma0: float = 1.6, num_scales: int = 3,
                         assume_blurred: bool = False):
    """[S+3, H, W] Gaussian stack for one octave (SiftScaleSpace).

    ``assume_blurred=True`` treats ``image`` as already carrying sigma0
    blur — the octave-ladder case, where each octave's base is the
    previous stack's 2x-sigma level downsampled by two (so its blur is
    exactly sigma0 at the new sampling rate; SiftScaleSpace.java:51
    builds its next octave the same way)."""
    img = jnp.asarray(image, jnp.float32)
    k = 2.0 ** (1.0 / num_scales)
    levels = [img if sigma0 <= 0 or assume_blurred else blur_mod.gaussian(
        img, sigma=sigma0, border=BorderType.EXTENDED)]
    sigmas = [sigma0]
    cur_sigma = sigma0
    for i in range(1, num_scales + 3):
        target = sigma0 * k ** i
        inc = math.sqrt(max(target ** 2 - cur_sigma ** 2, 1e-6))
        levels.append(blur_mod.gaussian(levels[-1], sigma=inc,
                                        border=BorderType.EXTENDED))
        sigmas.append(target)
        cur_sigma = target
    return jnp.stack(levels), np.asarray(sigmas)


def _detect_from_stack(stack, sigmas, max_features: int,
                       contrast_threshold: float, edge_ratio: float,
                       border: int) -> SiftKeypoints:
    """DoG extrema for ONE octave's Gaussian stack (SiftDetector.process).
    Returns keypoints with subpixel position and interpolated sigma, in
    the stack's own pixel coordinates."""
    dog = stack[1:] - stack[:-1]                     # [S+2, H, W]
    s, h, w = dog.shape

    # 3x3x3 extrema over the interior scales
    absd = jnp.abs(dog)
    neigh_max = lax.reduce_window(dog, -jnp.inf, lax.max, (3, 3, 3),
                                  (1, 1, 1), "SAME")
    neigh_min = lax.reduce_window(dog, jnp.inf, lax.min, (3, 3, 3),
                                  (1, 1, 1), "SAME")
    is_max = (dog >= neigh_max) & (dog > contrast_threshold)
    is_min = (dog <= neigh_min) & (dog < -contrast_threshold)
    cand = is_max | is_min
    cand = cand.at[0].set(False).at[-1].set(False)

    # edge rejection via the 2x2 spatial Hessian ratio (SiftDetector :165)
    dxx = jnp.roll(dog, -1, 2) - 2 * dog + jnp.roll(dog, 1, 2)
    dyy = jnp.roll(dog, -1, 1) - 2 * dog + jnp.roll(dog, 1, 1)
    dxy = 0.25 * (jnp.roll(jnp.roll(dog, -1, 1), -1, 2)
                  - jnp.roll(jnp.roll(dog, -1, 1), 1, 2)
                  - jnp.roll(jnp.roll(dog, 1, 1), -1, 2)
                  + jnp.roll(jnp.roll(dog, 1, 1), 1, 2))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    cand = cand & edge_ok

    score = jnp.where(cand, absd, 0.0)
    flat = score.reshape(s, -1).max(axis=0)          # best scale per pixel
    best_s = score.reshape(s, -1).argmax(axis=0)
    flat_img = flat.reshape(h, w)

    # spatial top-k with a light nonmax (the 3D check already did scale)
    from boofcv_tpu.feature import extract as ex
    detn = ex.detect(flat_img, max_features=max_features, radius=2,
                     threshold=contrast_threshold, border=border)
    sel = detn.ys * w + detn.xs
    si = best_s[sel]
    sig = jnp.asarray((sigmas[:-1] + np.diff(sigmas) / 2))[
        jnp.clip(si, 0, s - 1)]
    ys, xs = ex.subpixel_quadratic(flat_img, detn)
    return SiftKeypoints(ys, xs, sig, detn.scores, detn.valid)


def _octave_ladder(image, num_octaves: int, sigma0: float, num_scales: int,
                   min_size: int, first_octave: int = 0):
    """Yield (octave_stack, octave_sigmas, scale_factor) per octave.

    Octave o's base is octave o-1's 2x-sigma0 Gaussian level downsampled
    by two (SiftScaleSpace.java:51) — so each base already carries
    sigma0 of blur at its own sampling rate and the stack skips the
    initial blur (``assume_blurred``).  ``first_octave=-1`` starts from
    a 2x bilinear-upsampled image (the reference's doubled-input first
    octave, SiftScaleSpace.java's firstOctave=-1): DoG extrema whose
    sigma falls below sigma0*2^(1/S) sit on the scale-axis boundary of
    octave 0 and are otherwise invisible.  Stops early when the image
    gets too small for the detection border."""
    base = jnp.asarray(image, jnp.float32)
    if first_octave < -1 or first_octave > 0:
        raise ValueError("first_octave must be -1 or 0")
    off = 0.0
    if first_octave == -1:
        h, w = base.shape
        base = jax.image.resize(base, (2 * h, 2 * w), "linear")
        # jax.image.resize uses half-pixel centers: input u lands at
        # 2u + 0.5 in the upsampled frame, and the top-left-aligned
        # [::2, ::2] ladder preserves that frame — so every octave's
        # full-res map is x_oct * 2^o - 0.25 (measured: without the
        # offset, first_octave=-1 keypoints carried a systematic
        # +0.25 px bias in both axes)
        off = -0.25
    assume = False
    for o in range(first_octave, first_octave + num_octaves):
        if min(base.shape) < min_size:
            return
        stack, sigmas = gaussian_scale_stack(base, sigma0, num_scales,
                                             assume_blurred=assume)
        yield stack, sigmas, 2.0 ** o, off
        base = stack[num_scales][::2, ::2]
        assume = True


def detect(image, max_features: int = 200, sigma0: float = 1.6,
           num_scales: int = 3, contrast_threshold: float = 1.0,
           edge_ratio: float = 10.0, border: int = 8,
           num_octaves: int = 1, first_octave: int = 0) -> SiftKeypoints:
    """DoG extrema across ``num_octaves`` octaves (SiftDetector.process
    over SiftScaleSpace.java:51's octave pyramid).  Keypoints come back
    in FULL-RESOLUTION coordinates with full-range sigmas; capacity is
    ``max_features`` per octave (fixed shapes — dead slots are masked
    via ``valid``)."""
    parts = []
    for stack, sigmas, f, off in _octave_ladder(image, num_octaves, sigma0,
                                                num_scales, 2 * border + 1,
                                                first_octave):
        kp = _detect_from_stack(stack, sigmas, max_features,
                                contrast_threshold, edge_ratio, border)
        parts.append(SiftKeypoints(kp.ys * f + off, kp.xs * f + off,
                                   kp.sigmas * f, kp.scores, kp.valid))
    if not parts:
        # image smaller than the detection border: full-capacity dead
        # slots (fixed shapes, nothing valid) instead of a crash
        z = jnp.zeros((max_features,), jnp.float32)
        return SiftKeypoints(z, z, z, z,
                             jnp.zeros((max_features,), bool))
    return SiftKeypoints(*[jnp.concatenate(leaves)
                           for leaves in zip(*parts)])


def orientation_histogram(image, ys, xs, sigmas, num_bins: int = 36):
    """Dominant gradient orientation per keypoint
    (OrientationHistogramSift).

    The /1.6 below is the fixed window-to-scale proportionality
    constant (sample spacing = sigma/1.6 pixels in the image the sigmas
    are measured in), NOT a sigma0 normalization: because sigmas are
    expressed in the same frame as the sampling coordinates, support is
    proportional to the feature's PHYSICAL scale for any scale-space
    base — dividing by sigma0 here would make descriptors
    sigma0-dependent (measured: zero cross-sigma0 matches)."""
    img = jnp.asarray(image, jnp.float32)
    gy = jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0)
    gx = jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1)
    r = 8
    d = jnp.arange(-r, r + 1, dtype=jnp.float32)
    rel = sigmas[:, None, None] / 1.6
    yy = ys[:, None, None] + d[None, :, None] * rel
    xx = xs[:, None, None] + d[None, None, :] * rel
    sgx = bilinear(gx, yy, xx)
    sgy = bilinear(gy, yy, xx)
    mag = jnp.hypot(sgx, sgy)
    wgt = jnp.exp(-0.5 * (d[None, :, None] ** 2 + d[None, None, :] ** 2)
                  / (r / 2.0) ** 2)
    ang = jnp.arctan2(sgy, sgx) % (2 * np.pi)
    bins = jnp.clip((ang / (2 * np.pi) * num_bins).astype(jnp.int32),
                    0, num_bins - 1)
    n = ys.shape[0]
    hist = jnp.zeros((n, num_bins))
    flat_bins = bins.reshape(n, -1)
    flat_w = (mag * wgt).reshape(n, -1)
    hist = jax.vmap(lambda b, w_: jnp.zeros((num_bins,)).at[b].add(w_))(
        flat_bins, flat_w)
    return hist.argmax(axis=1).astype(jnp.float32) * (2 * np.pi / num_bins)


def describe(image, ys, xs, sigmas, angles, width_grid: int = 4,
             width_sub: int = 4, num_bins: int = 8):
    """SIFT descriptors [N, 128] (DescribePointSift.process).

    4x4 spatial cells x 8 orientation bins, soft-binned (hard spatial
    assignment, soft angular via nearest bin — adequate parity), Gaussian
    weighted, L2-normalized with 0.2 clipping + renormalize.
    """
    img = jnp.asarray(image, jnp.float32)
    gy = jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0)
    gx = jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1)
    half = width_grid * width_sub / 2.0                  # 8 sample units
    d = (jnp.arange(width_grid * width_sub, dtype=jnp.float32)
         - half + 0.5)                                    # [-7.5 .. 7.5]
    n = ys.shape[0]
    scale = sigmas / 1.6   # fixed window/scale constant (see orientation_histogram)
    ca = jnp.cos(angles)
    sa = jnp.sin(angles)
    # rotated sample lattice
    u = d[None, :, None] * jnp.ones_like(d)[None, None, :]
    v = jnp.ones_like(d)[None, :, None] * d[None, None, :]
    rx = (ca[:, None, None] * u - sa[:, None, None] * v) * scale[:, None, None]
    ry = (sa[:, None, None] * u + ca[:, None, None] * v) * scale[:, None, None]
    yy = ys[:, None, None] + ry
    xx = xs[:, None, None] + rx
    sgx = bilinear(gx, yy, xx)
    sgy = bilinear(gy, yy, xx)
    # rotate gradients into keypoint frame
    rgx = ca[:, None, None] * sgx + sa[:, None, None] * sgy
    rgy = -sa[:, None, None] * sgx + ca[:, None, None] * sgy
    mag = jnp.hypot(rgx, rgy)
    wgt = jnp.exp(-0.5 * (u ** 2 + v ** 2) / (half ** 2))
    ang = jnp.arctan2(rgy, rgx) % (2 * np.pi)
    abin = jnp.clip((ang / (2 * np.pi) * num_bins).astype(jnp.int32),
                    0, num_bins - 1)
    cell_u = jnp.clip(((u + half) / width_sub).astype(jnp.int32),
                      0, width_grid - 1)
    cell_v = jnp.clip(((v + half) / width_sub).astype(jnp.int32),
                      0, width_grid - 1)
    idx = (cell_v * width_grid + cell_u) * num_bins + abin   # [N, P, P]
    D = width_grid * width_grid * num_bins
    flat_idx = idx.reshape(n, -1)
    flat_w = (mag * wgt).reshape(n, -1)
    desc = jax.vmap(lambda i, w_: jnp.zeros((D,)).at[i].add(w_))(
        flat_idx, flat_w)
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    desc = jnp.minimum(desc / norm, 0.2)
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    return desc / norm


def detect_describe(image, max_features: int = 200, num_octaves: int = 4,
                    sigma0: float = 1.6, num_scales: int = 3,
                    contrast_threshold: float = 1.0,
                    edge_ratio: float = 10.0, border: int = 8,
                    first_octave: int = 0):
    """Full multi-octave pipeline: returns (keypoints, descriptors).

    Orientation and the 4x4x8 descriptor are sampled AT OCTAVE
    RESOLUTION (each octave's sigma0 Gaussian level), so descriptor
    support scales with the keypoint — features survive the full
    2^num_octaves scale range like the reference's
    SiftScaleSpace.java:51 + DescribePointSift pairing, instead of
    sampling ever-larger windows of the full-res image.  Keypoints come
    back in full-resolution coordinates; capacity is ``max_features``
    per octave with dead slots masked via ``valid``."""
    kps, descs = [], []
    for stack, sigmas, f, off in _octave_ladder(image, num_octaves, sigma0,
                                                num_scales, 2 * border + 1,
                                                first_octave):
        kp = _detect_from_stack(stack, sigmas, max_features,
                                contrast_threshold, edge_ratio, border)
        base = stack[0]
        ang = orientation_histogram(base, kp.ys, kp.xs, kp.sigmas)
        desc = describe(base, kp.ys, kp.xs, kp.sigmas, ang)
        kps.append(SiftKeypoints(kp.ys * f + off, kp.xs * f + off,
                                 kp.sigmas * f, kp.scores, kp.valid))
        descs.append(desc)
    if not kps:
        z = jnp.zeros((max_features,), jnp.float32)
        return (SiftKeypoints(z, z, z, z,
                              jnp.zeros((max_features,), bool)),
                jnp.zeros((max_features, 128), jnp.float32))
    kp = SiftKeypoints(*[jnp.concatenate(leaves) for leaves in zip(*kps)])
    return kp, jnp.concatenate(descs)
