"""Background models (stationary camera).

Reference analog: boofcv-feature alg/background/ —
BackgroundStationaryBasic (running average + threshold),
BackgroundStationaryGaussian (per-pixel mean/variance),
BackgroundStationaryGmm (mixture of Gaussians, stationary/moving).

Design: all three are pure elementwise state updates over [H, W(, C)]
arrays — one fused kernel per frame.  The moving-camera variants of the
reference compose these with a homography warp of the model
(ip.distort.warp) before the update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Basic: exponential running average
# ---------------------------------------------------------------------------

def basic_init(image):
    return image.astype(jnp.float32)


def basic_update(model, image, learn_rate: float = 0.05):
    return model + learn_rate * (image.astype(jnp.float32) - model)


def basic_segment(model, image, threshold: float = 25.0):
    """1 = moving foreground (BackgroundStationaryBasic.segment)."""
    return (jnp.abs(image.astype(jnp.float32) - model) > threshold).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Gaussian: per-pixel mean + variance
# ---------------------------------------------------------------------------

class GaussianModel(NamedTuple):
    mean: jnp.ndarray
    var: jnp.ndarray


def gaussian_init(image, initial_var: float = 100.0):
    img = image.astype(jnp.float32)
    return GaussianModel(img, jnp.full_like(img, initial_var))


def gaussian_update(model: GaussianModel, image, learn_rate: float = 0.05,
                    min_var: float = 4.0):
    img = image.astype(jnp.float32)
    d = img - model.mean
    mean = model.mean + learn_rate * d
    var = model.var + learn_rate * (d * d - model.var)
    return GaussianModel(mean, jnp.maximum(var, min_var))


def gaussian_segment(model: GaussianModel, image,
                     threshold_sigma: float = 3.0):
    img = image.astype(jnp.float32)
    d2 = (img - model.mean) ** 2
    return (d2 > threshold_sigma ** 2 * model.var).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# GMM: K Gaussians per pixel (Stauffer-Grimson style, as in
# BackgroundStationaryGmm / GmmModelManager)
# ---------------------------------------------------------------------------

class GmmModel(NamedTuple):
    means: jnp.ndarray    # [K, H, W]
    vars: jnp.ndarray     # [K, H, W]
    weights: jnp.ndarray  # [K, H, W]


def gmm_init(image, k: int = 3, initial_var: float = 400.0):
    img = image.astype(jnp.float32)
    means = jnp.stack([img] + [jnp.zeros_like(img)] * (k - 1))
    vars_ = jnp.full_like(means, initial_var)
    weights = jnp.stack([jnp.ones_like(img)] +
                        [jnp.zeros_like(img)] * (k - 1))
    return GmmModel(means, vars_, weights)


def gmm_update(model: GmmModel, image, learn_rate: float = 0.02,
               match_sigma: float = 3.0, initial_var: float = 400.0,
               min_var: float = 4.0):
    """One Stauffer-Grimson update step, fully vectorized over pixels."""
    img = image.astype(jnp.float32)[None]
    d2 = (img - model.means) ** 2
    match = (d2 < match_sigma ** 2 * model.vars) & (model.weights > 0)
    # only the best (highest-weight) matching component updates
    score = jnp.where(match, model.weights, -1.0)
    best = jnp.argmax(score, axis=0)[None]                    # [1, H, W]
    k_idx = jnp.arange(model.means.shape[0])[:, None, None]
    is_best = (k_idx == best) & match
    any_match = jnp.any(match, axis=0, keepdims=True)

    rho = learn_rate
    means = jnp.where(is_best, model.means + rho * (img - model.means),
                      model.means)
    vars_ = jnp.where(is_best,
                      jnp.maximum(model.vars + rho * (d2 - model.vars),
                                  min_var),
                      model.vars)
    weights = model.weights + learn_rate * (is_best.astype(jnp.float32)
                                            - model.weights)

    # no match: replace weakest component with a fresh Gaussian
    weakest = jnp.argmin(jnp.where(model.weights > 0, model.weights,
                                   jnp.inf), axis=0)[None]
    is_weakest = (k_idx == weakest) & ~any_match
    means = jnp.where(is_weakest, img, means)
    vars_ = jnp.where(is_weakest, initial_var, vars_)
    weights = jnp.where(is_weakest, learn_rate, weights)

    wsum = jnp.sum(weights, axis=0, keepdims=True)
    weights = weights / jnp.maximum(wsum, 1e-12)
    return GmmModel(means, vars_, weights)


def gmm_segment(model: GmmModel, image, match_sigma: float = 3.0,
                bg_weight: float = 0.3):
    """Foreground = matches no component whose weight >= bg_weight."""
    img = image.astype(jnp.float32)[None]
    d2 = (img - model.means) ** 2
    match_bg = (d2 < match_sigma ** 2 * model.vars) & (model.weights >= bg_weight)
    return (~jnp.any(match_bg, axis=0)).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Moving-camera variants
# ---------------------------------------------------------------------------
# Reference analog: alg/background/moving/BackgroundMovingBasic.java,
# BackgroundMovingGaussian.java, BackgroundMovingGmm.java.  The model lives
# in a fixed "home" keyframe; every frame carries a homography
# home->current.  Update: for each model pixel, project into the current
# frame, bilinear-sample, and update only where the sample lands in-bounds.
# Segment: for each frame pixel, look the model up through the inverse
# transform; pixels that leave the model are "unknown" (value 2), matching
# the reference's unknownValue convention.  Design: both directions are
# one dense warp grid + fused elementwise update — no per-pixel branching.

UNKNOWN = 2


def _homog_apply(H, xs, ys):
    d = H[2, 0] * xs + H[2, 1] * ys + H[2, 2]
    d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    u = (H[0, 0] * xs + H[0, 1] * ys + H[0, 2]) / d
    v = (H[1, 0] * xs + H[1, 1] * ys + H[1, 2]) / d
    return u, v


def _model_grid(shape_hw, H_home_to_current):
    h, w = shape_hw
    ys, xs = jnp.mgrid[0:h, 0:w]
    u, v = _homog_apply(H_home_to_current, xs.astype(jnp.float32),
                        ys.astype(jnp.float32))
    return u, v


def _frame_sample(image, H_home_to_current, shape_hw):
    """Sample the current frame at each model pixel.  Returns (values, seen)."""
    from boofcv_tpu.ip import interpolate
    u, v = _model_grid(shape_hw, H_home_to_current)
    vals = interpolate.bilinear(image.astype(jnp.float32), v, u)
    seen = interpolate.in_bounds(image.shape[:2], v, u)
    return vals, seen


def moving_basic_update(model, image, H_home_to_current,
                        learn_rate: float = 0.05):
    """BackgroundMovingBasic.updateBackground analog; ``model`` may contain
    NaN for never-observed pixels (use ``moving_init``)."""
    vals, seen = _frame_sample(image, H_home_to_current, model.shape[:2])
    first = jnp.isnan(model)
    upd = jnp.where(first, vals, model + learn_rate * (vals - model))
    return jnp.where(seen, upd, model)


def moving_init(shape_hw):
    return jnp.full(shape_hw, jnp.nan, dtype=jnp.float32)


def moving_basic_segment(model, image, H_home_to_current,
                         threshold: float = 25.0):
    """0=background 1=moving 2=unknown, in *current frame* pixels."""
    from boofcv_tpu.ip import interpolate
    h, w = image.shape[:2]
    Hinv = jnp.linalg.inv(H_home_to_current.astype(jnp.float64)).astype(
        jnp.float32)
    ys, xs = jnp.mgrid[0:h, 0:w]
    u, v = _homog_apply(Hinv, xs.astype(jnp.float32), ys.astype(jnp.float32))
    mvals = interpolate.bilinear(model, v, u)
    known = interpolate.in_bounds(model.shape[:2], v, u) & ~jnp.isnan(mvals)
    moving = jnp.abs(image.astype(jnp.float32) - mvals) > threshold
    out = jnp.where(moving, 1, 0).astype(jnp.uint8)
    return jnp.where(known, out, jnp.uint8(UNKNOWN))


class MovingGaussianModel(NamedTuple):
    mean: jnp.ndarray
    var: jnp.ndarray


def moving_gaussian_init(shape_hw):
    return MovingGaussianModel(jnp.full(shape_hw, jnp.nan, jnp.float32),
                               jnp.full(shape_hw, jnp.nan, jnp.float32))


def moving_gaussian_update(model: MovingGaussianModel, image,
                           H_home_to_current, learn_rate: float = 0.05,
                           initial_var: float = 100.0, min_var: float = 4.0):
    vals, seen = _frame_sample(image, H_home_to_current, model.mean.shape[:2])
    first = jnp.isnan(model.mean)
    d = vals - model.mean
    mean = jnp.where(first, vals, model.mean + learn_rate * d)
    var = jnp.where(first, initial_var,
                    jnp.maximum(model.var + learn_rate * (d * d - model.var),
                                min_var))
    return MovingGaussianModel(jnp.where(seen, mean, model.mean),
                               jnp.where(seen, var, model.var))


def moving_gaussian_segment(model: MovingGaussianModel, image,
                            H_home_to_current, match_sigma: float = 3.0):
    from boofcv_tpu.ip import interpolate
    h, w = image.shape[:2]
    Hinv = jnp.linalg.inv(H_home_to_current.astype(jnp.float64)).astype(
        jnp.float32)
    ys, xs = jnp.mgrid[0:h, 0:w]
    u, v = _homog_apply(Hinv, xs.astype(jnp.float32), ys.astype(jnp.float32))
    mean = interpolate.bilinear(model.mean, v, u)
    var = interpolate.bilinear(model.var, v, u)
    known = interpolate.in_bounds(model.mean.shape[:2], v, u) & ~jnp.isnan(mean)
    d2 = (image.astype(jnp.float32) - mean) ** 2
    moving = d2 > (match_sigma ** 2) * jnp.maximum(var, 1e-6)
    out = jnp.where(moving, 1, 0).astype(jnp.uint8)
    return jnp.where(known, out, jnp.uint8(UNKNOWN))


class MovingGmmModel(NamedTuple):
    weight: jnp.ndarray  # [H, W, K]
    mean: jnp.ndarray    # [H, W, K]
    var: jnp.ndarray     # [H, W, K]


def moving_gmm_init(shape_hw, k: int = 3):
    h, w = shape_hw
    return MovingGmmModel(jnp.zeros((h, w, k), jnp.float32),
                          jnp.zeros((h, w, k), jnp.float32),
                          jnp.full((h, w, k), jnp.nan, jnp.float32))


def moving_gmm_update(model: MovingGmmModel, image, H_home_to_current,
                      learn_rate: float = 0.02, initial_var: float = 400.0,
                      match_sigma: float = 3.0, min_var: float = 4.0):
    """BackgroundMovingGmm analog: warp frame into home coords, then run the
    stationary GMM responsibility update on visible pixels only."""
    vals, seen = _frame_sample(image, H_home_to_current,
                               model.mean.shape[:2])
    x = vals[..., None]
    w_, mu, var = model.weight, model.mean, model.var
    alive = ~jnp.isnan(var)
    var_s = jnp.where(alive, var, initial_var)
    d2 = (x - mu) ** 2
    match = alive & (d2 < (match_sigma ** 2) * var_s) & (w_ > 0)
    # closest matching component wins
    score = jnp.where(match, d2 / var_s, jnp.inf)
    best = jnp.argmin(score, axis=-1)
    onehot = jax.nn.one_hot(best, w_.shape[-1], dtype=jnp.float32)
    any_match = jnp.any(match, axis=-1, keepdims=True)
    own = onehot * any_match
    w_new = w_ + learn_rate * (own - w_)
    mu_new = jnp.where(own > 0, mu + (learn_rate / jnp.maximum(w_new, 1e-3))
                       * (x - mu), mu)
    var_new = jnp.where(own > 0, jnp.maximum(
        var_s + (learn_rate / jnp.maximum(w_new, 1e-3)) * (d2 - var_s),
        min_var), var_s)
    # no match: replace weakest component
    weakest = jnp.argmin(jnp.where(alive, w_, -1.0), axis=-1)
    replace = jax.nn.one_hot(weakest, w_.shape[-1], dtype=jnp.float32) \
        * (1.0 - any_match)
    w_new = jnp.where(replace > 0, learn_rate, w_new)
    mu_new = jnp.where(replace > 0, x, mu_new)
    var_new = jnp.where(replace > 0, initial_var, var_new)
    w_new = w_new / jnp.maximum(jnp.sum(w_new, -1, keepdims=True), 1e-6)
    seen3 = seen[..., None]
    return MovingGmmModel(jnp.where(seen3, w_new, w_),
                          jnp.where(seen3, mu_new, mu),
                          jnp.where(seen3, var_new, var))


def moving_gmm_segment(model: MovingGmmModel, image, H_home_to_current,
                       match_sigma: float = 3.0,
                       min_background_weight: float = 0.1):
    from boofcv_tpu.ip import interpolate
    h, w = image.shape[:2]
    Hinv = jnp.linalg.inv(H_home_to_current.astype(jnp.float64)).astype(
        jnp.float32)
    ys, xs = jnp.mgrid[0:h, 0:w]
    u, v = _homog_apply(Hinv, xs.astype(jnp.float32), ys.astype(jnp.float32))
    mean = interpolate.bilinear(model.mean, v, u)
    var = interpolate.bilinear(model.var, v, u)
    wgt = interpolate.bilinear(model.weight, v, u)
    known = interpolate.in_bounds(model.mean.shape[:2], v, u) \
        & jnp.any(~jnp.isnan(var) & (wgt > 0), axis=-1)
    x = image.astype(jnp.float32)[..., None]
    ok = (~jnp.isnan(var)) & (wgt >= min_background_weight) & \
        ((x - mean) ** 2 < (match_sigma ** 2)
         * jnp.maximum(jnp.where(jnp.isnan(var), 1.0, var), 1e-6))
    bg = jnp.any(ok, axis=-1)
    out = jnp.where(bg, 0, 1).astype(jnp.uint8)
    return jnp.where(known, out, jnp.uint8(UNKNOWN))
