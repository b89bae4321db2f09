"""Stereo disparity: block matching (dense + sparse) and SGM.

Reference analog: boofcv-feature alg/feature/disparity/ —
DisparityBlockMatchRowFormat.java:44 (row-format BM),
block/select/* (WTA with left-right + texture validation),
block/BlockRowScoreSad.java (SAD scores), DisparitySparseScoreSadRect.java
(sparse per-pixel BM), sgm/* (SgmDisparityCost, SgmCostAggregation.java:77,
SgmDisparitySelector).

Design: the cost volume is a dense [D, H, W] tensor built from
shifted-image differences + box-filter aggregation (elementwise + conv);
WTA select, left-right check and subpixel interpolation are argmin /
gather ops over the D axis.  SGM's four scanline recurrences become
`lax.scan` over rows/columns with vectorized inner axes (wavefront form).
Images are the *rectified* pair.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.core.border import BorderType, pad
from boofcv_tpu.ip import census as census_mod
from boofcv_tpu.ip.interpolate import gather_windows


INVALID = -1.0


class DisparityConfig(NamedTuple):
    """ConfigDisparityBM analog."""
    min_disparity: int = 0
    max_disparity: int = 64       # exclusive of min: range = max - min
    radius_x: int = 3
    radius_y: int = 3
    max_per_pixel_error: float = -1.0   # <0 disables
    texture_threshold: float = 0.15      # <=0 disables
    validate_lr: int = 1                 # max L-R mismatch; <0 disables
    subpixel: bool = True
    error: str = "sad"                   # sad | census


def _shift_right_image(right: jnp.ndarray, d: int) -> jnp.ndarray:
    """right image shifted so column x aligns with left x - d."""
    h, w = right.shape
    if d == 0:
        return right
    out = jnp.full_like(right, jnp.inf)
    return out.at[:, d:].set(right[:, : w - d])


def cost_volume(left: jnp.ndarray, right: jnp.ndarray,
                cfg: DisparityConfig) -> jnp.ndarray:
    """[D, H, W] aggregated matching cost.

    cost[d, y, x] = sum over (2rx+1)x(2ry+1) window of per-pixel error
    between left(y, x) and right(y, x - (min_disparity + d)).
    """
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    if cfg.error == "census":
        lc = census_mod.dense5x5(left).astype(jnp.uint32)
        rc = census_mod.dense5x5(right).astype(jnp.uint32)
        w_img = left.shape[1]

        def per_pixel(d):
            rs = _shift_census(rc, cfg.min_disparity + d)
            ham = _hamming32(lc, rs).astype(jnp.float32)
            # out-of-range sentinel (the SAD path's 1e6 analog): the
            # zero-filled shift otherwise scores hamming(lc, 0), which
            # a locally-uniform left patch can WIN with — kept moderate
            # (>> max hamming 24, small enough that the box-filter's
            # f32 cumsums keep sub-bit resolution next to it)
            oor = jnp.arange(w_img)[None, :] < (cfg.min_disparity + d)
            return jnp.where(oor, 100.0, ham)
    else:
        def per_pixel(d):
            rs = _shift_right_image(right, cfg.min_disparity + d)
            e = jnp.abs(left - rs)
            return jnp.where(jnp.isfinite(e), e, 1e6)

    n_disp = cfg.max_disparity - cfg.min_disparity
    errs = jnp.stack([per_pixel(d) for d in range(n_disp)], axis=0)
    # box aggregation over the window via separable cumulative sums
    return _separable_box(errs, cfg.radius_y, cfg.radius_x)


def _separable_box(vol: jnp.ndarray, ry: int, rx: int) -> jnp.ndarray:
    """Box-sum filter each [H, W] slice of [D, H, W] (EXTENDED-free: zero
    pad — windows at borders simply sum fewer valid terms, matching the
    reference's border crop which we keep valid-masked instead)."""
    v = jnp.pad(vol, ((0, 0), (ry, ry), (rx, rx)))
    cs = jnp.cumsum(v, axis=1)
    cs = jnp.pad(cs, ((0, 0), (1, 0), (0, 0)))
    top = cs[:, : -2 * ry - 1, :]
    bot = cs[:, 2 * ry + 1:, :]
    v = bot - top
    cs = jnp.cumsum(v, axis=2)
    cs = jnp.pad(cs, ((0, 0), (0, 0), (1, 0)))
    return cs[:, :, 2 * rx + 1:] - cs[:, :, : -2 * rx - 1]


def _shift_census(c: jnp.ndarray, d: int) -> jnp.ndarray:
    h, w = c.shape
    if d == 0:
        return c
    out = jnp.zeros_like(c)
    return out.at[:, d:].set(c[:, : w - d])


def _hamming32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    x = jnp.bitwise_xor(a, b)
    # popcount via bit tricks (uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _wta_select(cost: jnp.ndarray, cfg: DisparityConfig) -> jnp.ndarray:
    """Winner-take-all + validations; returns float disparity image
    ([H, W], INVALID where rejected).  Mirrors block/select/
    SelectRectStandard semantics: texture check, left-right check,
    subpixel quadratic interpolation."""
    n_disp, h, w = cost.shape
    best = jnp.argmin(cost, axis=0)                      # [H, W]
    cbest = jnp.min(cost, axis=0)

    disp = best.astype(jnp.float32)
    valid = jnp.ones((h, w), bool)

    # pixels whose disparity would reach off the left edge are invalid
    xs = jnp.arange(w)[None, :]
    valid &= xs >= (cfg.min_disparity + best)

    # texture validation: second-best (excluding +-1 neighbors) must be
    # sufficiently worse: (c2 - c1) / c1 > threshold
    if cfg.texture_threshold > 0:
        d_idx = jnp.arange(n_disp)[:, None, None]
        near = jnp.abs(d_idx - best[None]) <= 1
        masked = jnp.where(near, jnp.inf, cost)
        c2 = jnp.min(masked, axis=0)
        ok = (c2 - cbest) > cfg.texture_threshold * jnp.maximum(cbest, 1e-6)
        valid &= ok | ~jnp.isfinite(c2)

    if cfg.max_per_pixel_error > 0:
        area = (2 * cfg.radius_x + 1) * (2 * cfg.radius_y + 1)
        valid &= cbest <= cfg.max_per_pixel_error * area

    # left-right consistency: compute right-image disparity by re-indexing
    # the same volume: costR[d, y, x] = cost[d, y, x + min + d].
    # GATHER-FREE: the reindex offset is static per d (96 pad+slice
    # shifts) and the "evaluate bestR at x - (min+d)" lookup becomes a
    # shifted comparison reduced through the one-hot of best.
    def _shl(a, s):
        return a if s == 0 else jnp.pad(a, ((0, 0), (0, s)),
                                        mode="edge")[:, s:]

    def _shr(a, s):
        return a if s == 0 else jnp.pad(a, ((0, 0), (s, 0)),
                                        mode="edge")[:, :w]

    d_idx = jnp.arange(n_disp)[:, None, None]
    sel = d_idx == best[None]                            # [D, H, W]
    if cfg.validate_lr >= 0:
        costR = jnp.stack([_shl(cost[d], cfg.min_disparity + d)
                           for d in range(n_disp)])
        bestR = jnp.argmin(costR, axis=0)                # [H, W]
        # check: bestR evaluated at x - (min+best) should equal best
        ok_d = jnp.stack([
            jnp.abs(_shr(bestR, cfg.min_disparity + d) - d)
            <= cfg.validate_lr for d in range(n_disp)])
        valid &= jnp.any(ok_d & sel, axis=0)

    if cfg.subpixel:
        # cost at best-1 / best+1 via rolled one-hot selectors (wrap
        # contamination only at the ends, which the interior mask drops)
        cm = jnp.sum(jnp.where(jnp.roll(sel, -1, 0), cost, 0.0), axis=0)
        cp = jnp.sum(jnp.where(jnp.roll(sel, 1, 0), cost, 0.0), axis=0)
        denom = cm - 2.0 * cbest + cp
        off = jnp.where(denom > 1e-9, 0.5 * (cm - cp) / denom, 0.0)
        off = jnp.clip(off, -0.5, 0.5)
        interior = (best > 0) & (best < n_disp - 1)
        disp = disp + jnp.where(interior, off, 0.0)

    return jnp.where(valid, disp, INVALID)


def block_match(left: jnp.ndarray, right: jnp.ndarray,
                cfg: DisparityConfig = DisparityConfig()) -> jnp.ndarray:
    """Dense BM disparity (DisparityBlockMatchRowFormat.process:95 analog).

    Returns [H, W] float disparities *relative to min_disparity=0 pixel
    units* (add nothing: value = true disparity in pixels), INVALID where
    rejected.
    """
    cost = cost_volume(left, right, cfg)
    disp = _wta_select(cost, cfg)
    return jnp.where(disp >= 0, disp + cfg.min_disparity, disp)


def sparse_sad_windows(cfg):
    """(wy, wx, pad) of the two window gathers of the sparse SAD: the left
    (PH, P) patch and the right (PH, D + 2rx) strip.  ``pad`` covers every
    window of a track inside the image."""
    rx, ry = cfg.radius_x, cfg.radius_y
    n_disp = cfg.max_disparity - cfg.min_disparity
    pad = max(ry, rx + max(cfg.max_disparity - 1, -cfg.min_disparity, 0))
    return (2 * ry + 1, 2 * rx + 1, pad), (2 * ry + 1, n_disp + 2 * rx, pad)


def _sparse_costs_sad(left, right, ys, xs, cfg):
    """[N, D] SAD cost table (DisparitySparseScoreSadRect's scoring).

    One window gather per track and image: the left (PH, P) patch and the
    right (PH, D + 2rx) strip that every candidate disparity slides over,
    both with EXTENDED border rows; the [N, D, PH, P] table is static
    slices of the strip.  Out-of-image strip columns score 1e6 per
    element.
    """
    w = left.shape[1]
    rx, ry = cfg.radius_x, cfg.radius_y
    n_disp = cfg.max_disparity - cfg.min_disparity
    p = 2 * rx + 1
    patch_shape, (ph, wide_w, margin) = sparse_sad_windows(cfg)
    x0 = xs - rx - (cfg.min_disparity + n_disp - 1)      # leftmost column
    patch_l = gather_windows(left, ys - ry, xs - rx, *patch_shape)
    strip = gather_windows(right, ys - ry, x0, ph, wide_w, margin)
    cols = x0[:, None] + jnp.arange(wide_w)[None, :]     # [N, W']
    colb = (cols >= 0) & (cols < w)
    strip = jnp.where(colb[:, None, :], strip, jnp.inf)
    # window for disparity index d starts at column (n_disp - 1 - d)
    sl = jnp.stack([strip[:, :, n_disp - 1 - d: n_disp - 1 - d + p]
                    for d in range(n_disp)], axis=1)     # [N, D, PH, P]
    e = jnp.abs(patch_l[:, None] - sl)
    e = jnp.where(jnp.isfinite(e), e, 1e6)
    return jnp.sum(e, axis=(2, 3))                       # [N, D]


def _sparse_costs_ssd(left, right, ys, xs, cfg):
    """[N, D] SSD cost table with the cross term as ONE grouped
    convolution (per-track template x full right-image rows):
    SSD = |L|^2 + |R_win|^2 - 2 <L, R_win>, where <L, R_win> over every
    window position is a correlation.  The semantic SSD option, not a
    fast path."""
    h, w = left.shape
    rx, ry = cfg.radius_x, cfg.radius_y
    n = ys.shape[0]
    n_disp = cfg.max_disparity - cfg.min_disparity
    p = 2 * rx + 1
    ph = 2 * ry + 1
    dy = jnp.arange(-ry, ry + 1)
    dx = jnp.arange(-rx, rx + 1)
    yy = jnp.clip(ys[:, None, None] + dy[None, :, None], 0, h - 1)
    xx = jnp.clip(xs[:, None, None] + dx[None, None, :], 0, w - 1)
    patch_l = left[yy, xx]                               # [N, PH, P]
    rows_r = right[jnp.clip(ys[:, None] + dy[None, :], 0, h - 1)]  # [N, PH, W]

    # cross[n, k] = sum_ij patch_l[n,i,j] * rows_r[n,i,k+j]
    cross = lax.conv_general_dilated(
        rows_r.reshape(1, n * ph, w), patch_l,
        window_strides=(1,), padding=[(0, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        feature_group_count=n,
        precision=lax.Precision.HIGHEST)[0]              # [N, W - P + 1]
    # sliding |R_win|^2 via cumsum over columns of the row-summed squares
    r2 = jnp.sum(rows_r * rows_r, axis=1)                # [N, W]
    cs = jnp.pad(jnp.cumsum(r2, axis=1), ((0, 0), (1, 0)))
    win2 = cs[:, p:] - cs[:, :-p]                        # [N, W - P + 1]
    l2 = jnp.sum(patch_l * patch_l, axis=(1, 2))         # [N]

    # window start column for disparity index d: x - (min + d) - rx
    k = (xs[:, None] - cfg.min_disparity - rx
         - jnp.arange(n_disp)[None, :])                  # [N, D]
    in_range = (k >= 0) & (k <= w - p)
    kc = jnp.clip(k, 0, w - p)
    ssd = (l2[:, None] + jnp.take_along_axis(win2, kc, axis=1)
           - 2.0 * jnp.take_along_axis(cross, kc, axis=1))
    ssd = jnp.maximum(ssd, 0.0)
    return jnp.where(in_range, ssd, 1e18)


def sparse_block_match(left: jnp.ndarray, right: jnp.ndarray,
                       ys, xs, cfg: DisparityConfig = DisparityConfig()):
    """Sparse per-pixel BM at N locations (DisparitySparseScoreSadRect).

    ys, xs: [N] int coords in the left image.  Returns (disp [N] float,
    valid [N] bool).  Scoring: cfg.error == "sad" is the reference's SAD
    over gathered strips (VO spawn depth); "ssd" uses the grouped-conv
    path.  No dense volume is materialized either way.
    """
    left = left.astype(jnp.float32)
    right = right.astype(jnp.float32)
    h, w = left.shape
    rx = cfg.radius_x
    n_disp = cfg.max_disparity - cfg.min_disparity

    if cfg.error == "ssd":
        costs = _sparse_costs_ssd(left, right, ys, xs, cfg)
    elif cfg.error == "sad":
        costs = _sparse_costs_sad(left, right, ys, xs, cfg)
    else:
        raise ValueError(f"sparse_block_match: unknown error {cfg.error!r}: "
                         "'sad' or 'ssd'")
    best = jnp.argmin(costs, axis=1)
    cbest = jnp.min(costs, axis=1)
    valid = (xs - (cfg.min_disparity + best) >= 0) & (cbest < 1e17)
    if cfg.max_per_pixel_error > 0:
        area = (2 * rx + 1) * (2 * cfg.radius_y + 1)
        # SSD costs are squared per-pixel errors — square the bound
        bound = (cfg.max_per_pixel_error ** 2 if cfg.error == "ssd"
                 else cfg.max_per_pixel_error)
        valid &= cbest <= bound * area
    if cfg.texture_threshold > 0:
        d_idx = jnp.arange(n_disp)[None, :]
        near = jnp.abs(d_idx - best[:, None]) <= 1
        c2 = jnp.min(jnp.where(near, jnp.inf, costs), axis=1)
        valid &= ((c2 - cbest) > cfg.texture_threshold * jnp.maximum(cbest, 1e-6)) | ~jnp.isfinite(c2)

    disp = best.astype(jnp.float32)
    if cfg.subpixel:
        dm = jnp.clip(best - 1, 0, n_disp - 1)
        dp = jnp.clip(best + 1, 0, n_disp - 1)
        cm = jnp.take_along_axis(costs, dm[:, None], axis=1)[:, 0]
        cp = jnp.take_along_axis(costs, dp[:, None], axis=1)[:, 0]
        denom = cm - 2.0 * cbest + cp
        off = jnp.where(denom > 1e-9, 0.5 * (cm - cp) / denom, 0.0)
        interior = (best > 0) & (best < n_disp - 1)
        disp += jnp.where(interior, jnp.clip(off, -0.5, 0.5), 0.0)
    return disp + cfg.min_disparity, valid


# ---------------------------------------------------------------------------
# Semi-global matching
# ---------------------------------------------------------------------------

class SgmConfig(NamedTuple):
    """ConfigDisparitySGM analog."""
    min_disparity: int = 0
    max_disparity: int = 64
    penalty_small: float = 5.0     # P1: |dd|=1 transitions
    penalty_large: float = 60.0    # P2: larger jumps
    paths: int = 4                 # 4 (axis-aligned) or 8 (+diagonals)
    error: str = "census"          # census | sad
    validate_lr: int = 1
    subpixel: bool = True
    texture_threshold: float = 0.0


def _sgm_scan(cost: jnp.ndarray, p1: float, p2: float) -> jnp.ndarray:
    """Aggregate along axis 2 (left->right) with the SGM recurrence.

    cost: [D, H, W].  Returns aggregated [D, H, W].  Other directions are
    obtained by flipping/transposing before the call — each direction is a
    lax.scan over the scanline axis with [D, H] vectorized state
    (SgmCostAggregation.java:174's scanline hot loop in wavefront form).
    """
    D = cost.shape[0]
    big = jnp.float32(1e9)

    def step(prev, c):
        # prev, c: [D, H]
        m = jnp.min(prev, axis=0)                          # [H]
        up = jnp.concatenate([jnp.full_like(prev[:1], big), prev[:-1]], axis=0)
        dn = jnp.concatenate([prev[1:], jnp.full_like(prev[:1], big)], axis=0)
        best = jnp.minimum(jnp.minimum(prev, up + p1),
                           jnp.minimum(dn + p1, m[None] + p2))
        out = c + best - m[None]
        return out, out

    c0 = cost[:, :, 0]
    _, agg = lax.scan(step, c0, jnp.moveaxis(cost[:, :, 1:], 2, 0))
    agg = jnp.moveaxis(agg, 0, 2)                          # [D, H, W-1]
    return jnp.concatenate([c0[:, :, None], agg], axis=2)


def sgm(left: jnp.ndarray, right: jnp.ndarray,
        cfg: SgmConfig = SgmConfig()) -> jnp.ndarray:
    """Semi-global matching disparity (SgmStereoDisparity.java:28 analog).

    Census (or SAD) per-pixel cost, 4- or 8-path aggregation, WTA with
    left-right check and subpixel interpolation.  Returns [H, W] float
    disparities, INVALID where rejected.
    """
    bm_cfg = DisparityConfig(
        min_disparity=cfg.min_disparity, max_disparity=cfg.max_disparity,
        radius_x=0, radius_y=0, error=cfg.error,
        texture_threshold=cfg.texture_threshold,
        validate_lr=cfg.validate_lr, subpixel=cfg.subpixel)
    # per-pixel (unaggregated window) cost
    cost = cost_volume(left, right, bm_cfg._replace(radius_x=0, radius_y=0))
    cost = jnp.minimum(cost, 1e5)  # clamp out-of-bounds sentinel

    p1, p2 = cfg.penalty_small, cfg.penalty_large
    agg = _sgm_scan(cost, p1, p2)                                  # L->R
    agg = agg + jnp.flip(_sgm_scan(jnp.flip(cost, 2), p1, p2), 2)  # R->L
    ct = jnp.swapaxes(cost, 1, 2)
    agg = agg + jnp.swapaxes(_sgm_scan(ct, p1, p2), 1, 2)          # T->B
    agg = agg + jnp.swapaxes(
        jnp.flip(_sgm_scan(jnp.flip(ct, 2), p1, p2), 2), 1, 2)     # B->T
    if cfg.paths >= 8:
        # diagonals via row-shifted shear: shift row y by y columns so the
        # diagonal becomes a column scan
        d_, h, w = cost.shape

        def shear(vol, sign):
            rows = jnp.arange(h)
            shift = (sign * rows) % (w + h)
            padded = jnp.pad(vol, ((0, 0), (0, 0), (0, h)))
            idx = (jnp.arange(w + h)[None, :] - shift[:, None]) % (w + h)
            return jnp.take_along_axis(padded, idx[None].repeat(d_, 0), axis=2)

        def unshear(vol, sign):
            rows = jnp.arange(h)
            shift = (sign * rows) % (w + h)
            idx = (jnp.arange(w + h)[None, :] + shift[:, None]) % (w + h)
            return jnp.take_along_axis(vol, idx[None].repeat(d_, 0), axis=2)[:, :, :w]

        for sign in (1, -1):
            sh = shear(cost, sign)
            a = jnp.swapaxes(_sgm_scan(jnp.swapaxes(sh, 1, 2), p1, p2), 1, 2)
            agg = agg + unshear(a, sign)
            a = jnp.swapaxes(
                jnp.flip(_sgm_scan(jnp.flip(jnp.swapaxes(sh, 1, 2), 2), p1, p2), 2), 1, 2)
            agg = agg + unshear(a, sign)

    disp = _wta_select(agg, bm_cfg)
    return jnp.where(disp >= 0, disp + cfg.min_disparity, disp)


def block_match_best5(left: jnp.ndarray, right: jnp.ndarray,
                      cfg: DisparityConfig = DisparityConfig()) -> jnp.ndarray:
    """Five-window block matching (DisparityBlockMatchBestFive.java).

    Score = center window + the best 2 of the 4 corner-offset windows —
    robust near disparity discontinuities where a single centered window
    straddles two surfaces.  Design: the per-pixel window sums already
    exist as the [D, H, W] aggregated cost volume; the corner windows are
    the same volume shifted by (+-ry, +-rx), so best-2-of-4 is a handful
    of elementwise mins — no extra aggregation passes.
    """
    cost = cost_volume(left, right, cfg)
    ry, rx = cfg.radius_y, cfg.radius_x
    # replicate-edge pad: corner windows that fall outside the image
    # degrade to the nearest in-bounds window score instead of poisoning
    # border pixels (reference clamps corner windows at image borders,
    # DisparityBlockMatchBestFive select)
    pad_c = jnp.pad(cost, ((0, 0), (ry, ry), (rx, rx)), mode="edge")
    h, w = cost.shape[1], cost.shape[2]

    def corner(dy, dx):
        return lax.dynamic_slice(
            pad_c, (0, ry + dy, rx + dx), cost.shape)

    c1 = corner(-ry, -rx)
    c2 = corner(-ry, rx)
    c3 = corner(ry, -rx)
    c4 = corner(ry, rx)
    # sum of the two smallest of four = total - two largest
    total = c1 + c2 + c3 + c4
    m1 = jnp.maximum(jnp.maximum(c1, c2), jnp.maximum(c3, c4))
    # second largest: max of (total of pairwise mins) trick
    m2 = jnp.minimum(jnp.maximum(c1, c2), jnp.maximum(c3, c4))
    m2 = jnp.maximum(m2, jnp.minimum(jnp.maximum(c1, c3),
                                     jnp.maximum(c2, c4)))
    best2 = total - m1 - m2
    five = cost + best2
    # per-pixel-error validation still refers to a 3-window area
    cfg5 = cfg._replace(max_per_pixel_error=cfg.max_per_pixel_error * 3
                        if cfg.max_per_pixel_error > 0 else -1.0)
    disp = _wta_select(five, cfg5)
    return jnp.where(disp >= 0, disp + cfg.min_disparity, disp)


# ---------------------------------------------------------------------------
# SGM with hierarchical mutual-information cost (SgmStereoDisparityHmi)
# ---------------------------------------------------------------------------

def mi_cost_table(left, right, disparity, bins: int = 64,
                  sigma: float = 1.5):
    """Mutual-information matching-cost table from a disparity prior.

    Hirschmuller 2008 (SgmMutualInformation / StereoMutualInformation in
    the reference): joint histogram of corresponding intensities ->
    Gaussian-smoothed -log probabilities; cost(l, r) = h_joint(l, r)
    - h_l(l) - h_r(r), shifted to be >= 0.  All scatter-add / gather, on
    device.  ``disparity`` uses INVALID (<0) for missing pixels.
    """
    from boofcv_tpu.ip import blur

    h, w = left.shape
    lq = jnp.clip((left.astype(jnp.float32) * (bins / 256.0)),
                  0, bins - 1).astype(jnp.int32)
    rq = jnp.clip((right.astype(jnp.float32) * (bins / 256.0)),
                  0, bins - 1).astype(jnp.int32)
    xs = jnp.arange(w)[None, :].astype(jnp.float32)
    xr = jnp.round(xs - disparity).astype(jnp.int32)
    ok = (disparity >= 0) & (xr >= 0) & (xr < w)
    xr = jnp.clip(xr, 0, w - 1)
    r_at = jnp.take_along_axis(rq, xr, axis=1)
    flat = (lq * bins + r_at).ravel()
    wts = ok.ravel().astype(jnp.float32)
    joint = jnp.zeros((bins * bins,), jnp.float32).at[flat].add(wts)
    joint = joint.reshape(bins, bins)
    n = jnp.maximum(jnp.sum(joint), 1.0)
    pj = joint / n
    # smooth -> -log -> smooth (Hirschmuller's double convolution)
    pj_s = blur.gaussian(pj, sigma=sigma)
    hj = blur.gaussian(-jnp.log(pj_s + 1e-8), sigma=sigma)
    pl = jnp.sum(pj, axis=1)
    pr = jnp.sum(pj, axis=0)

    def entropy1(p):
        ps = blur.gaussian(p[None, :], sigma=sigma)[0]
        return blur.gaussian(-jnp.log(ps + 1e-8)[None, :], sigma=sigma)[0]

    hl = entropy1(pl)
    hr = entropy1(pr)
    cost = hj - hl[:, None] - hr[None, :]
    return cost - jnp.min(cost)


def _mi_cost_volume(left, right, table, cfg: SgmConfig, bins: int):
    lq = jnp.clip((left.astype(jnp.float32) * (bins / 256.0)),
                  0, bins - 1).astype(jnp.int32)
    rq = jnp.clip((right.astype(jnp.float32) * (bins / 256.0)),
                  0, bins - 1).astype(jnp.int32)
    flat_t = table.ravel()
    n_disp = cfg.max_disparity - cfg.min_disparity
    h, w = left.shape
    slices = []
    big = jnp.float32(1e5)
    for d in range(n_disp):
        dd = cfg.min_disparity + d
        rs = jnp.concatenate([jnp.zeros((h, dd), rq.dtype),
                              rq[:, : w - dd]], axis=1) if dd else rq
        c = flat_t[lq * bins + rs]
        if dd:
            c = c.at[:, :dd].set(big)
        slices.append(c)
    return jnp.stack(slices, axis=0)


def sgm_hmi(left: jnp.ndarray, right: jnp.ndarray,
            cfg: SgmConfig = SgmConfig(), levels: int = 3,
            bins: int = 64) -> jnp.ndarray:
    """Hierarchical-MI SGM (SgmStereoDisparityHmi.java:57 analog).

    The MI cost needs a disparity prior; hierarchically: census-SGM at the
    coarsest pyramid level seeds the first MI table, then each finer level
    re-estimates disparity with an MI table computed from the upsampled
    prior.  Returns [H, W] float disparity, INVALID where rejected.
    """
    from boofcv_tpu.ip import distort

    h, w = left.shape
    pyr_l, pyr_r = [left.astype(jnp.float32)], [right.astype(jnp.float32)]
    for _ in range(levels - 1):
        # crop odd dims first — the strided quadrant sums have
        # mismatched shapes otherwise (odd inputs crashed)
        def down(p):
            hh, ww = p.shape[0] // 2 * 2, p.shape[1] // 2 * 2
            p = p[:hh, :ww]
            return 0.25 * (p[0::2, 0::2] + p[1::2, 0::2]
                           + p[0::2, 1::2] + p[1::2, 1::2])
        pyr_l.append(down(pyr_l[-1]))
        pyr_r.append(down(pyr_r[-1]))

    scale = 2 ** (levels - 1)
    coarse_cfg = cfg._replace(
        min_disparity=cfg.min_disparity // scale,
        max_disparity=max(cfg.max_disparity // scale, 2), error="census")
    disp = sgm(pyr_l[-1], pyr_r[-1], coarse_cfg)

    for lvl in range(levels - 2, -1, -1):
        li, ri = pyr_l[lvl], pyr_r[lvl]
        hh, ww = li.shape
        # upsample prior disparity (NN) and double its magnitude;
        # edge-pad covers the odd row/col the even-cropped level lost
        up = jnp.repeat(jnp.repeat(disp, 2, 0), 2, 1)
        py, px = hh - up.shape[0], ww - up.shape[1]
        if py > 0 or px > 0:
            up = jnp.pad(up, ((0, max(py, 0)), (0, max(px, 0))),
                         mode="edge")
        up = up[:hh, :ww]
        prior = jnp.where(up >= 0, up * 2.0, INVALID)
        lvl_scale = 2 ** lvl
        lcfg = cfg._replace(
            min_disparity=cfg.min_disparity // lvl_scale,
            max_disparity=max(cfg.max_disparity // lvl_scale, 2))
        table = mi_cost_table(li, ri, prior, bins=bins)
        cost = _mi_cost_volume(li, ri, table, lcfg, bins)
        # reuse the SGM path aggregation by swapping in the MI cost
        p1, p2 = cfg.penalty_small / 10.0, cfg.penalty_large / 10.0
        agg = _sgm_scan(cost, p1, p2)
        agg = agg + jnp.flip(_sgm_scan(jnp.flip(cost, 2), p1, p2), 2)
        ct = jnp.swapaxes(cost, 1, 2)
        agg = agg + jnp.swapaxes(_sgm_scan(ct, p1, p2), 1, 2)
        agg = agg + jnp.swapaxes(
            jnp.flip(_sgm_scan(jnp.flip(ct, 2), p1, p2), 2), 1, 2)
        bm_cfg = DisparityConfig(
            min_disparity=lcfg.min_disparity,
            max_disparity=lcfg.max_disparity, radius_x=0, radius_y=0,
            texture_threshold=cfg.texture_threshold,
            validate_lr=cfg.validate_lr, subpixel=cfg.subpixel)
        d_sel = _wta_select(agg, bm_cfg)
        disp = jnp.where(d_sel >= 0, d_sel + lcfg.min_disparity, d_sel)
    return disp
