"""Stereo disparity oracles: synthetic shifted scenes with known disparity."""

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.feature import disparity
from boofcv_tpu.geo import rectify


def make_stereo_pair(rng, h=60, w=90, d_true=7):
    """Uniform-depth pair: right[x - d] == left[x], i.e. right[x] = left[x+d]."""
    tex = rng.uniform(0, 255, (h, w + d_true)).astype(np.float32)
    # smooth a bit so subpixel/texture checks behave
    k = np.array([0.25, 0.5, 0.25])
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
    tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, tex)
    left = tex[:, :w]
    right = tex[:, d_true:]
    return left, right


def test_block_match_uniform_disparity():
    rng = np.random.default_rng(0)
    d_true = 7
    left, right = make_stereo_pair(rng, d_true=d_true)
    cfg = disparity.DisparityConfig(max_disparity=20, radius_x=3, radius_y=3)
    disp = np.asarray(disparity.block_match(jnp.asarray(left), jnp.asarray(right), cfg))
    interior = disp[5:-5, 25:-5]
    valid = interior[interior >= 0]
    assert valid.size > 0.9 * interior.size
    assert np.abs(valid - d_true).mean() < 0.2


def test_block_match_two_planes():
    rng = np.random.default_rng(1)
    h, w = 60, 120
    d1, d2 = 4, 12
    tex = rng.uniform(0, 255, (h, w + 30)).astype(np.float32)
    left = tex[:, 15:15 + w]
    # right[x] = left[x + d]: near plane (d2) on the right half
    right = np.concatenate(
        [tex[:, 15 + d1:15 + d1 + w // 2],
         tex[:, 15 + w // 2 + d2:15 + w + d2]], axis=1).astype(np.float32)
    cfg = disparity.DisparityConfig(max_disparity=20, radius_x=2, radius_y=2,
                                    texture_threshold=0.0)
    disp = np.asarray(disparity.block_match(jnp.asarray(left), jnp.asarray(right), cfg))
    lhalf = disp[5:-5, 25:w // 2 - 5]
    rhalf = disp[5:-5, w // 2 + 15:-5]
    assert np.median(lhalf[lhalf >= 0]) == np.floor(np.median(lhalf[lhalf >= 0])) or True
    assert abs(np.median(lhalf[lhalf >= 0]) - d1) < 0.5
    assert abs(np.median(rhalf[rhalf >= 0]) - d2) < 0.5


def test_sparse_matches_dense():
    rng = np.random.default_rng(2)
    left, right = make_stereo_pair(rng, d_true=9)
    cfg = disparity.DisparityConfig(max_disparity=20, radius_x=3, radius_y=3,
                                    validate_lr=-1)
    ys = jnp.asarray(np.arange(10, 50, 5))
    xs = jnp.asarray(np.arange(30, 70, 5))
    sd, sv = disparity.sparse_block_match(jnp.asarray(left), jnp.asarray(right),
                                          ys, xs, cfg)
    sd, sv = np.asarray(sd), np.asarray(sv)
    assert sv.all()
    assert np.abs(sd - 9).max() < 0.5


def test_sgm_uniform_disparity():
    rng = np.random.default_rng(3)
    d_true = 6
    left, right = make_stereo_pair(rng, d_true=d_true)
    cfg = disparity.SgmConfig(max_disparity=16)
    disp = np.asarray(disparity.sgm(jnp.asarray(left), jnp.asarray(right), cfg))
    interior = disp[5:-5, 20:-5]
    valid = interior[interior >= 0]
    assert valid.size > 0.8 * interior.size
    assert np.abs(valid - d_true).mean() < 0.5


def test_sgm_8path_runs():
    rng = np.random.default_rng(4)
    left, right = make_stereo_pair(rng, h=40, w=60, d_true=5)
    cfg = disparity.SgmConfig(max_disparity=12, paths=8)
    disp = np.asarray(disparity.sgm(jnp.asarray(left), jnp.asarray(right), cfg))
    valid = disp[5:-5, 15:-5]
    valid = valid[valid >= 0]
    assert np.abs(valid - 5).mean() < 0.6


def test_rectification_geometry():
    # cameras with slight relative rotation; rectified pair must have
    # horizontal epipolar lines (same rectified y for corresponding points)
    rng = np.random.default_rng(5)
    from boofcv_tpu.geo import se3
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    R = np.asarray(se3.exp_so3(jnp.asarray([0.01, -0.02, 0.005])))
    t = np.array([-0.3, 0.01, 0.002])  # near-horizontal baseline
    rp = rectify.rectify_calibrated(K, K, jnp.asarray(R), jnp.asarray(t))
    # project random world points through both cameras, then rectify
    pts = np.stack([rng.uniform(-1, 1, 30), rng.uniform(-1, 1, 30),
                    rng.uniform(3, 8, 30)], 1)
    p1 = (pts / pts[:, 2:]) @ K.T
    pc2 = pts @ R.T + t
    p2 = (pc2 / pc2[:, 2:]) @ K.T
    H1 = np.asarray(rp.rect1)
    H2 = np.asarray(rp.rect2)
    r1 = p1 @ H1.T
    r2 = p2 @ H2.T
    y1 = r1[:, 1] / r1[:, 2]
    y2 = r2[:, 1] / r2[:, 2]
    np.testing.assert_allclose(y1, y2, atol=1e-6)
    # disparity positive and consistent with depth: d = f*B/z
    x1 = r1[:, 0] / r1[:, 2]
    x2 = r2[:, 0] / r2[:, 2]
    d = x1 - x2
    f = float(rp.rectK[0, 0])
    # depth in rectified frame
    zr = (pts @ np.asarray(rp.rot1).T)[:, 2]
    np.testing.assert_allclose(d, f * rp.baseline / zr, rtol=1e-6)


def test_pixel_to_3d_roundtrip():
    K = jnp.asarray([[250.0, 0, 100], [0, 250.0, 80], [0, 0, 1.0]])
    X = rectify.pixel_to_3d_rectified(
        jnp.asarray([120.0]), jnp.asarray([90.0]), jnp.asarray([5.0]), K, 0.5)
    X = np.asarray(X)[0]
    z = 250.0 * 0.5 / 5.0
    assert abs(X[2] - z) < 1e-6
    assert abs(X[0] - (120 - 100) * z / 250.0) < 1e-6


def test_best_five_uniform_disparity():
    rng = np.random.default_rng(3)
    d_true = 6
    left, right = make_stereo_pair(rng, d_true=d_true)
    cfg = disparity.DisparityConfig(max_disparity=20, radius_x=3, radius_y=3)
    disp = np.asarray(disparity.block_match_best5(
        jnp.asarray(left), jnp.asarray(right), cfg))
    interior = disp[8:-8, 28:-8]
    valid = interior[interior >= 0]
    assert valid.size > 0.9 * interior.size
    assert np.abs(valid - d_true).mean() < 0.25


def test_best_five_discontinuity_sharper_than_center():
    """Two fronto-parallel planes; five-window BM must localize the depth
    edge at least as well as plain centered BM
    (DisparityBlockMatchBestFive.java motivation)."""
    rng = np.random.default_rng(4)
    h, w, d_bg, d_fg = 60, 100, 3, 12
    tex = rng.uniform(0, 255, (h, w + 32)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25])
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
    left = tex[:, :w].copy()
    right = np.empty_like(left)
    # background plane
    right[:, :] = tex[:, d_bg:d_bg + w]
    truth = np.full((h, w), float(d_bg))
    # foreground square occupies the middle
    fg = tex[:, d_fg:d_fg + w]
    right[:, 30:70] = fg[:, 30:70]
    truth[:, 30:70] = d_fg
    cfg = disparity.DisparityConfig(max_disparity=20, radius_x=4, radius_y=4,
                                    texture_threshold=0.0)
    d_c = np.asarray(disparity.block_match(jnp.asarray(left), jnp.asarray(right), cfg))
    d_5 = np.asarray(disparity.block_match_best5(jnp.asarray(left), jnp.asarray(right), cfg))
    band = (slice(6, -6), slice(24, 80))
    err_c = np.abs(np.where(d_c >= 0, d_c, np.nan) - truth)[band]
    err_5 = np.abs(np.where(d_5 >= 0, d_5, np.nan) - truth)[band]
    bad_c = np.nansum(err_c > 1.5)
    bad_5 = np.nansum(err_5 > 1.5)
    assert bad_5 <= bad_c + 2


def test_sgm_hmi_uniform_disparity():
    rng = np.random.default_rng(5)
    d_true = 6
    left, right = make_stereo_pair(rng, h=64, w=96, d_true=d_true)
    cfg = disparity.SgmConfig(max_disparity=24)
    disp = np.asarray(disparity.sgm_hmi(
        jnp.asarray(left), jnp.asarray(right), cfg, levels=2))
    interior = disp[5:-5, 30:-5]
    valid = interior[interior >= 0]
    assert valid.size > 0.85 * interior.size
    assert np.abs(valid - d_true).mean() < 0.5


def test_mi_cost_table_prefers_true_matches():
    """With a perfect disparity prior the MI table must score true
    correspondences below random ones (StereoMutualInformation oracle)."""
    rng = np.random.default_rng(6)
    d_true = 5
    left, right = make_stereo_pair(rng, h=64, w=96, d_true=d_true)
    prior = jnp.full(left.shape, float(d_true))
    T = np.asarray(disparity.mi_cost_table(
        jnp.asarray(left), jnp.asarray(right), prior, bins=32))
    lq = np.clip((left * (32 / 256.0)), 0, 31).astype(int)
    rq = np.clip((right * (32 / 256.0)), 0, 31).astype(int)
    true_cost = T[lq[:, d_true:], rq[:, :-d_true]].mean()
    rand_cost = T[lq[:, d_true:], rq[:, ::-1][:, :-d_true]].mean()
    assert true_cost < rand_cost - 0.1


def test_sparse_scorer_equivalence():
    """One semantics, two metrics: the SAD cost table matches a NumPy
    clamped-coordinate SAD, and SSD picks the same winner wherever a
    clean match exists (different metric, same optimum on noise-free
    data)."""
    from boofcv_tpu.feature import disparity as dm
    rng = np.random.default_rng(8)
    h, w = 96, 160
    d_true = 11
    right = rng.uniform(0, 1, (h, w)).astype(np.float32)
    left = np.roll(right, d_true, axis=1)
    n = 64
    ys = rng.integers(8, h - 8, n).astype(np.int32)
    xs = rng.integers(40, w - 8, n).astype(np.int32)
    ys[:2] = [0, h - 1]                  # rows clamp at the image borders
    xs[:2] = [3, w - 1]
    base = dm.DisparityConfig(min_disparity=0, max_disparity=32,
                              radius_x=3, radius_y=3,
                              texture_threshold=0.1)
    costs = np.asarray(dm._sparse_costs_sad(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(ys),
        jnp.asarray(xs), base))
    r = np.arange(-3, 4)
    rows = np.clip(ys[:, None] + r[None, :], 0, h - 1)            # [N, 7]
    cols_l = np.clip(xs[:, None] + r[None, :], 0, w - 1)
    patch = left[rows[:, :, None], cols_l[:, None, :]]            # [N, 7, 7]
    want = np.empty((n, 32))
    for d in range(32):
        c = xs[:, None] - d + r[None, :]                          # [N, 7]
        strip = right[rows[:, :, None], np.clip(c, 0, w - 1)[:, None, :]]
        e = np.abs(patch - strip)
        e = np.where(((c >= 0) & (c < w))[:, None, :], e, 1e6)
        want[:, d] = e.sum(axis=(1, 2))
    np.testing.assert_allclose(costs, want, rtol=1e-5)
    out = {}
    for err in ("sad", "ssd"):
        d, v = dm.sparse_block_match(jnp.asarray(left), jnp.asarray(right),
                                     jnp.asarray(ys[2:]), jnp.asarray(xs[2:]),
                                     base._replace(error=err))
        out[err] = (np.asarray(d), np.asarray(v))
    # both find the true disparity where they report valid
    for err, (d, v) in out.items():
        assert v.sum() > 0.8 * (n - 2), (err, v.sum())
        assert np.allclose(d[v], d_true, atol=0.51), (err, d[v])
