"""Breadth benchmarks: dense disparity (BM + SGM), SURF detect+describe,
at-scale association, Horn-Schunck dense flow, Canny, Zhang99
calibration — each timed steady-state on
device against a MEASURED vectorized-numpy CPU baseline (the
``bench._np_lm_schur_baseline`` pattern; the reference itself cannot run
here — no JVM — so the baseline is an honest vectorized reimplementation
of the same algorithm on the host CPU, which is generous to the CPU side
vs the reference's scalar Java loops, e.g. ConvolveImageStandard_SB.java:44,
SgmCostAggregation.java:77).

Each bench prints one JSON line {"metric", "value", "unit",
"vs_baseline", "device"} where vs_baseline = measured CPU ms / device ms.
Needs a GPU; exits non-zero without one.

Run standalone (`python bench_breadth.py`) or via `python bench.py`.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

H, W = 480, 640
DMAX = 96


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _scene_pair(seed=0, height=H, width=W, dmax=DMAX):
    """Synthetic stereo pair with a textured slanted plane, in numpy.
    Returns (left, right, ground-truth disparity); the disparity spans
    18..70 px at the default sizes, scaled with the height otherwise."""
    rng = np.random.default_rng(seed)
    # band-limited texture so matching is well-posed
    tex = rng.normal(0, 1, (height, width + dmax + 8)).astype(np.float32)
    k = np.hanning(9)
    k /= k.sum()
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
    tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, tex)
    tex = 128 + 60 * tex / tex.std()
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    # disparity varies with y only, so the left<->right correspondence is
    # exact per row (an x-gradient makes ground truth implicit)
    disp = (18 + 52 * yy / height + 0 * xx) * (dmax / DMAX)  # tilted plane
    # left pixel x sees the same scene point as right pixel x - d, i.e.
    # right(x) = left(x + d(x)): sample the wide texture shifted by +d
    left = tex[:, :width].copy()
    cols = xx + disp
    c0 = np.floor(cols).astype(int)
    a = cols - c0
    right = (1 - a) * tex[yy.astype(int), c0] + a * tex[yy.astype(int), c0 + 1]
    return left.astype(np.float32), right.astype(np.float32), disp


def _time_device(fn, inputs, reps=3):
    """Steady-state device milliseconds per call: one warm-up call per
    input (compiles), then ``reps`` passes over the inputs, each call
    ending in ``jax.block_until_ready``."""
    for inp in inputs:
        jax.block_until_ready(fn(*inp))
    t0 = time.perf_counter()
    for _ in range(reps):
        for inp in inputs:
            jax.block_until_ready(fn(*inp))
    return (time.perf_counter() - t0) / (reps * len(inputs)) * 1000.0


# Published dense peaks per device kind, for the roofline column.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, at its 700 W power
# limit; a card set to a lower ``power.limit`` cannot hold these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,            # CUDA cores, no tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind):
    """Peak rates of ``device_kind``; a device not in PEAKS is an error."""
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device kind "
                         f"{device_kind!r}; add them to bench_breadth.PEAKS")
    return PEAKS[device_kind]


def require_gpu():
    """The device every bench row names: {platform, kind, count}.  Exits
    non-zero when JAX finds no GPU — CPU timings are not device metrics."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devices[0].platform}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def emit(row):
    """Print one JSON result row, tagged with the device it ran on."""
    print(json.dumps({**row, "device": require_gpu()}), flush=True)


def _roofline(metric, ms, flops, bytes_moved):
    """Log achieved FLOP/s and memory bandwidth vs the device's peaks.

    ``flops``/``bytes_moved`` are ANALYTIC estimates of the algorithm's
    intrinsic work (documented per bench) — an order-of-magnitude
    utilization statement, not a profiler.  The work is f32, so FLOP/s
    are compared with the f32 (non-tensor-core) peak."""
    pk = peaks(jax.devices()[0].device_kind)
    gflops = flops / (ms * 1e-3) / 1e9
    gbs = bytes_moved / (ms * 1e-3) / 1e9
    _log(f"# {metric} roofline: {flops / 1e9:.2f} GFLOP, "
         f"{gflops:.0f} GFLOP/s ({gflops * 1e9 / pk['f32_flops'] * 100:.2f}% "
         f"of f32 peak), ~{bytes_moved / 1e6:.0f} MB moved, "
         f"{gbs:.0f} GB/s "
         f"({gbs * 1e9 / pk['hbm_bytes_per_s'] * 100:.0f}% of HBM peak)")


def _time_cpu(fn, reps=3):
    """Best-of-``reps`` wall time for a CPU baseline: allocation-heavy
    numpy baselines swing several-fold run-to-run on a shared host, and
    the MINIMUM is the measurement most generous to the CPU side.  Returns
    (best_ms, first_result)."""
    best = None
    out = None
    for i in range(reps):
        t0 = time.perf_counter()
        r = fn()
        dt = (time.perf_counter() - t0) * 1000.0
        if out is None:
            out = r
        if best is None or dt < best:
            best = dt
    return best, out


# ---------------------------------------------------------------------------
# numpy baselines
# ---------------------------------------------------------------------------

def _np_box_sum(vol, r):
    """Box sum over the last two axes via cumsum (the integral-image
    trick every fast CPU BM uses)."""
    if r == 0:
        return vol
    p = np.pad(vol, [(0, 0)] * (vol.ndim - 2) + [(r + 1, r), (r + 1, r)])
    c = p.cumsum(-2).cumsum(-1)
    s = 2 * r + 1
    return (c[..., s:, s:] - c[..., :-s, s:] - c[..., s:, :-s]
            + c[..., :-s, :-s])


def _np_block_match(left, right, dmax=DMAX, r=3):
    """Vectorized numpy BM: SAD cost volume via shifts + integral box
    sums, WTA, LR check, parabolic subpixel — the same spec as
    feature.disparity.block_match."""
    Hh, Ww = left.shape
    # out-of-range sentinel must stay small: the f32 cumsum in the box
    # filter loses all SAD precision next to 1e9 entries
    big = 300.0
    cost = np.full((dmax, Hh, Ww), big, np.float32)
    for d in range(dmax):
        diff = np.abs(left[:, d:] - right[:, :Ww - d if d else Ww])
        cost[d, :, d:] = diff
    agg = _np_box_sum(cost, r)
    best = agg.argmin(0)
    bc = np.take_along_axis(agg, best[None], 0)[0]
    # LR consistency: right-image best disparity
    costR = np.full_like(cost, big * (2 * r + 1) ** 2)
    for d in range(dmax):
        costR[d, :, :Ww - d if d else Ww] = agg[d, :, d:]
    bestR = costR.argmin(0)
    xr = np.clip(np.arange(Ww)[None, :] - best, 0, Ww - 1)
    lr_ok = np.abs(np.take_along_axis(bestR, xr, 1) - best) <= 1
    # subpixel parabola
    dm = np.clip(best - 1, 0, dmax - 1)
    dp = np.clip(best + 1, 0, dmax - 1)
    cm = np.take_along_axis(agg, dm[None], 0)[0]
    cp = np.take_along_axis(agg, dp[None], 0)[0]
    denom = np.maximum(cm + cp - 2 * bc, 1e-9)
    sub = best + np.clip(0.5 * (cm - cp) / denom, -0.5, 0.5)
    return np.where(lr_ok, sub, -1.0)


def _np_census5(img):
    """5x5 census transform -> uint32 (vectorized shifts)."""
    p = np.pad(img, 2, mode="edge")
    h, w = img.shape
    out = np.zeros((h, w), np.uint32)
    bit = 0
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if dy == 0 and dx == 0:
                continue
            nb = p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
            out |= (nb < img).astype(np.uint32) << np.uint32(bit)
            bit += 1
    return out


def _np_popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _np_sgm(left, right, dmax=DMAX, p1=5.0, p2=60.0):
    """Vectorized numpy SGM: 5x5 census cost + 4-path aggregation.  The
    per-direction scan is sequential along the path axis but vectorized
    over the perpendicular axis x disparity (the strongest practical CPU
    formulation; the reference's SgmCostAggregation.java:77 is scalar)."""
    Hh, Ww = left.shape
    cl = _np_census5(left)
    cr = _np_census5(right)
    cost = np.full((Hh, Ww, dmax), 24.0, np.float32)
    for d in range(dmax):
        ham = _np_popcount32(cl[:, d:] ^ cr[:, :Ww - d if d else Ww])
        cost[:, d:, d] = ham

    def scan(c):
        # c: [H, W, D]; aggregate along axis 1 left->right
        out = np.empty_like(c)
        out[:, 0] = c[:, 0]
        for x in range(1, c.shape[1]):
            prev = out[:, x - 1]                       # [H, D]
            m = prev.min(-1, keepdims=True)
            shift_m = np.minimum(np.roll(prev, 1, -1),
                                 np.roll(prev, -1, -1))
            shift_m[:, 0] = prev[:, 1]
            shift_m[:, -1] = prev[:, -2]
            best = np.minimum(prev, np.minimum(shift_m + p1, m + p2))
            out[:, x] = c[:, x] + best - m
        return out

    agg = scan(cost)
    agg = agg + scan(cost[:, ::-1])[:, ::-1]
    ct = cost.transpose(1, 0, 2)
    agg = agg + scan(ct).transpose(1, 0, 2)
    agg = agg + scan(ct[:, ::-1])[:, ::-1].transpose(1, 0, 2)
    return agg.argmin(-1)


def _np_surf_detdesc(img, max_feats=1000):
    """Vectorized numpy SURF: integral image, 2-octave FastHessian box
    responses, 3x3x3 nonmax + top-K, Haar orientation + 64-D descriptor
    via fancy-indexed II lookups over all features at once."""
    h, w = img.shape
    ii = np.zeros((h + 1, w + 1), np.float64)
    ii[1:, 1:] = img.cumsum(0).cumsum(1)

    def box(y0, x0, y1, x1):
        y0 = np.clip(y0, 0, h)
        y1 = np.clip(y1, 0, h)
        x0 = np.clip(x0, 0, w)
        x1 = np.clip(x1, 0, w)
        return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]

    yy, xx = np.mgrid[0:h, 0:w]

    def hessian(size):
        l = size // 3
        # Dxx: 3 stacked lxl-ish lobes (borders per Fast-Hessian)
        b = (size - 1) // 2
        half = l // 2
        dxx = (box(yy - l + 1, xx - b, yy + l, xx + b + 1)
               - 3.0 * box(yy - l + 1, xx - half, yy + l, xx + half + 1))
        dyy = (box(yy - b, xx - l + 1, yy + b + 1, xx + l)
               - 3.0 * box(yy - half, xx - l + 1, yy + half + 1, xx + l))
        dxy = (box(yy - l, xx - l, yy + 1, xx + 1)
               + box(yy + 1, xx + 1, yy + l + 1, xx + l + 1)
               - box(yy - l, xx + 1, yy + 1, xx + l + 1)
               - box(yy + 1, xx - l, yy + l + 1, xx + 1))
        n = 1.0 / (size * size)
        dxx *= n
        dyy *= n
        dxy *= n
        return dxx * dyy - 0.81 * dxy * dxy

    feats = []
    for sizes in ((9, 15, 21, 27), (15, 27, 39, 51)):
        resp = np.stack([hessian(s) for s in sizes])
        mid = resp[1:-1]
        # local max: compare against the 26 shifted neighbors directly
        is_max = np.ones_like(mid, bool)
        for ds in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if ds == dy == dx == 0:
                        continue
                    is_max &= mid >= np.roll(resp, (ds, dy, dx),
                                             (0, 1, 2))[1:-1]
        cand = np.where(is_max, mid, -np.inf).reshape(-1)
        k = min(max_feats // 2, cand.size)
        top = np.argpartition(cand, -k)[-k:]
        s_i, rem = np.divmod(top, h * w)
        fy, fx = np.divmod(rem, w)
        feats.append((fy, fx, np.array(sizes)[s_i + 1] / 9.0 * 1.2))
    fy = np.concatenate([f[0] for f in feats])[:max_feats]
    fx = np.concatenate([f[1] for f in feats])[:max_feats]
    fs = np.concatenate([f[2] for f in feats])[:max_feats]

    # descriptor: 4x4 subregions x 5x5 samples of Haar dx, dy
    n = len(fy)
    g = np.arange(-9.5, 10.0, 1.0)                 # 20 samples per axis
    sy = fy[:, None, None] + fs[:, None, None] * g[None, :, None]
    sx = fx[:, None, None] + fs[:, None, None] * g[None, None, :]
    syi = np.clip(sy.astype(int), 2, h - 3)
    sxi = np.clip(sx.astype(int), 2, w - 3)
    r2 = np.maximum((fs * 2).astype(int), 1)[:, None, None]
    hx = (box(syi - r2, sxi, syi + r2, sxi + r2)
          - box(syi - r2, sxi - r2, syi + r2, sxi))
    hy = (box(syi, sxi - r2, syi + r2, sxi + r2)
          - box(syi - r2, sxi - r2, syi, sxi + r2))
    w_g = np.exp(-(g[:, None] ** 2 + g[None, :] ** 2) / (2 * 3.3 ** 2))
    hx = (hx * w_g).reshape(n, 4, 5, 4, 5).transpose(0, 1, 3, 2, 4)
    hy = (hy * w_g).reshape(n, 4, 5, 4, 5).transpose(0, 1, 3, 2, 4)
    desc = np.stack([hx.sum((3, 4)), np.abs(hx).sum((3, 4)),
                     hy.sum((3, 4)), np.abs(hy).sum((3, 4))],
                    -1).reshape(n, 64)
    desc /= np.maximum(np.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
    return fy, fx, desc


def _np_associate(da, db):
    """Mutual-NN association: one BLAS matmul + 2 argmins."""
    s = (-2.0 * da @ db.T + (da * da).sum(1)[:, None]
         + (db * db).sum(1)[None, :])
    fwd = s.argmin(1)
    bwd = s.argmin(0)
    mutual = bwd[fwd] == np.arange(len(da))
    return fwd, mutual


# ---------------------------------------------------------------------------
# benches
# ---------------------------------------------------------------------------

def bench_disparity():
    from boofcv_tpu.feature import disparity

    pairs = [_scene_pair(s) for s in range(3)]
    inputs = [(jnp.asarray(l), jnp.asarray(r)) for l, r, _ in pairs]

    cfg = disparity.DisparityConfig(max_disparity=DMAX, radius_x=3,
                                    radius_y=3, texture_threshold=0.0)
    bm = jax.jit(lambda a, b: disparity.block_match(a, b, cfg))
    ms_bm = _time_device(bm, inputs)
    # accuracy sanity vs ground-truth plane
    d = np.asarray(bm(*inputs[0]))
    gt = pairs[0][2]
    ok = d > 0
    err = np.median(np.abs(d - gt)[ok])
    _log(f"# disparity-BM device: {ms_bm:.1f} ms (median err {err:.2f} px,"
         f" valid {ok.mean():.2f})")

    cpu_bm, dn = _time_cpu(lambda: _np_block_match(*pairs[0][:2]))
    errn = np.median(np.abs(dn - gt)[dn > 0])
    _log(f"# disparity-BM numpy baseline: {cpu_bm:.1f} ms "
         f"(median err {errn:.2f} px)")
    # SAD cost D*H*W*2 + box sums ~8/elem + WTA one-hot selects ~6/elem
    bm_flops = DMAX * H * W * 16.0
    # cost volume is written+read through the box filter and WTA
    _roofline("disparity-BM", ms_bm, bm_flops, DMAX * H * W * 4 * 3.0)
    emit({
        "metric": "disparity_bm_ms_640x480_d96",
        "value": round(ms_bm, 2), "unit": "ms",
        "vs_baseline": round(cpu_bm / ms_bm, 2)})

    scfg = disparity.SgmConfig(max_disparity=DMAX, paths=4,
                               error="census")
    sg = jax.jit(lambda a, b: disparity.sgm(a, b, scfg))
    ms_sgm = _time_device(sg, inputs)
    d = np.asarray(sg(*inputs[0]))
    ok = d > 0
    err = np.median(np.abs(d - gt)[ok])
    _log(f"# disparity-SGM device: {ms_sgm:.1f} ms (median err {err:.2f}"
         f" px, valid {ok.mean():.2f})")

    cpu_sgm, dn = _time_cpu(lambda: _np_sgm(*pairs[0][:2]))
    errn = np.median(np.abs(dn - gt)[dn > 0])
    _log(f"# disparity-SGM numpy baseline: {cpu_sgm:.1f} ms "
         f"(median err {errn:.2f} px)")
    # census 48/px + hamming D*H*W*8 + 4 directional scans ~6 ops/elem
    sgm_flops = H * W * 48.0 + DMAX * H * W * 8.0 + 4 * DMAX * H * W * 6.0
    _roofline("disparity-SGM", ms_sgm, sgm_flops,
              DMAX * H * W * 4 * (1 + 4 * 2.0))
    emit({
        "metric": "disparity_sgm_ms_640x480_d96_4path",
        "value": round(ms_sgm, 2), "unit": "ms",
        "vs_baseline": round(cpu_sgm / ms_sgm, 2)})


def bench_surf():
    from boofcv_tpu.ip import integral as ii_ops
    from boofcv_tpu.feature import fasthessian, describe

    imgs = [_scene_pair(s)[0] for s in range(3)]
    inputs = [(jnp.asarray(im),) for im in imgs]

    def detdesc(img):
        ii = ii_ops.transform(img)
        det = fasthessian.detect_multi_octave(
            ii, max_features_per_octave=500, num_octaves=2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        return describe.surf(ii, det.ys, det.xs, det.scales, ang)

    f = jax.jit(detdesc)
    ms = _time_device(f, inputs)
    nd = np.asarray(f(*inputs[0])).shape[0]
    _log(f"# SURF detect+describe device: {ms:.1f} ms ({nd} features)")

    cpu, (fy, fx, desc) = _time_cpu(
        lambda: _np_surf_detdesc(imgs[0], max_feats=nd))
    _log(f"# SURF numpy baseline: {cpu:.1f} ms ({len(fy)} features)")
    emit({
        "metric": "surf_detdesc_ms_640x480_1000f",
        "value": round(ms, 2), "unit": "ms",
        "vs_baseline": round(cpu / ms, 2)})


def bench_associate():
    from boofcv_tpu.feature import associate

    rng = np.random.default_rng(0)
    N = 10_000
    base = rng.normal(0, 1, (N, 64)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    variants = []
    for s in range(3):
        db = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
        variants.append((jnp.asarray(base), jnp.asarray(db)))

    def assoc(a, b):
        s = associate.score_euclidean_sq(a, b)
        return associate.associate_mutual(s)

    f = jax.jit(assoc)
    ms = _time_device(f, variants)
    m = f(*variants[0])
    nv = int(np.asarray(m.valid).sum())
    _log(f"# association device: {ms:.1f} ms ({nv}/{N} mutual)")

    a0 = np.asarray(base, np.float32)
    b0 = np.asarray(variants[0][1], np.float32)
    cpu, (fwd, mutual) = _time_cpu(lambda: _np_associate(a0, b0))
    _log(f"# association numpy baseline: {cpu:.1f} ms "
         f"({int(mutual.sum())}/{N} mutual)")
    # the [10k, 64] x [64, 10k] distance matmul dominates: 2*N*N*D
    _roofline("association", ms, 2.0 * N * N * 64,
              (2 * N * 64 + N * N) * 4.0)
    emit({
        "metric": "associate_mutual_ms_10kx10k_64d",
        "value": round(ms, 2), "unit": "ms",
        "vs_baseline": round(cpu / ms, 2)})


def _zhang_scene(n_views=12, nx=8, ny=6, noise=0.3, seed=0):
    rng = np.random.default_rng(seed)
    world = np.stack(np.meshgrid(np.arange(nx) * 0.03,
                                 np.arange(ny) * 0.03),
                     -1).reshape(-1, 2)
    K = np.array([[520.0, 0, 320.0], [0, 515.0, 240.0], [0, 0, 1.0]])
    k1, k2 = -0.25, 0.08
    obs = []
    Rs, ts = [], []
    for v in range(n_views):
        w = rng.uniform(-0.5, 0.5, 3)
        w[2] = rng.uniform(-0.3, 0.3)
        th = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / max(th, 1e-12)
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.08, 0.08),
                      rng.uniform(0.5, 0.9)])
        Xc = np.c_[world, np.zeros(len(world))] @ R.T + t
        xn = Xc[:, :2] / Xc[:, 2:]
        r2 = (xn ** 2).sum(1)
        d = 1 + k1 * r2 + k2 * r2 * r2
        xd = xn * d[:, None]
        px = xd @ K[:2, :2].T + K[:2, 2]
        obs.append(px + rng.normal(0, noise, px.shape))
        Rs.append(R)
        ts.append(t)
    return world, np.stack(obs), K, (k1, k2)


def _np_zhang99(world, obs, iterations=20):
    """Vectorized numpy Zhang99: per-view DLT homographies, linear K,
    extrinsics, then damped GN with forward-difference jacobians (the
    reference's ddogleg LM likewise supports numerical jacobians)."""
    V, N, _ = obs.shape

    def homography(src, dst):
        A = []
        for (x, y), (u, v) in zip(src, dst):
            A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
            A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
        _, _, vt = np.linalg.svd(np.asarray(A))
        Hm = vt[-1].reshape(3, 3)
        return Hm / Hm[2, 2]

    Hs = np.stack([homography(world, obs[v]) for v in range(V)])

    def vij(Hv, i, j):
        return np.array([
            Hv[0, i] * Hv[0, j],
            Hv[0, i] * Hv[1, j] + Hv[1, i] * Hv[0, j],
            Hv[1, i] * Hv[1, j],
            Hv[2, i] * Hv[0, j] + Hv[0, i] * Hv[2, j],
            Hv[2, i] * Hv[1, j] + Hv[1, i] * Hv[2, j],
            Hv[2, i] * Hv[2, j]])

    Vm = []
    for v in range(V):
        Vm.append(vij(Hs[v], 0, 1))
        Vm.append(vij(Hs[v], 0, 0) - vij(Hs[v], 1, 1))
    _, _, vt = np.linalg.svd(np.asarray(Vm))
    b11, b12, b22, b13, b23, b33 = vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    Kinv = np.linalg.inv(K)
    params = [fx, fy, 0.0, cx, cy, 0.0, 0.0]
    for v in range(V):
        h1, h2, h3 = (Kinv @ Hs[v]).T
        s = 1.0 / np.linalg.norm(h1)
        r1, r2 = s * h1, s * h2
        r3 = np.cross(r1, r2)
        R = np.stack([r1, r2, r3], 1)
        u, _, vtv = np.linalg.svd(R)
        R = u @ vtv
        t = s * h3
        # log map
        ang = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        if ang < 1e-9:
            w = np.zeros(3)
        else:
            w = ang / (2 * np.sin(ang)) * np.array(
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        params.extend(list(w) + list(t))
    p = np.asarray(params)

    w3 = np.c_[world, np.zeros(len(world))]

    def residual(p):
        fx, fy, sk, cx, cy, k1, k2 = p[:7]
        out = np.empty((V, N, 2))
        for v in range(V):
            w = p[7 + 6 * v:10 + 6 * v]
            t = p[10 + 6 * v:13 + 6 * v]
            th = np.linalg.norm(w)
            if th < 1e-12:
                R = np.eye(3)
            else:
                kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                               [-w[1], w[0], 0]]) / th
                R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
            Xc = w3 @ R.T + t
            xn = Xc[:, :2] / Xc[:, 2:]
            r2 = (xn ** 2).sum(1)
            d = 1 + k1 * r2 + k2 * r2 * r2
            xd = xn * d[:, None]
            out[v, :, 0] = fx * xd[:, 0] + sk * xd[:, 1] + cx
            out[v, :, 1] = fy * xd[:, 1] + cy
        return (out - obs).ravel()

    lam = 1e-3
    r = residual(p)
    c0 = r @ r
    np_ = len(p)
    for _ in range(iterations):
        J = np.empty((len(r), np_))
        for i in range(np_):
            dp = np.zeros(np_)
            dp[i] = 1e-6 * max(1.0, abs(p[i]))
            J[:, i] = (residual(p + dp) - r) / dp[i]
        Hm = J.T @ J
        g = J.T @ r
        try:
            step = np.linalg.solve(Hm + lam * np.eye(np_), -g)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        step[2] = 0.0                       # zero skew
        p_new = p + step
        r_new = residual(p_new)
        c1 = r_new @ r_new
        if np.isfinite(c1) and c1 < c0:
            p, r, c0 = p_new, r_new, c1
            lam = max(lam * 0.3, 1e-10)
        else:
            lam = min(lam * 10, 1e6)
    rmse = np.sqrt(c0 / (V * N))
    return p, rmse


def bench_zhang99():
    from boofcv_tpu.calib import zhang99

    world, obs, K_gt, _ = _zhang_scene()

    t0 = time.perf_counter()
    res = zhang99.calibrate_mono_planar(world, obs, iterations=20)
    _log(f"# zhang99 compile+solve: {time.perf_counter()-t0:.1f}s")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = zhang99.calibrate_mono_planar(world, obs, iterations=20)
    ms = (time.perf_counter() - t0) / reps * 1000.0
    _log(f"# zhang99 device: {ms:.1f} ms (fx err "
         f"{abs(res.K[0, 0] - K_gt[0, 0]):.2f}, rmse {res.reprojection_rmse:.3f})")

    cpu, (p, rmse) = _time_cpu(lambda: _np_zhang99(world, obs,
                                                   iterations=20))
    _log(f"# zhang99 numpy baseline: {cpu:.1f} ms (fx err "
         f"{abs(p[0] - K_gt[0, 0]):.2f}, rmse {rmse:.3f})")
    emit({
        "metric": "zhang99_mono_solve_ms_12views_48pts",
        "value": round(ms, 2), "unit": "ms",
        "vs_baseline": round(cpu / ms, 2)})


def _np_horn_schunck(i1, i2, alpha=20.0, iterations=200):
    """Vectorized numpy single-level Horn-Schunck, same stencils as
    feature.flow.horn_schunck (Jacobi iterations over the whole field)."""
    i1 = i1.astype(np.float64)
    i2 = i2.astype(np.float64)
    # HS gradients (average of the two frames, forward differences)
    def gx(f):
        return np.pad(f[:, 1:] - f[:, :-1], ((0, 0), (0, 1)), "edge")

    def gy(f):
        return np.pad(f[1:] - f[:-1], ((0, 1), (0, 0)), "edge")

    dx = 0.5 * (gx(i1) + gx(i2))
    dy = 0.5 * (gy(i1) + gy(i2))
    dt = i2 - i1
    a2 = alpha * alpha
    u = np.zeros_like(i1)
    v = np.zeros_like(i1)

    def lap_avg(f):
        p = np.pad(f, 1, "edge")
        return (p[1:-1, :-2] + p[1:-1, 2:] + p[:-2, 1:-1]
                + p[2:, 1:-1]) / 6.0 + (p[:-2, :-2] + p[:-2, 2:]
                                        + p[2:, :-2] + p[2:, 2:]) / 12.0

    for _ in range(iterations):
        ub = lap_avg(u)
        vb = lap_avg(v)
        num = dx * ub + dy * vb + dt
        den = a2 + dx * dx + dy * dy
        u = ub - dx * num / den
        v = vb - dy * num / den
    return u, v


def bench_flow():
    from boofcv_tpu.feature import flow

    rng = np.random.default_rng(0)
    from scipy import ndimage as ndi
    base = ndi.gaussian_filter(rng.normal(0, 1, (H + 8, W + 8)), 2.5)
    base = (120 + 60 * base / base.std()).astype(np.float32)
    pairs = []
    for s in range(3):
        dy, dx = 1.5 + 0.2 * s, 2.0 + 0.3 * s
        i1 = base[4:4 + H, 4:4 + W]
        i2 = ndi.shift(base, (dy, dx), order=1)[4:4 + H, 4:4 + W]
        pairs.append((i1.copy(), i2.astype(np.float32), (dx, dy)))
    inputs = [(jnp.asarray(a), jnp.asarray(b)) for a, b, _ in pairs]

    f = jax.jit(lambda a, b: jnp.stack(flow.horn_schunck(
        a, b, alpha=20.0, iterations=200)))
    ms = _time_device(f, inputs)
    uv = np.asarray(f(*inputs[0]))
    dxe, dye = pairs[0][2]
    c = np.s_[40:-40, 40:-40]
    err = np.hypot(uv[0][c] - dxe, uv[1][c] - dye).mean()
    _log(f"# HS-flow device: {ms:.1f} ms (mean endpoint err {err:.2f} px"
         f" at ({dxe}, {dye}))")

    cpu, (un, vn) = _time_cpu(lambda: _np_horn_schunck(*pairs[0][:2]))
    errn = np.hypot(un[c] - dxe, vn[c] - dye).mean()
    _log(f"# HS-flow numpy baseline: {cpu:.1f} ms (mean endpoint err "
         f"{errn:.2f} px)")
    # 200 Jacobi iterations x ~22 flops/px (8-tap laplacian avg + update)
    _roofline("HS-flow", ms, 200.0 * H * W * 22,
              200.0 * H * W * 4 * 4.0)
    emit({
        "metric": "hs_flow_ms_640x480_200it",
        "value": round(ms, 2), "unit": "ms",
        "vs_baseline": round(cpu / ms, 2)})


def _np_canny(img, low, high, radius=2):
    """Vectorized numpy Canny, same spec as feature.canny: Gaussian blur,
    Sobel, 4-sector direction-discretized NMS via shifted comparisons,
    hysteresis as scipy label + component membership (the strongest
    practical CPU formulation — the reference's flood trace is scalar,
    HysteresisEdgeTraceMark.java:37)."""
    from scipy import ndimage as ndi

    sigma = (2 * radius + 1) / 6.0          # FactoryKernelGaussian rule
    b = ndi.gaussian_filter(img.astype(np.float64), sigma, radius=radius,
                            mode="nearest")
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64) * 0.25
    dx = ndi.convolve(b, kx[::-1, ::-1], mode="nearest")
    dy = ndi.convolve(b, kx.T[::-1, ::-1], mode="nearest")
    inten = np.hypot(dx, dy)
    theta = np.arctan2(dy, dx)
    theta = np.where(theta < 0, theta + np.pi, theta)
    sector = (np.floor((theta + np.pi / 8) / (np.pi / 4)).astype(int)) % 4

    def shift(a, dyy, dxx):
        out = np.zeros_like(a)
        ys = slice(max(dyy, 0), a.shape[0] + min(dyy, 0))
        xs = slice(max(dxx, 0), a.shape[1] + min(dxx, 0))
        ys2 = slice(max(-dyy, 0), a.shape[0] + min(-dyy, 0))
        xs2 = slice(max(-dxx, 0), a.shape[1] + min(-dxx, 0))
        out[ys2, xs2] = a[ys, xs]
        return out

    pairs = [((0, -1), (0, 1)), ((-1, -1), (1, 1)),
             ((-1, 0), (1, 0)), ((-1, 1), (1, -1))]
    keep = np.zeros(img.shape, bool)
    for s, (a, c) in enumerate(pairs):
        ok = (inten > shift(inten, *a)) & (inten >= shift(inten, *c))
        keep |= (sector == s) & ok
    nms = np.where(keep, inten, 0.0)
    weak = nms >= low
    strong = nms >= high
    lab, nlab = ndi.label(weak, structure=np.ones((3, 3), bool))
    good = np.zeros(nlab + 1, bool)
    good[np.unique(lab[strong])] = True
    good[0] = False
    return good[lab]


def bench_canny():
    from boofcv_tpu.feature import canny as cn

    from scipy import ndimage as ndi
    rng = np.random.default_rng(0)
    base = ndi.gaussian_filter(rng.normal(0, 1, (H, W)), 3.0)
    imgs = [(120 + 60 * ndi.shift(base, (0, 3 * s), order=1)
             / base.std()).astype(np.float32) for s in range(3)]
    inputs = [(jnp.asarray(im),) for im in imgs]
    low, high = 2.0, 8.0

    f = jax.jit(lambda im: cn.canny(im, low, high))
    ms = _time_device(f, inputs)
    mask_dev = np.asarray(f(*inputs[0])) > 0
    _log(f"# canny device: {ms:.1f} ms ({int(mask_dev.sum())} edge px)")

    cpu, mask_np = _time_cpu(lambda: _np_canny(imgs[0], low, high))
    inter = (mask_dev & mask_np).sum()
    union = (mask_dev | mask_np).sum()
    _log(f"# canny numpy baseline: {cpu:.1f} ms ({int(mask_np.sum())} px, "
         f"IoU {inter / max(union, 1):.2f})")
    # blur 20/px + sobel 12/px + nms ~10/px + ~24 hysteresis sweeps
    _roofline("canny", ms, H * W * (20 + 12 + 10 + 24 * 10.0),
              H * W * 4 * 30.0)
    emit({
        "metric": "canny_ms_640x480",
        "value": round(ms, 2), "unit": "ms",
        "vs_baseline": round(cpu / ms, 2)})

    # host-side chain finisher (HysteresisEdgeTracePoints analog) on the
    # dense mask — vectorized walker, reported for reference
    t0 = time.perf_counter()
    chains = cn.edge_contours(mask_dev)
    tr = (time.perf_counter() - t0) * 1000.0
    _log(f"# canny chain finisher: {tr:.1f} ms for "
         f"{int(mask_dev.sum())} px -> {len(chains)} chains")


def run_all():
    require_gpu()
    bench_disparity()
    bench_surf()
    bench_associate()
    bench_flow()
    bench_canny()
    bench_zhang99()


if __name__ == "__main__":
    run_all()
