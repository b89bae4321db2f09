"""Benchmark: stereo visual odometry throughput (frames/s per device).

The reference workload is BoofCV's stereo-VO example configuration
(examples/sfm/ExampleVisualOdometryStereo.java:66-81 — ~600 features,
4-level pyramid, r=3 templates, wide disparity search, RANSAC 200+):
the per-frame step here runs pyramids + batched pyramidal KLT + sparse
stereo BM + hypothesis-parallel RANSAC-P3P + refine as one jitted program.

BoofCV publishes no numbers (BASELINE.md), so ``vs_baseline`` is
measured device fps / measured CPU fps of ``bench_vo_baseline`` — a
vectorized-numpy implementation of the SAME per-frame spec (pyramidal
inverse-compositional KLT + Shi-Tomasi spawn + sparse SAD stereo +
P3P-Grunert RANSAC + GN refine) run on the SAME synthetic sequence on
this host (the numpy VO recovers the ground-truth trajectory to ~2 mm
on this sequence, so it is a functioning odometer, not a strawman).

Needs a GPU; exits non-zero without one.  Prints one JSON line per
metric: {"metric", "value", "unit", "vs_baseline", "device"}, with the
primary metric last.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp


def vo_sequence(height=480, width=640, n_frames=41, seed=0):
    """Seeded synthetic stereo sequence: continuous forward motion with a
    slow yaw over a textured plane (wrap-around jumps would break
    tracking and exercise the spawn path instead of steady-state VO).

    Returns (K, baseline, frames [(left, right) numpy], poses
    [(R, t) numpy world->camera]).  Frame 0's pose is the identity, so
    VO's world frame is the ground truth's.
    """
    from boofcv_tpu.io import simulate

    f = float(height)
    K = np.array([[f, 0.0, width / 2], [0.0, f, height / 2],
                  [0.0, 0.0, 1.0]])
    baseline = 0.4
    poses = []
    for i in range(n_frames):
        a = 0.002 * i
        R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                      [-np.sin(a), 0.0, np.cos(a)]])
        c = np.array([0.01 * i, 0.0, 0.05 * i])
        poses.append((R, -R @ c))
    frames = simulate.render_stereo_sequence(
        np.random.default_rng(seed), K, baseline,
        [(jnp.asarray(R), jnp.asarray(t)) for R, t in poses],
        height, width, plane_origin=(0.0, 0.0, 8.0), texture_scale=55.0)
    frames = [(np.asarray(l), np.asarray(r)) for l, r in frames]
    return K, baseline, frames, poses


def ate(Rs, ts, poses):
    """Absolute trajectory error: RMS camera-center distance between
    estimated world->camera poses (Rs [N,3,3], ts [N,3]) and ground
    truth ``poses`` (same frames, same world frame)."""
    Rs = np.asarray(Rs, np.float64)
    ts = np.asarray(ts, np.float64)
    c_est = -np.einsum("nji,nj->ni", Rs, ts)
    c_gt = np.stack([-R.T @ t for R, t in poses])
    return float(np.sqrt(np.mean(np.sum((c_est - c_gt) ** 2, axis=1))))


def main():
    from boofcv_tpu.sfm import stereo_vo
    import bench_breadth

    bench_breadth.require_gpu()
    H, W = 480, 640
    n_frames = 41
    K, baseline, frames, _ = vo_sequence(H, W, n_frames)
    cfg = stereo_vo.StereoVoConfig()
    step = stereo_vo.make_step(cfg, K, baseline)

    import sys
    t0 = time.perf_counter()
    state = stereo_vo.init_state(cfg, H, W)
    boot = stereo_vo.make_bootstrap(cfg, K, baseline)
    state = boot(state, jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
    jax.block_until_ready(state)
    print(f"# bootstrap compile+run: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr, flush=True)

    # throughput path: lax.scan sequence runner, one dispatch per batch
    reps = n_frames - 1
    seq = frames[1:]
    lefts = jnp.stack([jnp.asarray(l) for l, _ in seq])
    rights = jnp.stack([jnp.asarray(r) for _, r in seq])
    run = stereo_vo.make_sequence_runner(cfg, K, baseline)

    t0 = time.perf_counter()
    jax.block_until_ready(run(state, lefts, rights))
    print(f"# sequence-runner compile+run: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    jax.block_until_ready(run(state, lefts, rights))
    dt = time.perf_counter() - t0
    fps = reps / dt

    # analytic per-frame work (ExampleVisualOdometryStereo shape):
    # batched KLT 4 levels x 8 GN iters x 512 tracks x 49-px windows x
    # ~30 flops (~24 M) + RANSAC-P3P scoring 1024x512x20 (~10 M) +
    # pyramids/detection (~8 M) ~= 45 MFLOP/frame
    bench_breadth._roofline("stereo-VO/frame", 1000.0 / fps, 45e6,
                            640 * 480 * 4 * 8.0)

    # reference point: single-frame-per-dispatch latency
    jax.block_until_ready(step(state, lefts[0], rights[0]))
    t0 = time.perf_counter()
    s1 = state
    lat_reps = 10
    for i in range(lat_reps):
        s1, m = step(s1, lefts[i % reps], rights[i % reps])
    jax.block_until_ready(m)
    lat_fps = lat_reps / (time.perf_counter() - t0)
    print(f"# per-dispatch (latency-bound) path: {lat_fps:.1f} fps",
          file=sys.stderr, flush=True)

    # measured CPU baseline: the numpy VO on the same frames
    import bench_vo_baseline
    cpu_fps, diag = bench_vo_baseline.measure_np_vo_fps(
        frames, K, baseline, max_frames=20,
        log=lambda m: print(m, file=sys.stderr, flush=True))

    bench_window_ba()

    # breadth surface: disparity BM/SGM, SURF, association, Zhang99 —
    # each with a measured vectorized-numpy CPU baseline
    bench_breadth.run_all()

    # batch-parallel VO: vmapping B streams into one program, plus a
    # 1280x720 single-stream row
    bench_batched_vo(frames, cfg, K, baseline, cpu_fps)

    # primary metric LAST
    bench_breadth.emit({
        "metric": "stereo_vo_frames_per_s_per_chip_640x480",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / cpu_fps, 2),
    })


def bench_batched_vo(frames, cfg, K, baseline, cpu_fps):
    """Aggregate frames/s vs stream count B (shared-frame replay: one
    device copy of the sequence, B-fold compute), and a 1280x720
    single-stream row.  vs_baseline = aggregate device fps / measured
    single-stream CPU fps (``cpu_fps`` from bench_vo_baseline).  The 720p
    row gets its own measured 720p CPU baseline."""
    import sys
    from boofcv_tpu.sfm import stereo_vo
    import bench_breadth

    H, W = frames[0][0].shape
    T = 12
    lefts = jnp.stack([jnp.asarray(l) for l, _ in frames[1:1 + T]])
    rights = jnp.stack([jnp.asarray(r) for _, r in frames[1:1 + T]])
    agg_fps = {}
    for B in (4, 8, 16):
        states = stereo_vo.init_batched_state(cfg, B, H, W)
        bboot = stereo_vo.make_batched_bootstrap(cfg, K, baseline)
        l0 = jnp.broadcast_to(jnp.asarray(frames[0][0]), (B, H, W))
        r0 = jnp.broadcast_to(jnp.asarray(frames[0][1]), (B, H, W))
        states = bboot(states, l0, r0)
        run = stereo_vo.make_batched_sequence_runner(cfg, K, baseline,
                                                     shared_frames=True)
        t0 = time.perf_counter()
        jax.block_until_ready(run(states, lefts, rights))
        print(f"# batched-VO B={B} compile+run: "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            jax.block_until_ready(run(states, lefts, rights))
        dt = (time.perf_counter() - t0) / reps
        agg_fps[B] = T * B / dt
        print(f"# batched-VO B={B}: {agg_fps[B]:.1f} frames/s aggregate "
              f"({agg_fps[B] / B:.1f}/stream)", file=sys.stderr, flush=True)
    for B in (8, 16):
        bench_breadth.emit({
            "metric": f"stereo_vo_agg_frames_per_s_per_chip_640x480_{B}stream",
            "value": round(agg_fps[B], 2), "unit": "frames/s",
            "vs_baseline": round(agg_fps[B] / cpu_fps, 2)})

    # 1280x720 single stream
    H2, W2 = 720, 1280
    K2, baseline2, f2, _ = vo_sequence(H2, W2, T + 1, seed=3)
    state = stereo_vo.init_state(cfg, H2, W2)
    boot = stereo_vo.make_bootstrap(cfg, K2, baseline2)
    state = boot(state, jnp.asarray(f2[0][0]), jnp.asarray(f2[0][1]))
    run = stereo_vo.make_sequence_runner(cfg, K2, baseline2)
    l2 = jnp.stack([jnp.asarray(l) for l, _ in f2[1:]])
    r2 = jnp.stack([jnp.asarray(r) for _, r in f2[1:]])
    t0 = time.perf_counter()
    jax.block_until_ready(run(state, l2, r2))
    print(f"# 720p-VO compile+run: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        jax.block_until_ready(run(state, l2, r2))
    fps = T * reps / (time.perf_counter() - t0)
    print(f"# 720p-VO single stream: {fps:.1f} frames/s", file=sys.stderr,
          flush=True)
    import bench_vo_baseline
    cpu720, _ = bench_vo_baseline.measure_np_vo_fps(
        f2, K2, baseline2, max_frames=8,
        log=lambda m: print(m + " (720p)", file=sys.stderr, flush=True))
    bench_breadth.emit({
        "metric": "stereo_vo_frames_per_s_per_chip_1280x720",
        "value": round(fps, 2), "unit": "frames/s",
        "vs_baseline": round(fps / cpu720, 2)})


def _window_ba_scene(V=100, P=2000, L=10, seed=7):
    """V keyframes / P points / L consecutive obs per point (default: the
    100 / 2000 / 10 window), seeded, in numpy.  The camera path spans the
    same 12 m forward, 2 m sideways and 0.2 rad of yaw for every V.
    Returns (Rs, ts, pts) perturbed from the truth, the observations and
    the fixed-view mask."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-3, 3, P),
                    rng.uniform(4, 30, P)], 1)
    k = np.arange(V) * (100.0 / V)
    ang = 0.002 * k
    ca, sa = np.cos(ang), np.sin(ang)
    Rs = np.zeros((V, 3, 3))
    Rs[:, 0, 0], Rs[:, 0, 2] = ca, sa          # rotation about +y
    Rs[:, 1, 1] = 1.0
    Rs[:, 2, 0], Rs[:, 2, 2] = -sa, ca
    cs = np.stack([0.02 * k, np.zeros(V), 0.12 * k], 1)
    ts = -np.einsum("vij,vj->vi", Rs, cs)
    first = rng.integers(0, V - L, P)
    views = first[:, None] + np.arange(L)[None, :]          # [P, L]
    pc = np.einsum("plij,pj->pli", Rs[views], pts) + ts[views]
    obs_valid = pc[..., 2] >= 0.5
    z = np.where(np.abs(pc[..., 2]) < 1e-12, 1e-12, pc[..., 2])
    obs_xy = pc[..., :2] / z[..., None] + rng.normal(0, 5e-4, (P, L, 2))
    obs_xy[~obs_valid] = 0.0
    obs_view = np.where(obs_valid, views, 0).astype(np.int32)
    # perturb the initial guess (BA has real work to do)
    Rs_n = Rs.copy()
    ts_n = ts + rng.normal(0, 0.01, ts.shape)
    pts_n = pts + rng.normal(0, 0.05, pts.shape)
    fixed = np.zeros(V, bool)
    fixed[:2] = True
    return Rs_n, ts_n, pts_n, obs_xy, obs_view, obs_valid, fixed


def _np_lm_schur_baseline(Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed,
                          iters=10):
    """CPU sparse-Schur LM baseline (vectorized numpy + scipy Cholesky,
    f64) — the documented stand-in for the reference's ddogleg
    ``UnconstrainedLeastSquaresSchur`` (BundleAdjustmentSchur.java:87; no
    JDK ships in this image, so BoofCV itself cannot be run).  Same
    algorithm class: analytic jacobians, per-point 3x3 block elimination,
    reduced camera system, damped Cholesky, accept/reject.  Vectorized
    numpy + MKL-class BLAS is, if anything, generous to the CPU side.
    Returns (seconds per 10-iteration solve, final cost).
    """
    import scipy.linalg as sla

    V = len(Rs)
    P, L = obs_view.shape
    D = 6
    R, t, X = Rs.copy(), ts.copy(), pts.copy()
    lam = 1e-3
    vmask = obs_valid

    def hat(w):
        z = np.zeros_like(w[..., 0])
        return np.stack([
            np.stack([z, -w[..., 2], w[..., 1]], -1),
            np.stack([w[..., 2], z, -w[..., 0]], -1),
            np.stack([-w[..., 1], w[..., 0], z], -1)], -2)

    def exp_so3(w):
        th = np.linalg.norm(w, axis=-1, keepdims=True)
        th = np.maximum(th, 1e-12)
        K = hat(w / th)
        s, c = np.sin(th)[..., None], np.cos(th)[..., None]
        return np.eye(3) + s * K + (1 - c) * (K @ K)

    def cost_of(R, t, X):
        Xc = np.einsum("plij,pj->pli", R[obs_view], X) + t[obs_view]
        z = np.where(np.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        r = Xc[..., :2] / z[..., None] - obs_xy
        r[~vmask] = 0.0
        return 0.5 * np.sum(r * r)

    c0 = cost_of(R, t, X)
    t_start = time.perf_counter()
    for _ in range(iters):
        R_o, t_o = R[obs_view], t[obs_view]
        Xc = np.einsum("plij,pj->pli", R_o, X) + t_o
        z = np.where(np.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        iz = 1.0 / z
        xx, yy = Xc[..., 0], Xc[..., 1]
        zero = np.zeros_like(iz)
        A = np.stack([np.stack([iz, zero, -xx * iz * iz], -1),
                      np.stack([zero, iz, -yy * iz * iz], -1)], -2)
        r = Xc[..., :2] * iz[..., None] - obs_xy
        Jv = np.concatenate([-(A @ hat(Xc)), A], -1)       # [P,L,2,6]
        Jp = A @ R_o                                        # [P,L,2,3]
        Jv[~vmask] = 0.0
        Jp[~vmask] = 0.0
        r[~vmask] = 0.0
        Hpp = np.einsum("plki,plkj->pij", Jp, Jp) \
            + (lam + 1e-12) * np.eye(3)
        W = np.einsum("plki,plkj->plij", Jp, Jv)
        gp = -np.einsum("plki,plk->pi", Jp, r)
        gv_obs = -np.einsum("plki,plk->pli", Jv, r)
        Hpp_inv = np.linalg.inv(Hpp)
        Hvv_obs = np.einsum("plki,plkj->plij", Jv, Jv)
        flat = obs_view.reshape(-1)
        Hvv = np.zeros((V, D, D))
        np.add.at(Hvv, flat, Hvv_obs.reshape(-1, D, D))
        gv = np.zeros((V, D))
        np.add.at(gv, flat, gv_obs.reshape(-1, D))
        Y = np.einsum("pij,pljk->plik", Hpp_inv, W)
        pair = np.einsum("plik,pmij->plmkj", W, Y)
        vi = np.broadcast_to(obs_view[:, :, None], (P, L, L)).reshape(-1)
        vj = np.broadcast_to(obs_view[:, None, :], (P, L, L)).reshape(-1)
        S = np.zeros((V * V, D, D))
        np.add.at(S, vi * V + vj, pair.reshape(-1, D, D))
        S = -S.reshape(V, V, D, D)
        S[np.arange(V), np.arange(V)] += Hvv \
            + lam * np.eye(D)
        hp = np.einsum("pij,pj->pi", Hpp_inv, gp)
        corr = np.einsum("plij,pi->plj", W, hp)
        gv_t = gv.copy()
        np.subtract.at(gv_t, flat, corr.reshape(-1, D))
        # gauge fix
        free = np.repeat(~fixed, D).astype(float)
        Sd = S.transpose(0, 2, 1, 3).reshape(V * D, V * D)
        Sd = Sd * free[:, None] * free[None, :]
        Sd[np.diag_indices(V * D)] += 1.0 - free
        gd = gv_t.reshape(-1) * free
        cf = sla.cho_factor(Sd)
        dv = sla.cho_solve(cf, gd).reshape(V, D) * free.reshape(V, D)
        dp = np.einsum("pij,pj->pi", Hpp_inv,
                       gp - np.einsum("plij,plj->pi", W, dv[obs_view]))
        dR = exp_so3(dv[:, :3])
        Rn = dR @ R
        tn = np.einsum("vij,vj->vi", dR, t) + dv[:, 3:]
        Xn = X + dp
        c1 = cost_of(Rn, tn, Xn)
        if np.isfinite(c1) and c1 < c0:
            R, t, X, c0 = Rn, tn, Xn, c1
            lam = max(lam * 0.3, 1e-12)
        else:
            lam = min(lam * 10.0, 1e8)
    return time.perf_counter() - t_start, c0


def bench_window_ba():
    """BASELINE.md north-star metric: BA solve ms per 100-keyframe window.

    Synthetic forward-motion scene (100 kf / 2000 pts / 10 obs each) — the
    f32 LM-Schur solve (boofcv_tpu.geo.ba, 10 iterations) timed
    steady-state on device, vs the numpy/scipy CPU Schur baseline
    (``_np_lm_schur_baseline``).
    """
    import sys
    from boofcv_tpu.geo import ba
    import bench_breadth

    Rs_n, ts_n, pts_n, obs_xy, obs_view, obs_valid, fixed = _window_ba_scene()
    prob = ba.make_problem(Rs_n, ts_n, pts_n, obs_xy, obs_view, obs_valid,
                           fixed_views=fixed, dtype=jnp.float32)
    t0 = time.perf_counter()
    out, info = jax.block_until_ready(ba.optimize(prob, iterations=10))
    print(f"# window-BA compile+solve: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out, info = jax.block_until_ready(ba.optimize(prob, iterations=10))
    ms = (time.perf_counter() - t0) / reps * 1000.0
    # analytic work/iter at P=2000, V=100, L=10, D=6: the Schur-fill
    # one-hot einsum 'pvik,pwij->vwkj' dominates (P*V^2*3*D^2*2 =
    # 4.3 GFLOP) + gather-as-matmul factors (0.14 G) + jacobians +
    # [VD,VD] Cholesky (~0.07 G) ~= 4.5 GFLOP x 10 LM iterations
    bench_breadth._roofline("window-BA", ms, 45e9, 10 * 2000 * 10 * 200.0)
    print(f"# window-BA final reproj RMS (normalized coords): "
          f"{reprojection_rms(out, obs_valid):.2e}", file=sys.stderr,
          flush=True)

    # best-of-2 (allocation-heavy numpy baselines swing run-to-run —
    # bench_breadth._time_cpu rationale).  The baseline times its own
    # solve loop, so take the min of its reported seconds.
    runs = [_np_lm_schur_baseline(
        Rs_n, ts_n, pts_n, obs_xy, obs_view, obs_valid, fixed)
        for _ in range(2)]
    cpu_s, cpu_cost = min(runs, key=lambda r: r[0])
    print(f"# window-BA CPU scipy-Schur baseline: {cpu_s*1000:.1f} ms "
          f"(final cost {cpu_cost:.3e} vs device "
          f"{float(info['final_cost']):.3e})", file=sys.stderr, flush=True)
    bench_breadth.emit({
        "metric": "window_ba_solve_ms_100kf_2000pt_10it",
        "value": round(ms, 1),
        "unit": "ms",
        "vs_baseline": round(cpu_s * 1000.0 / ms, 2),
    })


def reprojection_rms(prob, obs_valid):
    """RMS reprojection error (normalized coords) over valid observations."""
    from boofcv_tpu.geo import ba
    r = np.asarray(ba.residuals(prob))
    return float(np.sqrt((np.linalg.norm(r, axis=-1)[obs_valid] ** 2).mean()))


if __name__ == "__main__":
    main()
