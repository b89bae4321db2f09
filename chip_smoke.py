"""Smoke run of the main path on the GPU, with an accuracy oracle per phase.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded solvers only

One GPU, one process:
  1. stereo VO at 640x480, 40 frames (bootstrap + sequence runner, and a
     few frames through StereoVisualOdometry.process): ATE vs ground truth;
  2. stereo VO at 1280x720 (12 frames) and 8 batched 640x480 streams: ATE;
  3. window BA, 100 keyframes / 2000 points / 10 obs: f32 reprojection RMS
     at the injected-noise floor, f64 final cost vs the numpy LM-Schur
     reference;
  4. dense BM and SGM at 640x480, 96 disparities: error vs ground truth;
  5. window gather at the VO shapes: exact vs a NumPy copy;
  6. numerics: pyramid, gradients, Shi-Tomasi, KLT tracks and sparse SAD
     costs on the GPU vs the same program on the CPU.
``--multi``: sharded BA (Cholesky and PCG reduced solvers) and sharded
RANSAC on a 1-D 4-device mesh vs the single-device solvers.

Every phase prints its oracle beside its bound, its compile seconds
(set-up: first call minus a steady second call) and the device's peak
memory.  Exits non-zero when JAX finds no GPU or any phase fails; the
last line of a passing run is the JSON device record.  The phase
functions take their sizes as arguments so tests rehearse them on the
CPU at tiny sizes; only ``main`` insists on a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Bounds from the CPU run of the same phases (scripts/cpu_reference.py on
# the H100 host's CPU; figures in PERF.md).  ATE: twice the CPU's ATE
# plus 1 mm, since f32 reduction order differs between backends and
# RANSAC's inlier sets see the differences.
ATE_BOUND_640 = 2 * 0.003779 + 0.001
ATE_BOUND_720 = 2 * 0.001491 + 0.001
ATE_BOUND_BATCHED = 2 * 0.002369 + 0.001
# f32 window BA reaches the injected 5e-4 observation noise: RMS ~6.5e-4
BA_RMS_BOUND = 7.0e-4
# f64 final cost vs the numpy LM-Schur reference on the same scene: both
# are LM-Schur in f64, but the package damps Jacobi-scaled normal
# equations and the reference damps plain ones, so after 10 iterations
# they stop near the same minimum, not on it (0.04-0.15% apart for 12 to
# 50 views on the CPU)
BA_COST_RTOL = 5e-3
# dense stereo: (max median |d - gt| px, min valid fraction): twice the
# CPU's median error plus 0.05 px, and the CPU's valid share less 0.02
BM_BOUND = (2 * 0.0684 + 0.05, 0.927 - 0.02)
SGM_BOUND = (2 * 0.1179 + 0.05, 0.931 - 0.02)
# sharded vs single-device: Cholesky is the same solve up to reduction
# order; PCG stops after a fixed number of CG iterations
MULTI_CHOLESKY_RTOL = 1e-6
MULTI_PCG_RTOL = 1e-2


def _peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _twice(fn):
    """Run ``fn`` twice; return (set-up seconds, second result).  Set-up
    is the first call's wall time minus the steady second call's."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    return max((t1 - t0) - (t2 - t1), 0.0), out


def _rel(a, b):
    """max |a - b| over max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# phases: each returns a dict with "ok", "setup_s" and its oracle values
# ---------------------------------------------------------------------------

def phase_vo(height, width, n_frames, cfg, ate_bound, seed=0,
             process_frames=4):
    """Bootstrap + sequence runner over a rendered sequence, plus the first
    ``process_frames`` frames through the CLI's per-frame driver."""
    import jax.numpy as jnp
    import bench
    from boofcv_tpu.sfm import stereo_vo

    K, baseline, frames, poses = bench.vo_sequence(height, width, n_frames,
                                                   seed)
    lefts = jnp.stack([jnp.asarray(l) for l, _ in frames[1:]])
    rights = jnp.stack([jnp.asarray(r) for _, r in frames[1:]])
    boot = stereo_vo.make_bootstrap(cfg, K, baseline)
    run = stereo_vo.make_sequence_runner(cfg, K, baseline)

    def once():
        state = boot(stereo_vo.init_state(cfg, height, width),
                     jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]))
        return run(state, lefts, rights)

    setup_s, (_, ((Rs, ts), ms)) = _twice(once)
    ate = bench.ate(Rs, ts, poses[1:])

    vo = stereo_vo.StereoVisualOdometry(cfg, K, baseline, height, width)
    Rp, tp, oks = [], [], []
    for left, right in frames[:process_frames]:
        oks.append(vo.process(left, right))
        Rp.append(np.asarray(vo.state.R))
        tp.append(np.asarray(vo.state.t))
    ate_cli = bench.ate(Rp, tp, poses[:process_frames])
    finite = bool(np.all(np.isfinite(np.asarray(Rs)))
                  and np.all(np.isfinite(np.asarray(ts))))
    return {"ok": finite and all(oks) and ate <= ate_bound
            and ate_cli <= ate_bound,
            "ate_m": ate, "ate_process_m": ate_cli, "bound_m": ate_bound,
            "pose_ok_frames": int(np.sum(np.asarray(ms["pose_ok"]))),
            "frames": len(frames) - 1, "setup_s": setup_s}


def phase_vo_batched(height, width, n_frames, streams, cfg, ate_bound,
                     seed=0):
    """``streams`` VO streams in one program (shared-frame replay, distinct
    RANSAC keys); the worst stream's ATE is the oracle."""
    import jax.numpy as jnp
    import bench
    from boofcv_tpu.sfm import stereo_vo

    K, baseline, frames, poses = bench.vo_sequence(height, width, n_frames,
                                                   seed)
    lefts = jnp.stack([jnp.asarray(l) for l, _ in frames[1:]])
    rights = jnp.stack([jnp.asarray(r) for _, r in frames[1:]])
    shape = (streams, height, width)
    boot = stereo_vo.make_batched_bootstrap(cfg, K, baseline)
    run = stereo_vo.make_batched_sequence_runner(cfg, K, baseline,
                                                 shared_frames=True)

    def once():
        states = boot(stereo_vo.init_batched_state(cfg, streams, height,
                                                   width),
                      jnp.broadcast_to(jnp.asarray(frames[0][0]), shape),
                      jnp.broadcast_to(jnp.asarray(frames[0][1]), shape))
        return run(states, lefts, rights)

    setup_s, (_, ((Rs, ts), _)) = _twice(once)
    Rs, ts = np.asarray(Rs), np.asarray(ts)
    ates = [bench.ate(Rs[:, b], ts[:, b], poses[1:]) for b in range(streams)]
    return {"ok": bool(np.all(np.isfinite(Rs))) and max(ates) <= ate_bound,
            "ate_max_m": max(ates), "bound_m": ate_bound,
            "streams": streams, "setup_s": setup_s}


def phase_window_ba(views, points, obs_per_point, rms_bound, cost_rtol,
                    iterations=10):
    """f32 LM-Schur window BA to the noise floor; f64 vs numpy reference."""
    import jax.numpy as jnp
    import bench
    from boofcv_tpu.geo import ba

    scene = bench._window_ba_scene(views, points, obs_per_point)
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = scene

    def problem(dtype):
        return ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                               fixed_views=fixed, dtype=dtype)

    prob32 = problem(jnp.float32)
    setup_s, (out32, _) = _twice(lambda: ba.optimize(prob32, iterations))
    rms = bench.reprojection_rms(out32, obs_valid)
    _, info64 = ba.optimize(problem(jnp.float64), iterations)
    cost64 = float(info64["final_cost"])
    _, ref_cost = bench._np_lm_schur_baseline(*scene, iters=iterations)
    rel = abs(cost64 - ref_cost) / ref_cost
    return {"ok": bool(rms <= rms_bound and rel <= cost_rtol),
            "rms_f32": rms, "rms_bound": rms_bound, "cost_f64": cost64,
            "cost_numpy": ref_cost, "cost_rel": rel, "cost_rtol": cost_rtol,
            "setup_s": setup_s}


def phase_dense_stereo(height, width, dmax, bm_bound, sgm_bound):
    """BM and SGM on the slanted-plane pair: median error and valid share."""
    import jax
    import jax.numpy as jnp
    import bench_breadth
    from boofcv_tpu.feature import disparity

    left, right, gt = bench_breadth._scene_pair(0, height, width, dmax)
    left, right = jnp.asarray(left), jnp.asarray(right)
    bm_cfg = disparity.DisparityConfig(max_disparity=dmax, radius_x=3,
                                       radius_y=3, texture_threshold=0.0)
    sgm_cfg = disparity.SgmConfig(max_disparity=dmax, paths=4,
                                  error="census")
    out = {"ok": True, "setup_s": 0.0}
    for name, fn, (err_max, valid_min) in (
            ("bm", jax.jit(lambda a, b: disparity.block_match(a, b, bm_cfg)),
             bm_bound),
            ("sgm", jax.jit(lambda a, b: disparity.sgm(a, b, sgm_cfg)),
             sgm_bound)):
        setup_s, d = _twice(lambda: fn(left, right))
        d = np.asarray(d)
        valid = d > 0
        err = float(np.median(np.abs(d - gt)[valid])) if valid.any() \
            else float("inf")
        out[f"{name}_median_err_px"] = err
        out[f"{name}_valid"] = float(valid.mean())
        out[f"{name}_bound"] = (err_max, valid_min)
        out["ok"] &= bool(err <= err_max and valid.mean() >= valid_min)
        out["setup_s"] += setup_s
    return out


def _np_windows(image, oy, ox, wy, wx):
    """NumPy reference of gather_windows: clamped-coordinate copies."""
    h, w = image.shape
    rows = np.clip(oy[:, None] + np.arange(wy)[None, :], 0, h - 1)
    cols = np.clip(ox[:, None] + np.arange(wx)[None, :], 0, w - 1)
    return image[rows[:, :, None], cols[:, None, :]]


def window_shapes(cfg):
    """(wy, wx, pad) of every window gather the VO step makes: the KLT
    level window and the sparse-SAD patch and strip."""
    from boofcv_tpu.feature import disparity, klt
    r = cfg.disparity_radius
    dcfg = disparity.DisparityConfig(
        min_disparity=cfg.min_disparity, max_disparity=cfg.max_disparity,
        radius_x=r, radius_y=r)
    return (klt.window_shape(cfg.template_radius) + (0,),
            *disparity.sparse_sad_windows(dcfg))


def phase_window_gather(n, height, width, shapes, seed=0):
    """gather_windows vs NumPy at ``n`` origins per shape, the extreme
    corners included; a copy, so the match must be exact."""
    import jax.numpy as jnp
    from boofcv_tpu.ip.interpolate import gather_windows

    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, (height, width)).astype(np.float32)
    worst = 0.0
    setup_s = 0.0
    for wy, wx, pad in shapes:
        hi_y = max(height, wy) + pad - wy
        hi_x = max(width, wx) + pad - wx
        oy = rng.integers(-pad, hi_y + 1, n).astype(np.int32)
        ox = rng.integers(-pad, hi_x + 1, n).astype(np.int32)
        oy[:4] = [-pad, -pad, hi_y, hi_y]
        ox[:4] = [-pad, hi_x, -pad, hi_x]
        s, got = _twice(lambda: gather_windows(
            jnp.asarray(image), jnp.asarray(oy), jnp.asarray(ox), wy, wx,
            pad))
        setup_s += s
        want = _np_windows(image, oy, ox, wy, wx)
        worst = max(worst, float(np.max(np.abs(np.asarray(got) - want))))
    return {"ok": worst == 0.0, "max_abs_diff": worst, "shapes": shapes,
            "setup_s": setup_s}


# GPU vs CPU tolerances of the numerics phase, as max |gpu - cpu| over
# max |cpu|.  In full f32 only the summation order differs (relative
# error ~1e-7 per sum); TF32 operands (10 mantissa bits) would give
# ~5e-4, fifty times the bound.
NUMERICS_RTOL = 1e-5
# KLT: tracks that converge on both devices may stop one Gauss-Newton
# step apart, and a step below convergence_tol (0.01 px) ends the loop
KLT_POS_ATOL = 0.02
KLT_FAULT_AGREE = 0.99


def phase_numerics(height, width, cfg, seed=0):
    """Pyramid, gradients, Shi-Tomasi, KLT tracks and sparse SAD costs at
    the VO's widths on the default device vs the CPU."""
    import jax
    import jax.numpy as jnp
    import bench
    from boofcv_tpu.core.pyramid import PyramidConfig
    from boofcv_tpu.feature import disparity, intensity, klt
    from boofcv_tpu.ip import pyramid_ops
    from boofcv_tpu.sfm import stereo_vo

    K, baseline, frames, _ = bench.vo_sequence(height, width, 2, seed)
    (l0, r0), (l1, _) = frames
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    dcfg = disparity.DisparityConfig(
        min_disparity=cfg.min_disparity, max_disparity=cfg.max_disparity,
        radius_x=cfg.disparity_radius, radius_y=cfg.disparity_radius)

    @jax.jit
    def images(left):
        pyr = pyramid_ops.pyramid_average(left, pyr_cfg)
        dxs, dys = pyramid_ops.gradient(pyr)
        return pyr, dxs, dys, intensity.shi_tomasi(left, radius=2)

    @jax.jit
    def tracks(l0, r0, l1, ys, xs):
        pyr0 = pyramid_ops.pyramid_average(l0, pyr_cfg)
        tmpl = klt.sample_templates(pyr0, pyramid_ops.gradient(pyr0), ys,
                                    xs, cfg.pyramid_scales,
                                    cfg.template_radius)
        pyr1 = pyramid_ops.pyramid_average(l1, pyr_cfg)
        ty, tx, fault = klt.track_pyramid(pyr1, tmpl, ys, xs,
                                          cfg.pyramid_scales, cfg.klt)
        costs = disparity._sparse_costs_sad(
            l0, r0, ys.astype(jnp.int32), xs.astype(jnp.int32), dcfg)
        return ty, tx, fault, costs

    cpu = jax.devices("cpu")[0]
    dev = jax.devices()[0]

    def on(device, fn, *args):
        return jax.tree_util.tree_map(
            np.asarray, fn(*[jax.device_put(a, device) for a in args]))

    setup_s, _ = _twice(lambda: images(jax.device_put(l0, dev)))
    img_d, img_c = on(dev, images, l0), on(cpu, images, l0)
    rel = {"pyramid": max(_rel(a, b) for a, b in zip(img_d[0], img_c[0])),
           "gradients": max(_rel(a, b) for a, b in
                            zip(img_d[1] + img_d[2], img_c[1] + img_c[2])),
           "shi_tomasi": _rel(img_d[3], img_c[3])}

    # identical track positions on both devices: the CPU's detections
    with jax.default_device(cpu):
        det = stereo_vo._detect_candidates(jnp.asarray(l0), cfg,
                                           cfg.num_tracks)
        ys = np.asarray(det.ys, np.float32)
        xs = np.asarray(det.xs, np.float32)
    ty_d, tx_d, f_d, c_d = on(dev, tracks, l0, r0, l1, ys, xs)
    ty_c, tx_c, f_c, c_c = on(cpu, tracks, l0, r0, l1, ys, xs)
    both = (f_d == klt.TRACK_OK) & (f_c == klt.TRACK_OK)
    klt_pos = float(np.max(np.hypot(ty_d - ty_c, tx_d - tx_c)[both])) \
        if both.any() else 0.0
    fault_agree = float(np.mean(f_d == f_c))
    real = c_c < 1e6                      # in-image SAD windows
    rel["sad"] = _rel(c_d[real], c_c[real])
    masked_ok = bool(np.all(c_d[~real] >= 1e6))
    ok = (all(v <= NUMERICS_RTOL for v in rel.values()) and masked_ok
          and klt_pos <= KLT_POS_ATOL and fault_agree >= KLT_FAULT_AGREE)
    return {"ok": ok, **{f"{k}_rel": v for k, v in rel.items()},
            "rtol": NUMERICS_RTOL, "klt_pos_px": klt_pos,
            "klt_pos_atol": KLT_POS_ATOL, "klt_fault_agree": fault_agree,
            "tracks_ok": int(both.sum()), "setup_s": setup_s}


def phase_multi(n_devices, views, points, obs_per_point, iterations,
                pcg_iterations, n_ransac, hyps_per_device, seed=0):
    """Sharded BA (both reduced solvers) and sharded RANSAC on a 1-D
    ``shard`` mesh of ``n_devices`` vs the single-device solvers."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import bench
    from boofcv_tpu.dist import ba_sharded
    from boofcv_tpu.dist.ransac_sharded import ransac_pnp_sharded
    from boofcv_tpu.geo import ba, robust, se3

    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devices), ("shard",))
    Rs, ts, pts, obs_xy, obs_view, obs_valid, fixed = \
        bench._window_ba_scene(views, points, obs_per_point, seed)
    prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                           fixed_views=fixed, dtype=jnp.float64)
    setup_s, (out_c, info_c) = _twice(lambda: ba_sharded.optimize_sharded(
        prob, mesh, iterations, reduced_solver="cholesky"))
    s, (_, info_p) = _twice(lambda: ba_sharded.optimize_sharded(
        prob, mesh, iterations, reduced_solver="pcg",
        pcg_iterations=pcg_iterations))
    setup_s += s
    spread = len(out_c.points.sharding.device_set)
    peaks = [_peak_bytes(d) for d in devices]

    # sharded RANSAC: 30% of the correspondences are outliers
    rng = np.random.default_rng(seed)
    world = np.stack([rng.uniform(-3, 3, n_ransac), rng.uniform(-2, 2, n_ransac),
                      rng.uniform(5, 15, n_ransac)], 1)
    R_gt = np.asarray(se3.exp_so3(jnp.asarray([0.05, -0.1, 0.02])))
    t_gt = np.array([0.2, -0.1, 0.5])
    Xc = world @ R_gt.T + t_gt
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-4, (n_ransac, 2))
    outlier = rng.random(n_ransac) < 0.3
    obs[outlier] = rng.uniform(-0.5, 0.5, (int(outlier.sum()), 2))
    key = jax.random.PRNGKey(seed)
    kw = dict(inlier_threshold=(5e-4) ** 2, refine_iterations=10)
    s, (res_s, (R_s, t_s)) = _twice(lambda: ransac_pnp_sharded(
        mesh, key, jnp.asarray(world), jnp.asarray(obs),
        num_hypotheses_per_device=hyps_per_device, **kw))
    setup_s += s
    res_1, (R_1, t_1) = robust.ransac_pnp(
        key, jnp.asarray(world), jnp.asarray(obs),
        num_hypotheses=hyps_per_device * n_devices, **kw)

    _, info_1 = ba.optimize(prob, iterations)
    c1 = float(info_1["final_cost"])
    chol_rel = abs(float(info_c["final_cost"]) - c1) / c1
    pcg_rel = abs(float(info_p["final_cost"]) - c1) / c1
    n_true = int((~outlier).sum())
    inl_s, inl_1 = int(res_s.num_inliers), int(res_1.num_inliers)
    t_err = max(float(np.linalg.norm(np.asarray(t_s) - t_gt)),
                float(np.linalg.norm(np.asarray(t_1) - t_gt)))
    known = [p for p in peaks if p is not None]
    balanced = not known or min(known) >= 0.5 * max(known)
    ok = (chol_rel <= MULTI_CHOLESKY_RTOL and pcg_rel <= MULTI_PCG_RTOL
          and spread == n_devices and balanced
          and min(inl_s, inl_1) >= 0.95 * n_true
          and abs(inl_s - inl_1) <= 0.01 * n_ransac and t_err <= 1e-2)
    return {"ok": bool(ok), "cost_single": c1,
            "cholesky_rel": chol_rel, "cholesky_rtol": MULTI_CHOLESKY_RTOL,
            "pcg_rel": pcg_rel, "pcg_rtol": MULTI_PCG_RTOL,
            "points_on_devices": spread, "peak_bytes_per_device": peaks,
            "inliers_sharded": inl_s, "inliers_single": inl_1,
            "inliers_true": n_true, "t_err_m": t_err, "setup_s": setup_s}


# ---------------------------------------------------------------------------

def _report(name, result, device):
    print(f"phase {name}: " + json.dumps(
        {**result, "peak_bytes_in_use": _peak_bytes(device)}, default=str),
        flush=True)
    return result["ok"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded solvers, on four GPUs")
    args = ap.parse_args(argv)
    n_devices = 4 if args.multi else 1

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < n_devices:
        print(f"chip_smoke: needs {n_devices} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 2
    devices = devices[:n_devices]
    dev = devices[0]
    print(f"jax: platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)

    from boofcv_tpu.sfm import stereo_vo
    cfg = stereo_vo.StereoVoConfig()
    if args.multi:
        phases = [("multi_sharded_ba_ransac", phase_multi,
                   (n_devices, 200, 40_000, 10, 5, 100, 2048, 256))]
    else:
        phases = [
            ("vo_640x480", phase_vo, (480, 640, 41, cfg, ATE_BOUND_640)),
            ("vo_1280x720", phase_vo,
             (720, 1280, 13, cfg, ATE_BOUND_720, 3)),
            ("vo_640x480_8streams", phase_vo_batched,
             (480, 640, 13, 8, cfg, ATE_BOUND_BATCHED)),
            ("window_ba", phase_window_ba,
             (100, 2000, 10, BA_RMS_BOUND, BA_COST_RTOL)),
            ("dense_stereo", phase_dense_stereo,
             (480, 640, 96, BM_BOUND, SGM_BOUND)),
            ("window_gather", phase_window_gather,
             (512, 480, 640, window_shapes(cfg))),
            ("numerics", phase_numerics, (480, 640, cfg)),
        ]
    failed = [name for name, fn, a in phases
              if not _report(name, fn(*a), dev)]
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
