"""Uncalibrated three-view metric reconstruction.

Reference analog: boofcv-sfm alg/sfm/structure/ThreeViewEstimateMetric
Scene.java:80,157 — associated triples -> robust trifocal tensor ->
projective cameras -> linear dual-quadratic self-calibration -> metric
upgrade -> triangulation -> bundle adjustment.

Design: the trifocal RANSAC is hypothesis-parallel (vmapped 7+-point
linear solves, transfer-error scoring as one [K, N] reduction); the
self-calibration and metric upgrade are tiny host-side dense solves; the
final BA is the library's batched LM-Schur.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.geo import ba, robust, se3, selfcalib, triangulate, trifocal


class ThreeViewResult(NamedTuple):
    K: np.ndarray            # [3, 3] shared intrinsics estimate
    Rs: np.ndarray           # [3, 3, 3] world->view rotations
    ts: np.ndarray           # [3, 3]
    points: np.ndarray       # [N, 3] metric points (inliers only valid)
    inliers: np.ndarray      # [N] bool trifocal inlier mask
    reproj_rmse: float


def cameras_from_trifocal(T):
    """Projective camera pair (P2, P3) with P1 = [I | 0] from the tensor
    (TrifocalExtractGeometries.extractCamera)."""
    e2, e3 = trifocal.extract_epipoles(T)
    # P2 = [ [T1 e3, T2 e3, T3 e3] | e2 ]
    cols2 = jnp.stack([T[k] @ e3 for k in range(3)], axis=1)
    P2 = jnp.concatenate([cols2, e2[:, None]], axis=1)
    M = jnp.outer(e3, e3) - jnp.eye(3, dtype=T.dtype)
    cols3 = jnp.stack([M @ T[k].T @ e2 for k in range(3)], axis=1)
    P3 = jnp.concatenate([cols3, e3[:, None]], axis=1)
    return P2, P3


def ransac_trifocal(key, p1, p2, p3, num_hypotheses: int = 256,
                    inlier_threshold_px: float = 2.0, valid_mask=None):
    """Hypothesis-parallel robust trifocal fit over point triples
    (ConfigTrifocal + RansacTrifocal assembly in the reference)."""
    def solver(sample):
        s1, s2, s3 = sample
        return trifocal.trifocal_linear(s1, s2, s3)

    def scorer(T, points):
        q1, q2, q3 = points
        return trifocal.transfer_error(T, q1, q2, q3)

    return robust.ransac(key, (p1, p2, p3), solver, scorer,
                         sample_size=8, num_hypotheses=num_hypotheses,
                         inlier_threshold=inlier_threshold_px ** 2,
                         valid_mask=valid_mask)


def estimate_metric_scene(p1, p2, p3, image_shape, key=None,
                          num_hypotheses: int = 256,
                          inlier_threshold_px: float = 2.0,
                          ba_iterations: int = 20) -> ThreeViewResult:
    """Full pipeline on associated pixel triples [N, 2] each.

    image_shape: (h, w) — observations are re-centered on the principal
    point first (the linear dual-quadratic self-calibration assumes a
    centered principal point, as the reference's does).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    h, w = image_shape
    c = jnp.asarray([(w - 1) / 2.0, (h - 1) / 2.0], jnp.float64)
    q1 = jnp.asarray(p1, jnp.float64) - c
    q2 = jnp.asarray(p2, jnp.float64) - c
    q3 = jnp.asarray(p3, jnp.float64) - c

    res = ransac_trifocal(key, q1, q2, q3, num_hypotheses,
                          inlier_threshold_px)
    T = res.model
    P2, P3 = cameras_from_trifocal(T)
    P1 = jnp.concatenate([jnp.eye(3, dtype=jnp.float64),
                          jnp.zeros((3, 1), jnp.float64)], axis=1)

    # self-calibrate: shared K, principal point at origin.  The linear
    # dual-quadratic solve is exact on clean data but collapses under
    # sub-pixel observation noise (the DIAC drifts off the PSD cone) —
    # the reference pairs it with SelfCalibrationGuessAndCheckFocus for
    # exactly this reason, so fall back to the focus sweep whenever the
    # linear result is unusable or implausible.
    Ps = np.stack([np.asarray(P1), np.asarray(P2), np.asarray(P3)])
    K = None
    try:
        K, H = selfcalib.self_calibrate_dual_quadratic(Ps)
        K = np.asarray(K, np.float64)
        H = np.asarray(H, np.float64)
        f_lin = 0.5 * (K[0, 0] + K[1, 1])
        if not np.isfinite(K).all() or not (0.2 * w < f_lin < 6.0 * w):
            K = None
    except Exception:
        K = None
    if K is None:
        cands = np.geomspace(0.25 * w, 5.0 * w, 60)
        f_best, H = selfcalib.guess_and_check_focus(
            Ps, focal_candidates=cands)
        # refine with a finer sweep around the coarse winner
        lo, hi = f_best / 1.12, f_best * 1.12
        f_best, H = selfcalib.guess_and_check_focus(
            Ps, focal_candidates=np.linspace(lo, hi, 25))
        K = np.diag([f_best, f_best, 1.0])
        H = np.asarray(H, np.float64)

    # metric upgrade: P_m = P H = K [R | t]
    Kinv = np.linalg.inv(K)
    Rs, ts = [], []
    for P in (np.asarray(P1), np.asarray(P2), np.asarray(P3)):
        Pm = P @ H
        A = Kinv @ Pm
        scale = np.cbrt(abs(np.linalg.det(A[:, :3])))
        A = A / (scale if scale > 1e-12 else 1.0)
        if np.linalg.det(A[:, :3]) < 0:
            A = -A
        R = np.asarray(se3.project_to_so3(jnp.asarray(A[:, :3])))
        Rs.append(R)
        ts.append(A[:, 3])
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    # normalized observations + triangulation of inliers
    obs = [jnp.einsum("ij,nj->ni", jnp.asarray(Kinv[:2, :2]), q)
           + jnp.asarray(Kinv[:2, 2]) for q in (q1, q2, q3)]
    obs = jnp.stack(obs)                                      # [3, N, 2]
    X = triangulate.triangulate_nview_linear(
        obs, jnp.asarray(Rs), jnp.asarray(ts))

    # cheirality: flip the scene if points land behind the first camera
    z1 = np.asarray(X)[:, 2]
    inl = np.asarray(res.inliers)
    if inl.any() and np.median(z1[inl]) < 0:
        # mirror: X -> -X, t -> -t (projective sign ambiguity)
        X = -X
        ts = -ts

    # metric BA over the inlier triples, with the focal length as a free
    # parameter ("pinhole_f"): the self-calibrated f is only an initial
    # guess (guess-and-check is coarse and the linear solve noise-fragile)
    # and the bundle polishes it against the raw centered-pixel
    # observations (centered = principal point already at the origin)
    n = X.shape[0]
    f0 = 0.5 * (K[0, 0] + K[1, 1])
    obs_px = np.stack([np.asarray(q) for q in (q1, q2, q3)])   # [3, N, 2]
    obs_n = obs.transpose(1, 0, 2)                             # init K's norm
    best = None
    for mult in (1.0, 0.7, 1.45):
        f_i = f0 * mult
        # re-derive structure consistent with this focal guess: rescale
        # the normalized observations and re-triangulate
        obs_i = np.asarray(obs_n) * (f0 / f_i)
        ts_i = ts
        if mult != 1.0:
            X_i = np.asarray(triangulate.triangulate_nview_linear(
                jnp.asarray(obs_i.transpose(1, 0, 2)), jnp.asarray(Rs),
                jnp.asarray(ts)))
            # same cheirality flip as the mult=1.0 structure above: the
            # pinhole_f cost is mirror-invariant, so without it a
            # behind-camera mirror can win the min-cost selection
            if inl.any() and np.median(X_i[inl, 2]) < 0:
                X_i = -X_i
                ts_i = -ts
        else:
            X_i = np.asarray(X)
        prob = ba.make_problem(
            R=Rs, t=ts_i, points=X_i,
            obs_xy=np.asarray(obs_px.transpose(1, 0, 2)),
            obs_view=np.tile(np.arange(3, dtype=np.int32), (n, 1)),
            obs_valid=np.tile(inl[:, None], (1, 3)),
            intr=np.full((3, 1), f_i), model="pinhole_f",
            fixed_views=np.array([True, False, False]))
        prob_opt, info = ba.optimize(prob, iterations=ba_iterations)
        c = float(info["final_cost"])
        f_ref = float(np.mean(np.asarray(prob_opt.intr)[:, 0]))
        # reject degenerate collapses (focal driven to ~0 or exploding)
        if not np.isfinite(c) or not (0.05 * w < f_ref < 20.0 * w):
            continue
        if best is None or c < best[0]:
            best = (c, prob_opt, info, f_ref)
    if best is None:
        raise ValueError("three-view metric BA failed for every focal seed")
    _, prob_opt, info, f_ref = best
    K = np.diag([f_ref, f_ref, 1.0])
    rmse = float(np.sqrt(2.0 * float(info["final_cost"])
                         / max(int(inl.sum()) * 3, 1))) / max(f_ref, 1e-9)
    return ThreeViewResult(K, np.asarray(prob_opt.R),
                           np.asarray(prob_opt.t),
                           np.asarray(prob_opt.points), inl, rmse)


def estimate_from_images(img1, img2, img3, key=None, max_features: int = 300,
                         detect=None, max_assoc_error: float = 0.25,
                         **kwargs) -> ThreeViewResult:
    """End-to-end three-view pipeline from RAW images:
    detect/describe -> AssociateThreeByPairs -> trifocal RANSAC ->
    self-calibration -> metric BA (the reference example's flow,
    ExampleTrifocalStereoUncalibrated + ThreeViewEstimateMetricScene).

    ``detect``: optional override returning
    sfm.reconstruction.ImageFeatures (tests use synthetic detections);
    default is SURF detect/describe.  Extra kwargs reach
    :func:`estimate_metric_scene`.
    """
    from boofcv_tpu.feature import associate
    from boofcv_tpu.sfm import reconstruction

    detect = detect or (lambda im: reconstruction.detect_describe(
        im, max_features))
    f1, f2, f3 = detect(img1), detect(img2), detect(img3)
    i1, i2, i3, valid = associate.associate_three_by_pairs(
        jnp.asarray(f1.desc), jnp.asarray(f2.desc), jnp.asarray(f3.desc),
        max_error=max_assoc_error ** 2,
        valid1=jnp.asarray(f1.valid), valid2=jnp.asarray(f2.valid),
        valid3=jnp.asarray(f3.valid))
    v = np.asarray(valid)
    i1, i2, i3 = np.asarray(i1)[v], np.asarray(i2)[v], np.asarray(i3)[v]
    if v.sum() < 12:
        raise ValueError(f"only {int(v.sum())} associated triples")
    p1 = np.stack([np.asarray(f1.xs)[i1], np.asarray(f1.ys)[i1]], 1)
    p2 = np.stack([np.asarray(f2.xs)[i2], np.asarray(f2.ys)[i2]], 1)
    p3 = np.stack([np.asarray(f3.xs)[i3], np.asarray(f3.ys)[i3]], 1)
    if not hasattr(img1, "shape") or len(img1.shape) < 2:
        raise ValueError("img1 must be an [H, W] array (needed for the "
                         "principal-point re-centering)")
    h, w = img1.shape[0], img1.shape[1]
    return estimate_metric_scene(p1, p2, p3, (h, w), key=key, **kwargs)
