"""Hypothesis-parallel robust estimation (RANSAC / LMedS).

Reference analog: the ddogleg `Ransac` / `LeastMedianOfSquares` loop driven
through boofcv-geo's ModelGenerator/DistanceFromModel adapters
(alg/geo/robust/, factory/geo/FactoryMultiViewRobust.java:109).  The
reference iterates hypotheses sequentially with early exit.

Design (SURVEY §2.4): draw ALL K hypothesis sample sets up front,
solve every minimal problem in one vmapped batch, score all K x N
residuals as one reduction, argmax inlier count.  Fixed K (static shape)
replaces early exit — choose K >= the reference's iteration budget.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: object            # best model pytree (leading axes stripped)
    inliers: jnp.ndarray     # [N] bool
    num_inliers: jnp.ndarray  # scalar int
    best_error: jnp.ndarray  # scalar: sum of clipped errors for best model


def sample_indices(key, num_hypotheses: int, sample_size: int, n: int,
                   valid_mask=None):
    """[K, S] random index sets.

    Sampling with replacement within a set is avoided by drawing scores and
    taking top-S per hypothesis (a permutation trick — O(K N log N) but one
    fused op).  If valid_mask is given, invalid entries are never chosen
    (assumes >= S valid).
    """
    scores = jax.random.uniform(key, (num_hypotheses, n))
    if valid_mask is not None:
        scores = jnp.where(valid_mask[None, :], scores, -1.0)
    # S masked-argmax passes instead of a full top_k: top_k sorts every
    # row, while S argmax reductions + one-hot knockouts do linear work
    # for the S<=8 used here.
    cols = jnp.arange(n, dtype=jnp.int32)[None, :]
    picks = []
    for _ in range(sample_size):
        i = jnp.argmax(scores, axis=1).astype(jnp.int32)
        picks.append(i)
        scores = jnp.where(cols == i[:, None], -2.0, scores)
    return jnp.stack(picks, axis=1)


def ransac(key, points, solver: Callable, scorer: Callable,
           sample_size: int, num_hypotheses: int, inlier_threshold: float,
           valid_mask=None, solutions_per_sample: int = 1):
    """Generic hypothesis-parallel RANSAC.

    points: pytree of arrays with leading axis N (e.g. (p1 [N,2], p2 [N,2])).
    solver(sampled_points) -> model pytree with leading axis
        ``solutions_per_sample`` (or no extra axis if 1) — vmapped over K.
    scorer(model, points) -> [N] per-point error (inf = unusable).
    Returns :class:`RansacResult`; model leaves have hypothesis axes
    removed.  MSAC-style scoring (clipped error) breaks inlier-count ties
    the same way the reference's fit-quality ordering does.
    """
    leaves = jax.tree_util.tree_leaves(points)
    n = leaves[0].shape[0]
    idx = sample_indices(key, num_hypotheses, sample_size, n, valid_mask)
    sampled = jax.tree_util.tree_map(lambda a: a[idx], points)  # leading [K, S]

    models = jax.vmap(solver)(sampled)

    if solutions_per_sample > 1:
        # flatten [K, M, ...] -> [K*M, ...]
        models = jax.tree_util.tree_map(
            lambda a: a.reshape((num_hypotheses * solutions_per_sample,) + a.shape[2:]),
            models)

    def score_one(model):
        return scorer(model, points)

    errors = jax.vmap(score_one)(models)  # [K(*M), N]
    # degenerate hypotheses can emit NaN — treat as unusable, not poison
    errors = jnp.where(jnp.isnan(errors), jnp.inf, errors)
    if valid_mask is not None:
        errors = jnp.where(valid_mask[None, :], errors, jnp.inf)
    is_in = errors <= inlier_threshold
    counts = jnp.sum(is_in, axis=-1)
    # MSAC score: sum of min(err, threshold)
    msac = jnp.sum(jnp.minimum(errors, inlier_threshold), axis=-1)
    # primary: max inliers; tie-break: min msac
    order = counts.astype(jnp.float64) - msac / (msac.max() + 1.0)
    best = jnp.argmax(order)
    best_model = jax.tree_util.tree_map(lambda a: a[best], models)
    return RansacResult(best_model, is_in[best], counts[best], msac[best])


def least_median_of_squares(key, points, solver, scorer, sample_size,
                            num_hypotheses, valid_mask=None,
                            solutions_per_sample: int = 1,
                            inlier_fraction: float = 0.5):
    """LMedS (ddogleg LeastMedianOfSquares analog): minimize the median
    (or given quantile) of squared errors; inliers = errors <= 2.5 * sigma
    with the standard robust sigma estimate."""
    leaves = jax.tree_util.tree_leaves(points)
    n = leaves[0].shape[0]
    idx = sample_indices(key, num_hypotheses, sample_size, n, valid_mask)
    sampled = jax.tree_util.tree_map(lambda a: a[idx], points)
    models = jax.vmap(solver)(sampled)
    if solutions_per_sample > 1:
        models = jax.tree_util.tree_map(
            lambda a: a.reshape((num_hypotheses * solutions_per_sample,) + a.shape[2:]),
            models)
    errors = jax.vmap(lambda m: scorer(m, points))(models)
    if valid_mask is not None:
        big = jnp.nanmax(jnp.where(jnp.isfinite(errors), errors, 0.0)) + 1.0
        errors = jnp.where(valid_mask[None, :], errors, big)
    errs_sorted = jnp.sort(jnp.where(jnp.isfinite(errors), errors, 1e30), axis=-1)
    q = jnp.clip(jnp.int32(n * inlier_fraction), 0, n - 1)
    med = errs_sorted[:, q]
    best = jnp.argmin(med)
    best_model = jax.tree_util.tree_map(lambda a: a[best], models)
    sigma = 1.4826 * (1.0 + 5.0 / (n - sample_size)) * jnp.sqrt(med[best])
    inliers = errors[best] <= (2.5 * sigma) ** 2
    return RansacResult(best_model, inliers, jnp.sum(inliers), med[best])


# ---------------------------------------------------------------------------
# Pre-wired robust estimators (FactoryMultiViewRobust analogs)
# ---------------------------------------------------------------------------

def ransac_fundamental(key, p1, p2, num_hypotheses: int = 512,
                       inlier_threshold_px: float = 1.0, valid_mask=None,
                       refit_rounds: int = 2):
    """Robust F via 7-point minimal sets + Sampson distance
    (FactoryMultiViewRobust.fundamentalRansac:273), followed by
    LO-RANSAC-style weighted 8-point refits on the inlier set (the
    reference pairs RANSAC with a nonlinear refine; linear refit on
    inliers recovers the same accuracy here)."""
    from boofcv_tpu.geo import epipolar

    def solver(sample):
        s1, s2 = sample
        F3, real = epipolar.fundamental_7pt(s1, s2)
        # invalid roots get F=identity-ish which scores terribly: mask by
        # scaling invalid to zero matrix -> infinite sampson handled below
        F3 = jnp.where(real[:, None, None], F3, jnp.eye(3, dtype=F3.dtype))
        return F3, real

    def scorer(model, points):
        F, real = model
        q1, q2 = points
        err = epipolar.sampson_error(F, q1.astype(jnp.float64),
                                     q2.astype(jnp.float64))
        return jnp.where(real, err, jnp.inf)

    res = ransac(key, (p1, p2), solver, scorer, sample_size=7,
                 num_hypotheses=num_hypotheses,
                 inlier_threshold=inlier_threshold_px ** 2,
                 valid_mask=valid_mask, solutions_per_sample=3)
    F, _ = res.model
    inliers = res.inliers
    thr = inlier_threshold_px ** 2
    p164 = p1.astype(jnp.float64)
    p264 = p2.astype(jnp.float64)
    # err must exist when refit_rounds == 0 (the MSAC score below)
    err = epipolar.sampson_error(F, p164, p264)
    err = jnp.where(jnp.isnan(err), jnp.inf, err)
    if valid_mask is not None:
        err = jnp.where(valid_mask, err, jnp.inf)
    for _ in range(refit_rounds):
        F = epipolar.fundamental_8pt(p164, p264, weights=inliers)
        err = epipolar.sampson_error(F, p164, p264)
        err = jnp.where(jnp.isnan(err), jnp.inf, err)
        if valid_mask is not None:
            err = jnp.where(valid_mask, err, jnp.inf)
        inliers = err <= thr
    msac = jnp.sum(jnp.minimum(err, thr))
    return RansacResult((F, jnp.asarray(True)), inliers,
                        jnp.sum(inliers), msac)


def ransac_essential(key, p1n, p2n, num_hypotheses: int = 512,
                     inlier_threshold: float = 1e-3, valid_mask=None,
                     refit_rounds: int = 3, solver_name: str = "nister5"):
    """Robust E from normalized coords, with LO-style weighted refits.

    ``solver_name``: 'nister5' (default) uses Nister's minimal 5-point
    solver — 5-point samples x 10 solutions per sample, the textbook
    minimal parameterization (EssentialNister5.java:62), needing ~8x
    fewer hypotheses than 8-point at the same outlier rate; '8pt' keeps
    the non-minimal linear solver.
    """
    from boofcv_tpu.geo import epipolar

    def scorer(E, points):
        q1, q2 = points
        return epipolar.sampson_error(E, q1.astype(jnp.float64),
                                      q2.astype(jnp.float64))

    if solver_name == "nister5":
        def solver(sample):
            s1, s2 = sample
            E, valid = epipolar.essential_nister5(s1, s2)
            # invalid solutions come back as NaN (epipolar.py avoids the
            # zero-matrix perfect-Sampson pitfall); ransac() maps NaN
            # errors to inf, so they lose every vote
            return E

        res = ransac(key, (p1n, p2n), solver, scorer, sample_size=5,
                     num_hypotheses=num_hypotheses,
                     inlier_threshold=inlier_threshold,
                     valid_mask=valid_mask, solutions_per_sample=10)
    else:
        def solver(sample):
            s1, s2 = sample
            return epipolar.essential_8pt(s1, s2)

        res = ransac(key, (p1n, p2n), solver, scorer, sample_size=8,
                     num_hypotheses=num_hypotheses,
                     inlier_threshold=inlier_threshold, valid_mask=valid_mask)
    # LO refits.  Two regimes exist: (a) the minimal-sample hypothesis is
    # noisy, so the bootstrap gate must be LOOSE and annealed down
    # (Lebeda-style LO-RANSAC), or (b) the hypothesis is already sharp and
    # loosening re-admits outliers whose least-squares leverage destroys
    # the refit.  Run BOTH chains branch-free and keep the candidate with
    # the best MSAC score — never worse than the raw hypothesis.
    p164 = p1n.astype(jnp.float64)
    p264 = p2n.astype(jnp.float64)

    def score(E):
        err = epipolar.sampson_error(E, p164, p264)
        err = jnp.where(jnp.isnan(err), jnp.inf, err)
        if valid_mask is not None:
            err = jnp.where(valid_mask, err, jnp.inf)
        return err

    thr = inlier_threshold
    rounds = max(refit_rounds, 2)
    candidates = [res.model]
    for boot, gates in (
            (thr, [thr] * rounds),                               # tight
            (thr * 10.0 ** rounds,
             [thr * 10.0 ** (rounds - 1 - r) for r in range(rounds)])):
        err = score(res.model)
        inliers = err <= boot
        for g in gates:
            E = epipolar.essential_8pt(p164, p264, weights=inliers)
            inliers = score(E) <= g
            candidates.append(E)
    Es = jnp.stack(candidates)
    errs = jax.vmap(score)(Es)
    counts = jnp.sum(errs <= thr, axis=-1)
    # Selection: max inlier count, ties broken toward the LATEST candidate.
    # The LS refit over the full consensus set is the max-likelihood
    # estimate when the inlier sets agree; the raw minimal-sample model can
    # show a marginally better clipped-Sampson score while its pose is far
    # less accurate (weak-geometry ambiguity), so Sampson-MSAC must NOT
    # pick between count-tied candidates.  Raw (index 0) wins only when a
    # refit chain collapsed to a strictly smaller consensus.
    order = counts * (len(candidates) + 1) + jnp.arange(len(candidates))
    best = jnp.argmax(order)
    msacs = jnp.sum(jnp.minimum(errs, thr), axis=-1)
    E = Es[best]
    err = errs[best]
    inliers = err <= thr
    return RansacResult(E, inliers, jnp.sum(inliers), msacs[best])


def ransac_homography(key, p1, p2, num_hypotheses: int = 512,
                      inlier_threshold_px: float = 2.0, valid_mask=None):
    from boofcv_tpu.geo import epipolar

    def solver(sample):
        s1, s2 = sample
        return epipolar.homography_dlt(s1, s2)

    def scorer(H, points):
        q1, q2 = points
        return epipolar.homography_transfer_error(
            H, q1.astype(jnp.float64), q2.astype(jnp.float64))

    return ransac(key, (p1, p2), solver, scorer, sample_size=4,
                  num_hypotheses=num_hypotheses,
                  inlier_threshold=inlier_threshold_px ** 2,
                  valid_mask=valid_mask)


def ransac_pnp(key, world, obs, num_hypotheses: int = 256,
               inlier_threshold: float = 1e-3, valid_mask=None,
               refine_iterations: int = 10, p3p: str = "grunert",
               polish_iterations: int = 0):
    """Robust camera pose from 2D/3D via batched P3P + GN refine on inliers
    (FactoryVisualOdometry.stereoDepth RANSAC assembly, :209).

    obs in normalized image coords; threshold in normalized units
    (the reference converts a pixel threshold via fx — do that upstream).
    p3p: "grunert" (quartic) or "finsterwalder" (cubic; the reference
    example's EnumPNP.P3P_FINSTERWALDER).  Returns
    (RansacResult, (R_refined, t_refined)).

    The whole hypothesis bank (minimal solves + scoring) runs in f32,
    the accelerator's fast precision.  Hypotheses only seed inlier
    classification (threshold ~1e-3 normalized units vs f32's ~1e-7
    resolution); the winning model is then GN-refined with an f64
    polish, so the returned pose is full precision.
    """
    from boofcv_tpu.geo import pnp

    minimal = {"grunert": pnp.p3p_grunert,
               "finsterwalder": pnp.p3p_finsterwalder}[p3p]

    def solver(sample):
        w, o = sample
        R4, t4, ok = minimal(w, o, dtype=jnp.float32)
        return R4, t4, ok

    def scorer(model, points):
        R, t, ok = model
        w, o = points
        # scoring (the [K, N] bulk) runs f32 — plenty for inlier
        # classification; solvers/refine stay f64
        err = pnp.reprojection_error_sq(
            R.astype(jnp.float32), t.astype(jnp.float32),
            w.astype(jnp.float32), o.astype(jnp.float32))
        return jnp.where(ok, err, jnp.inf)

    result = ransac(key, (world, obs), solver, scorer, sample_size=3,
                    num_hypotheses=num_hypotheses,
                    inlier_threshold=inlier_threshold,
                    valid_mask=valid_mask, solutions_per_sample=4)
    R, t, _ = result.model
    # weighted GN refine on inliers (mask via zero-weight residuals).
    # Masked rows must be FINITE: inf * 0 = NaN would poison the whole
    # normal system, so zero them out rather than relying on the weight.
    mask = result.inliers
    w64 = jnp.where(mask[:, None], world.astype(jnp.float64), 1.0)
    o64 = jnp.where(mask[:, None], obs.astype(jnp.float64), 0.0)
    # polish_iterations=0 by default: the f32 loop converges to ~1e-6
    # normalized units — far below tracking noise.  Callers
    # needing calibration-grade poses (not RANSAC consumers — they
    # follow with BA) can request f64 polish steps.
    Rr, tr = pnp.gauss_newton_pose(R, t, w64, o64,
                                   weights=mask.astype(jnp.float64),
                                   iterations=refine_iterations,
                                   damping=1e-9,
                                   polish_iterations=polish_iterations)
    return result, (Rr, tr)
