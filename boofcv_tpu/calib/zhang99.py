"""Zhang 1999 planar camera calibration.

Reference analog: boofcv-calibration alg/geo/calibration/
CalibrationPlanarGridZhang99.java:67,122 — per-view homographies
(Zhang99ComputeTargetHomography), linear K (Zhang99CalibrationMatrix-
FromHomographies), extrinsics (Zhang99DecomposeHomography), linear radial
init (RadialDistortionEstimateLinear), then a full nonlinear refine
(ddogleg LM -> here: damped Gauss-Newton over all parameters at once,
with jacobians by autodiff; every view's reprojection is batched).

Stereo calibration (CalibrateStereoPlanar): calibrate each camera mono,
then average the per-view relative poses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.geo import epipolar, se3


@dataclass
class CalibrationResult:
    K: np.ndarray                 # [3,3]
    radial: tuple                 # (k1, k2)
    rotations: np.ndarray         # [V,3,3] world(target)->camera
    translations: np.ndarray      # [V,3]
    reprojection_rmse: float
    mirror_offset: float = 0.0    # universal-omni xi (0 for Brown/pinhole)


def homographies_per_view(world_xy, obs):
    """[V,3,3] target-plane->pixel homographies (batched DLT).

    world_xy: [N, 2] planar target points; obs: [V, N, 2] pixels.
    """
    V = obs.shape[0]
    w = jnp.broadcast_to(jnp.asarray(world_xy, jnp.float64)[None],
                         (V,) + world_xy.shape)
    return epipolar.homography_dlt(w, jnp.asarray(obs, jnp.float64))


def k_from_homographies(Hs):
    """Linear intrinsics from >=3 homographies (Zhang99CalibrationMatrix-
    FromHomographies; zero-skew variant is the reference default)."""
    Hs = np.asarray(Hs, np.float64)

    def v_ij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    rows = []
    for H in Hs:
        rows.append(v_ij(H, 0, 1))
        rows.append(v_ij(H, 0, 0) - v_ij(H, 1, 1))
    A = np.stack(rows)
    _, _, Vt = np.linalg.svd(A)
    b = Vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
    lam = B33 - (B13 ** 2 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = np.sqrt(abs(lam / B11))
    fy = np.sqrt(abs(lam * B11 / (B11 * B22 - B12 ** 2)))
    skew = -B12 * fx ** 2 * fy / lam
    cx = skew * cy / fx - B13 * fx ** 2 / lam
    return np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])


def extrinsics_from_homography(H, K):
    """(R, t) target->camera from H = K [r1 r2 t] (Zhang99Decompose-
    Homography)."""
    Kinv = np.linalg.inv(K)
    A = Kinv @ np.asarray(H, np.float64)
    s = 1.0 / np.linalg.norm(A[:, 0])
    if A[2, 2] * s < 0:  # target must be in front
        s = -s
    r1 = A[:, 0] * s
    r2 = A[:, 1] * s
    r3 = np.cross(r1, r2)
    t = A[:, 2] * s
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return R, t


def linear_radial_estimate(world_xy, obs, K, Rs, ts, obs_mask=None):
    """Least-squares (k1, k2) from residuals vs the pinhole projection
    (RadialDistortionEstimateLinear)."""
    K = np.asarray(K)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    w3 = np.concatenate([world_xy, np.zeros((world_xy.shape[0], 1))], 1)
    Xc = np.einsum("vij,nj->vni", np.asarray(Rs), w3) \
        + np.asarray(ts)[:, None]                            # [V,N,3]
    xn = Xc[..., :2] / Xc[..., 2:]
    r2 = np.sum(xn ** 2, axis=-1)                            # [V,N]
    u = fx * xn[..., 0] + cx
    vv = fy * xn[..., 1] + cy
    du = obs[..., 0] - u
    dv = obs[..., 1] - vv
    # rows: [V,N,2(uv),2(k1 k2)], rhs: [V,N,2]
    cu = np.stack([(u - cx) * r2, (u - cx) * r2 * r2], -1)
    cv = np.stack([(vv - cy) * r2, (vv - cy) * r2 * r2], -1)
    A = np.stack([cu, cv], axis=2)
    b = np.stack([du, dv], axis=2)
    if obs_mask is not None:
        A = A[obs_mask]
        b = b[obs_mask]
    k, *_ = np.linalg.lstsq(A.reshape(-1, 2), b.reshape(-1), rcond=None)
    return float(k[0]), float(k[1])


def _project_all(params, world_xy, n_views):
    """Full Brown-pinhole projection of every target point in every view.

    params: [5 + 2 + 6V] = (fx, fy, skew, cx, cy, k1, k2, per-view xi).
    Returns [V, N, 2].
    """
    fx, fy, skew, cx, cy, k1, k2 = params[:7]
    w3 = jnp.concatenate(
        [world_xy, jnp.zeros((world_xy.shape[0], 1), world_xy.dtype)], 1)

    def one_view(xi):
        R, t = se3.exp_se3(xi)
        Xc = w3 @ R.T + t
        xn = Xc[:, :2] / Xc[:, 2:]
        r2 = jnp.sum(xn ** 2, axis=1, keepdims=True)
        d = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = xn * d
        u = fx * xd[:, 0] + skew * xd[:, 1] + cx
        v = fy * xd[:, 1] + cy
        return jnp.stack([u, v], axis=1)

    xis = params[7:].reshape(n_views, 6)
    return jax.vmap(one_view)(xis)


def _brown_project_and_jac(intr, Rs, ts, w3):
    """Batched ANALYTIC Brown-pinhole projection + jacobians for every
    (view, corner) at once (the reference likewise differentiates
    analytically — CalibrationPlanarGridZhang99.java:122 wires
    Zhang99OptimizationJacobian into the LM).

    intr: [7] = (fx, fy, skew, cx, cy, k1, k2); Rs: [V,3,3]; ts: [V,3];
    w3: [N,3] planar target points (z=0).

    Pose jacobians are taken w.r.t. a LEFT-multiplied se3 perturbation
    (R <- exp(dw) R, t <- exp(dw) t + dv), the same local
    parameterization as geo.ba._jacobians — so at the linearization
    point dXc/dw = -hat(Xc), dXc/dv = I, with no exp-map second-order
    terms to differentiate.

    Returns (proj [V,N,2], Ji [V,N,2,7], Jx [V,N,2,6]).
    """
    fx, fy, skew, cx, cy, k1, k2 = intr
    Xc = jnp.einsum("vij,nj->vni", Rs, w3) + ts[:, None]     # [V,N,3]
    z = Xc[..., 2]
    iz = 1.0 / z
    xn = Xc[..., :2] * iz[..., None]                         # [V,N,2]
    r2 = jnp.sum(xn * xn, axis=-1)                           # [V,N]
    d = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * d[..., None]
    u = fx * xd[..., 0] + skew * xd[..., 1] + cx
    v = fy * xd[..., 1] + cy
    proj = jnp.stack([u, v], axis=-1)

    # intrinsics jacobian (closed form)
    zero = jnp.zeros_like(r2)
    one = jnp.ones_like(r2)
    du = jnp.stack([xd[..., 0], zero, xd[..., 1], one, zero,
                    (fx * xn[..., 0] + skew * xn[..., 1]) * r2,
                    (fx * xn[..., 0] + skew * xn[..., 1]) * r2 * r2], -1)
    dv = jnp.stack([zero, xd[..., 1], zero, zero, one,
                    fy * xn[..., 1] * r2,
                    fy * xn[..., 1] * r2 * r2], -1)
    Ji = jnp.stack([du, dv], axis=-2)                        # [V,N,2,7]

    # pixel <- distorted <- normalized <- camera-point chain
    # dxd/dxn = d*I + xn (k1 + 2 k2 r2) * 2 xn^T
    g = 2.0 * (k1 + 2.0 * k2 * r2)                           # [V,N]
    Dxd = d[..., None, None] * jnp.eye(2, dtype=d.dtype) \
        + g[..., None, None] * xn[..., :, None] * xn[..., None, :]
    Kpix = jnp.stack([jnp.stack([fx, skew]), jnp.stack([0.0 * fx, fy])])
    # dxn/dXc = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
    A0 = jnp.stack([
        jnp.stack([iz, zero, -Xc[..., 0] * iz * iz], -1),
        jnp.stack([zero, iz, -Xc[..., 1] * iz * iz], -1)], -2)
    A = jnp.einsum("ij,vnjk,vnkl->vnil", Kpix, Dxd, A0)      # [V,N,2,3]
    Jx = jnp.concatenate([-jnp.einsum("vnij,vnjk->vnik", A, se3.hat(Xc)),
                          A], axis=-1)                       # [V,N,2,6]
    return proj, Ji, Jx



from functools import partial as _partial


@_partial(jax.jit, static_argnames=("iterations", "zero_skew"))
def _refine_brown(intr0, Rs0, ts0, w3, obsj, maskj, iterations: int,
                  zero_skew: bool):
    """Damped-GN refine of (intrinsics, per-view poses), jitted and
    cached on shapes: the whole LM loop is ONE compiled program (the
    uncached lax.scan re-traced + re-lowered ~200 ms per call).

    Block-sparse assembly: view v's corners depend only on the 7
    intrinsics and its own 6-DoF pose, so the per-view pose blocks are
    Schur-eliminated and only a 7x7 reduced system is ever factored.
    """
    from boofcv_tpu.geo.smalllinalg import solve_spd

    def cost_of(state):
        intr, R_, t_ = state
        proj, _, _ = _brown_project_and_jac(intr, R_, t_, w3)
        r = jnp.where(maskj, proj - obsj, 0.0)
        return jnp.sum(r * r)

    def gn_step(carry, _):
        state, lam = carry
        intr, R_, t_ = state
        proj, Ji, Jx = _brown_project_and_jac(intr, R_, t_, w3)
        r = jnp.where(maskj, proj - obsj, 0.0)
        Ji = jnp.where(maskj[..., None], Ji, 0.0)
        Jx = jnp.where(maskj[..., None], Jx, 0.0)
        if zero_skew:
            Ji = Ji.at[..., 2].set(0.0)
        eye7 = jnp.eye(7, dtype=r.dtype)
        eye6 = jnp.eye(6, dtype=r.dtype)
        Hii = jnp.einsum("vnki,vnkj->ij", Ji, Ji) + lam * eye7
        Hxx = jnp.einsum("vnki,vnkj->vij", Jx, Jx) + lam * eye6
        Hix = jnp.einsum("vnki,vnkj->vij", Ji, Jx)           # [V,7,6]
        gi = jnp.einsum("vnki,vnk->i", Ji, r)
        gx = jnp.einsum("vnki,vnk->vi", Jx, r)
        Hxx_inv = jnp.linalg.inv(Hxx)                        # [V,6,6]
        Heff = Hii - jnp.einsum("vij,vjk,vlk->il", Hix, Hxx_inv, Hix)
        geff = gi - jnp.einsum("vij,vjk,vk->i", Hix, Hxx_inv, gx)
        di = -solve_spd(Heff, geff)
        if zero_skew:
            di = di.at[2].set(0.0)
        dx = -jnp.einsum("vij,vj->vi",
                         Hxx_inv, gx + jnp.einsum("vji,j->vi", Hix, di))
        dR, dt = jax.vmap(se3.exp_se3)(dx)
        cand = (intr + di, jnp.einsum("vij,vjk->vik", dR, R_),
                jnp.einsum("vij,vj->vi", dR, t_) + dt)
        c0 = jnp.sum(r * r)
        c1 = cost_of(cand)
        good = jnp.isfinite(c1) & (c1 < c0)
        state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.reshape(good, (1,) * a.ndim), b, a),
            state, cand)
        lam = jnp.clip(jnp.where(good, lam * 0.3, lam * 10.0), 1e-10, 1e6)
        return (state, lam), jnp.where(good, c1, c0)

    (state, _), _ = jax.lax.scan(gn_step, ((intr0, Rs0, ts0),
                                           jnp.float64(1e-3)),
                                 None, length=iterations)
    intr, Rs_out, ts_out = state
    proj, _, _ = _brown_project_and_jac(intr, Rs_out, ts_out, w3)
    return intr, Rs_out, ts_out, proj


def _calibrate_mono_planar_impl(world_xy, obs, iterations: int = 30,
                          zero_skew: bool = True,
                          obs_mask=None) -> CalibrationResult:
    """Full Zhang99 pipeline (CalibrateMonoPlanar.process:160).

    world_xy: [N, 2] planar target coordinates; obs: [V, N, 2] detected
    pixels per view (V >= 3).  ``obs_mask``: optional [V, N] bool —
    False marks corners NOT detected in that view (occlusion); masked
    observations are excluded from every stage (the reference's detector
    likewise feeds partial grids into calibration).
    """
    world_xy = np.asarray(world_xy, np.float64)
    obs = np.asarray(obs, np.float64)
    V = obs.shape[0]
    if obs_mask is None:
        obs_mask = np.ones(obs.shape[:2], bool)
    else:
        obs_mask = np.asarray(obs_mask, bool)
        counts = obs_mask.sum(axis=1)
        if (counts < 4).any():
            bad = np.nonzero(counts < 4)[0].tolist()
            raise ValueError(
                f"views {bad} have fewer than 4 unmasked corners "
                f"(counts {counts[bad].tolist()}) — the per-view "
                "homography is underdetermined; drop those views")

    if obs_mask.all():
        Hs = np.asarray(homographies_per_view(world_xy, obs))
    else:
        Hs = np.stack([
            np.asarray(epipolar.homography_dlt(
                jnp.asarray(world_xy[obs_mask[v]][None]),
                jnp.asarray(obs[v][obs_mask[v]][None])))[0]
            for v in range(V)])
    K0 = k_from_homographies(Hs)
    if zero_skew:
        K0[0, 1] = 0.0
    Rs, ts = [], []
    for v in range(V):
        R, t = extrinsics_from_homography(Hs[v], K0)
        Rs.append(R)
        ts.append(t)
    Rs = np.stack(Rs)
    ts = np.stack(ts)
    k1, k2 = linear_radial_estimate(world_xy, obs, K0, Rs, ts,
                                    obs_mask=obs_mask)

    # nonlinear refine: batched analytic jacobians + Schur elimination
    # of the per-view pose blocks (see _refine_brown).
    intr0 = jnp.asarray([K0[0, 0], K0[1, 1], K0[0, 1], K0[0, 2], K0[1, 2],
                         k1, k2])
    wj = jnp.asarray(world_xy)
    w3 = jnp.concatenate([wj, jnp.zeros((wj.shape[0], 1), wj.dtype)], 1)
    intr, Rs_out, ts_out, proj = _refine_brown(
        intr0, jnp.asarray(Rs), jnp.asarray(ts), w3, jnp.asarray(obs),
        jnp.asarray(obs_mask)[..., None], iterations, zero_skew)
    fx, fy, skew, cx, cy, k1, k2 = np.asarray(intr)
    K = np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])
    err2 = np.sum((np.asarray(proj) - obs) ** 2, axis=-1)
    rmse = float(np.sqrt(np.mean(err2[obs_mask])))
    return CalibrationResult(K, (float(k1), float(k2)),
                             np.asarray(Rs_out), np.asarray(ts_out), rmse)


def _project_all_omni(params, world_xy, n_views):
    """Universal-omni projection of every target point in every view
    (Zhang99CameraUniversalOmni.java:39's camera model: ray -> unit
    sphere -> +xi along z -> Brown distortion -> pinhole).

    params: [8 + 6V] = (fx, fy, skew, cx, cy, k1, k2, xi, per-view se3).
    Returns [V, N, 2].
    """
    fx, fy, skew, cx, cy, k1, k2, xi = params[:8]
    w3 = jnp.concatenate(
        [world_xy, jnp.zeros((world_xy.shape[0], 1), world_xy.dtype)], 1)

    def one_view(p6):
        R, t = se3.exp_se3(p6)
        Xc = w3 @ R.T + t
        n = jnp.sqrt(jnp.sum(Xc * Xc, axis=1, keepdims=True))
        n = jnp.where(n < 1e-12, 1.0, n)
        s = Xc / n
        sz = s[:, 2:] + xi
        sz = jnp.where(jnp.abs(sz) < 1e-9, 1e-9, sz)
        xn = s[:, :2] / sz
        r2 = jnp.sum(xn ** 2, axis=1, keepdims=True)
        d = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = xn * d
        u = fx * xd[:, 0] + skew * xd[:, 1] + cx
        v = fy * xd[:, 1] + cy
        return jnp.stack([u, v], axis=1)

    p6s = params[8:].reshape(n_views, 6)
    return jax.vmap(one_view)(p6s)


def _calibrate_mono_omni_impl(world_xy, obs, iterations: int = 40,
                        zero_skew: bool = True,
                        mirror_inits=(0.0, 0.5, 1.0, 1.5)):
    """Zhang99 with the universal-omni (fisheye) camera
    (Zhang99CameraUniversalOmni.java:39 analog).

    Same pipeline as the Brown path, but the nonlinear stage optimizes
    the unified-camera mirror offset xi as well.  The linear homography
    init is biased under strong fisheye distortion, so the mirror offset
    is seeded by guess-and-check over ``mirror_inits`` (the reference's
    own self-calibration uses the same guess-and-check idiom) and the
    best-converged solution wins.
    """
    world_xy = np.asarray(world_xy, np.float64)
    obs = np.asarray(obs, np.float64)
    V = obs.shape[0]

    Hs = np.asarray(homographies_per_view(world_xy, obs))
    K0 = k_from_homographies(Hs)
    if zero_skew:
        K0[0, 1] = 0.0
    Rs, ts = [], []
    for v in range(V):
        R, t = extrinsics_from_homography(Hs[v], K0)
        Rs.append(R)
        ts.append(t)
    xi0 = []
    for v in range(V):
        w = np.asarray(se3.log_so3(jnp.asarray(Rs[v])))
        xi0.append(np.concatenate([w, ts[v]]))
    wj = jnp.asarray(world_xy)
    obsj = jnp.asarray(obs)

    def refine(params0):
        def residual(p):
            return (_project_all_omni(p, wj, V) - obsj).ravel()

        def gn_step(carry, _):
            p, lam = carry
            r = residual(p)
            J = jax.jacfwd(residual)(p)
            H = J.T @ J
            g = J.T @ r
            n = H.shape[0]
            from boofcv_tpu.geo.smalllinalg import solve_spd
            step = -solve_spd(H + lam * jnp.eye(n, dtype=H.dtype), g)
            if zero_skew:
                step = step.at[2].set(0.0)
            p_new = p + step
            c0 = jnp.sum(r * r)
            c1 = jnp.sum(residual(p_new) ** 2)
            good = jnp.isfinite(c1) & (c1 < c0)
            p = jnp.where(good, p_new, p)
            lam = jnp.clip(jnp.where(good, lam * 0.3, lam * 10.0),
                           1e-10, 1e6)
            return (p, lam), jnp.where(good, c1, c0)

        (p, _), costs = jax.lax.scan(
            gn_step, (params0, jnp.float64(1e-3)), None, length=iterations)
        return p, jnp.sum(residual(p) ** 2)

    best_p, best_c = None, np.inf
    for mi in mirror_inits:
        # larger xi widens the image of a given ray: rescale the focal
        # guess accordingly so the init stays in the basin
        params0 = jnp.asarray(np.concatenate(
            [[K0[0, 0] * (1.0 + mi), K0[1, 1] * (1.0 + mi), K0[0, 1],
              K0[0, 2], K0[1, 2], 0.0, 0.0, mi],
             np.concatenate(xi0)]))
        p, c = refine(params0)
        c = float(c)
        if np.isfinite(c) and c < best_c:
            best_p, best_c = np.asarray(p), c

    if best_p is None:
        raise ValueError(
            "omni calibration failed: every mirror-offset seed diverged "
            "(degenerate target geometry or non-finite observations)")
    p = best_p
    fx, fy, skew, cx, cy, k1, k2, mirror = p[:8]
    K = np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1.0]])
    Rs_out, ts_out = [], []
    for v in range(V):
        R, t = se3.exp_se3(jnp.asarray(p[8 + 6 * v: 14 + 6 * v]))
        Rs_out.append(np.asarray(R))
        ts_out.append(np.asarray(t))
    proj = np.asarray(_project_all_omni(jnp.asarray(p), wj, V))
    rmse = float(np.sqrt(np.mean(np.sum((proj - obs) ** 2, axis=-1))))
    return CalibrationResult(K, (float(k1), float(k2)),
                             np.stack(Rs_out), np.stack(ts_out), rmse,
                             mirror_offset=float(mirror))


def calibrate_stereo_planar(world_xy, obs_left, obs_right,
                            iterations: int = 30):
    """CalibrateStereoPlanar analog: mono-calibrate both cameras on the
    same target views, then average the per-view left->right transforms.

    Returns (left_result, right_result, R_l2r, t_l2r).
    """
    left = calibrate_mono_planar(world_xy, obs_left, iterations)
    right = calibrate_mono_planar(world_xy, obs_right, iterations)
    # per view: x_r = R_r X + t_r; X = R_l^T (x_l - t_l)
    # => x_r = R_r R_l^T x_l + (t_r - R_r R_l^T t_l)
    Rs, ts = [], []
    for v in range(left.rotations.shape[0]):
        Rrel = right.rotations[v] @ left.rotations[v].T
        trel = right.translations[v] - Rrel @ left.translations[v]
        Rs.append(Rrel)
        ts.append(trel)
    # average rotations via chordal mean (project the mean matrix to SO3)
    Rmean = np.asarray(se3.project_to_so3(jnp.asarray(np.mean(Rs, axis=0))))
    tmean = np.mean(ts, axis=0)
    return left, right, Rmean, tmean


def calibrate_mono_planar(world_xy, obs, iterations: int = 30,
                          zero_skew: bool = True,
                          obs_mask=None) -> CalibrationResult:
    """Full Zhang99 pipeline (CalibrateMonoPlanar.process:160) — see
    ``_calibrate_mono_planar_impl`` for the algorithm.  Runs on the
    default device."""
    return _calibrate_mono_planar_impl(world_xy, obs, iterations,
                                       zero_skew, obs_mask)


def calibrate_mono_omni(world_xy, obs, iterations: int = 40,
                        zero_skew: bool = True,
                        mirror_inits=(0.0, 0.5, 1.0, 1.5)):
    """Universal-omni Zhang99 (see ``_calibrate_mono_omni_impl``)."""
    return _calibrate_mono_omni_impl(world_xy, obs, iterations,
                                     zero_skew, mirror_inits)
