"""Perspective-n-Point pose estimation.

Reference analog: boofcv-geo alg/geo/pose/ — P3PGrunert.java (closed-form
3-point), PnPLepetitEPnP.java:104 (EPnP), the DLT PnP, and the nonlinear
refiner with Rodrigues jacobians (PnPJacobianRodrigues.java).

Design: P3P is the RANSAC minimal solver — written fully batched so K
hypotheses solve as one quartic-root (companion eigenvalue) batch; the
absolute-orientation step (point-cloud alignment) is a batched 3x3 SVD.
The refiner is Gauss-Newton on se(3) with a fixed iteration count
(lax.fori_loop), replacing the reference's ddogleg LM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from boofcv_tpu.geo import se3


def _quartic_roots(c4, c3, c2, c1, c0):
    """Real quartic roots — closed-form Ferrari (no batched eigvals on
    the accelerator; see smalllinalg).  Returns (roots [..., 4], real_mask [..., 4])."""
    from boofcv_tpu.geo.smalllinalg import quartic_roots
    return quartic_roots(c4, c3, c2, c1, c0)


def absolute_orientation(world, cam, dtype=jnp.float64):
    """Rigid alignment world->camera minimizing ||R w + t - c|| (batched
    Horn quaternion method; reference: FitSpecialEuclideanOps / the
    alignment inside P3P pose recovery).

    world, cam: [..., N, 3].  Returns (R [..., 3, 3], t [..., 3]).
    Uses eigh of the 4x4 quaternion matrix rather than SVD (written for
    a first target whose compiler failed on f32 SVD), and ``dtype=jnp.float32`` makes RANSAC hypothesis
    generation cheap (the winner is re-refined in f64 anyway).
    """
    world = world.astype(dtype)
    cam = cam.astype(dtype)
    wm = jnp.mean(world, axis=-2, keepdims=True)
    cm = jnp.mean(cam, axis=-2, keepdims=True)
    M = jnp.swapaxes(world - wm, -1, -2) @ (cam - cm)  # [..., 3, 3]
    m = lambda i, j: M[..., i, j]
    k0 = m(0, 0) + m(1, 1) + m(2, 2)
    K4 = jnp.stack([
        jnp.stack([k0, m(1, 2) - m(2, 1), m(2, 0) - m(0, 2),
                   m(0, 1) - m(1, 0)], axis=-1),
        jnp.stack([m(1, 2) - m(2, 1), m(0, 0) - m(1, 1) - m(2, 2),
                   m(0, 1) + m(1, 0), m(0, 2) + m(2, 0)], axis=-1),
        jnp.stack([m(2, 0) - m(0, 2), m(0, 1) + m(1, 0),
                   -m(0, 0) + m(1, 1) - m(2, 2), m(1, 2) + m(2, 1)],
                  axis=-1),
        jnp.stack([m(0, 1) - m(1, 0), m(0, 2) + m(2, 0),
                   m(1, 2) + m(2, 1), -m(0, 0) - m(1, 1) + m(2, 2)],
                  axis=-1),
    ], axis=-2)
    _, vecs = jnp.linalg.eigh(K4)
    q = vecs[..., :, -1]                     # max eigenvalue -> quaternion
    w_, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w_),
                   2 * (x * z + y * w_)], axis=-1),
        jnp.stack([2 * (x * y + z * w_), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w_)], axis=-1),
        jnp.stack([2 * (x * z - y * w_), 2 * (y * z + x * w_),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)
    t = cm[..., 0, :] - (R @ wm[..., 0, :, None])[..., 0]
    return R, t


def rigid_from_three_points(world, cam):
    """Closed-form rigid alignment for EXACTLY three exact correspondences.

    world, cam: [..., 3, 3] (three points, xyz).  Returns (R, t) with
    cam_i = R @ world_i + t.  Builds the orthonormal triangle frame in
    both coordinate systems and composes them — no eigh/SVD, pure
    arithmetic, cheaper than Horn's quaternion method (an eigen-solve)
    for the P3P hypothesis path (where correspondences are exact by
    construction, so least-squares generality buys nothing).
    """
    def frame(p):
        u = p[..., 1, :] - p[..., 0, :]
        v = p[..., 2, :] - p[..., 0, :]
        e1 = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-30)
        w = v - jnp.sum(v * e1, axis=-1, keepdims=True) * e1
        e2 = w / jnp.maximum(jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-30)
        e3 = jnp.cross(e1, e2)
        return jnp.stack([e1, e2, e3], axis=-1)      # columns
    Bw = frame(world)
    Bc = frame(cam)
    # pin full precision: a reduced-precision default (TF32 on a GPU)
    # caps the "f64 oracle" P3P path's rotation accuracy
    R = jnp.einsum("...ij,...kj->...ik", Bc, Bw, precision="highest")
    cw = jnp.mean(world, axis=-2)
    cc = jnp.mean(cam, axis=-2)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def p3p_grunert(world, obs, dtype=jnp.float64):
    """Grunert's P3P (P3PGrunert.java), batched over hypotheses.

    world: [..., 3, 3] three 3D points; obs: [..., 3, 2] normalized image
    coords.  Returns (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4]):
    up to 4 pose solutions per sample (quartic roots), camera-from-world.

    ``dtype=jnp.float32`` runs the whole closed form in f32 — right for
    RANSAC hypothesis generation, where hypotheses only seed inlier
    classification and the winner is re-refined.
    """
    world = world.astype(dtype)
    obs = obs.astype(dtype)
    # unit bearing vectors
    f = jnp.concatenate([obs, jnp.ones_like(obs[..., :1])], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    # side lengths
    a = jnp.linalg.norm(P2 - P3, axis=-1)
    b = jnp.linalg.norm(P1 - P3, axis=-1)
    c = jnp.linalg.norm(P1 - P2, axis=-1)
    # angles
    cos_alpha = jnp.sum(f2 * f3, axis=-1)
    cos_beta = jnp.sum(f1 * f3, axis=-1)
    cos_gamma = jnp.sum(f1 * f2, axis=-1)

    a2, b2, c2 = a * a, b * b, c * c
    # Grunert's quartic in v where s2 = u*s1... following the classical
    # derivation (Haralick et al. review of P3P):
    q1 = (a2 - c2) / b2
    q2 = (a2 + c2) / b2
    q3 = (b2 - c2) / b2
    q4 = (b2 - a2) / b2

    A4 = (q1 - 1.0) ** 2 - 4.0 * c2 / b2 * cos_alpha ** 2
    A3 = 4.0 * (q1 * (1.0 - q1) * cos_beta
                - (1.0 - q2) * cos_alpha * cos_gamma
                + 2.0 * c2 / b2 * cos_alpha ** 2 * cos_beta)
    A2 = 2.0 * (q1 ** 2 - 1.0
                + 2.0 * q1 ** 2 * cos_beta ** 2
                + 2.0 * q3 * cos_alpha ** 2
                - 4.0 * q2 * cos_alpha * cos_beta * cos_gamma
                + 2.0 * q4 * cos_gamma ** 2)
    A1 = 4.0 * (-q1 * (1.0 + q1) * cos_beta
                + 2.0 * a2 / b2 * cos_gamma ** 2 * cos_beta
                - (1.0 - q2) * cos_alpha * cos_gamma)
    A0 = (1.0 + q1) ** 2 - 4.0 * a2 / b2 * cos_gamma ** 2

    v, real = _quartic_roots(A4, A3, A2, A1, A0)  # [..., 4]

    # back-substitute: u from v, then s1
    cb = cos_beta[..., None]
    ca = cos_alpha[..., None]
    cg = cos_gamma[..., None]
    q1e = q1[..., None]
    q3e = q3[..., None]
    b2e = b2[..., None]
    a2e = a2[..., None]
    c2e = c2[..., None]
    num = (-1.0 + q1e) * v * v - 2.0 * q1e * cb * v + 1.0 + q1e
    den = 2.0 * (cg - v * ca)
    den = jnp.where(jnp.abs(den) < 1e-30, 1e-30, den)
    u = num / den
    s1sq_den = 1.0 + u * u - 2.0 * u * cg
    s1sq_den = jnp.where(jnp.abs(s1sq_den) < 1e-30, 1e-30, s1sq_den)
    s1 = jnp.sqrt(jnp.maximum(c2e / s1sq_den, 0.0))
    s2 = u * s1
    s3 = v * s1
    ok = real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points, then absolute orientation per root
    cam1 = s1[..., None] * f1[..., None, :]  # [..., 4, 3]
    cam2 = s2[..., None] * f2[..., None, :]
    cam3 = s3[..., None] * f3[..., None, :]
    cam = jnp.stack([cam1, cam2, cam3], axis=-2)  # [..., 4, 3pts, 3]
    worldr = jnp.broadcast_to(world[..., None, :, :], cam.shape)
    # honor the requested dtype: the f32 cast here silently capped the
    # documented f64 path at f32 accuracy (6.6e-8 rotation error instead
    # of ~2e-16); the RANSAC fast path passes dtype=float32 explicitly
    R, t = rigid_from_three_points(worldr.astype(dtype),
                                   cam.astype(dtype))
    return R.astype(dtype), t.astype(dtype), ok


def p3p_finsterwalder(world, obs, dtype=jnp.float64):
    """Finsterwalder's P3P (P3PFinsterwalder.java analog), batched.

    Same interface as :func:`p3p_grunert` — world [..., 3, 3],
    obs [..., 3, 2] normalized — returning up to 4 poses
    (R [..., 4, 3, 3], t [..., 4, 3], valid [..., 4]).

    Method (Haralick et al. 1994 review): with u = s2/s1, v = s3/s1 the
    two side-ratio constraints are conics in (u, v); a lambda making
    their pencil degenerate (root of a CUBIC, vs Grunert's quartic)
    splits it into two lines, each intersected with one conic (two
    quadratics).  All steps are closed-form and vmap cleanly.
    """
    from boofcv_tpu.geo.epipolar import _cubic_roots

    world = world.astype(dtype)
    obs = obs.astype(dtype)
    f = jnp.concatenate([obs, jnp.ones_like(obs[..., :1])], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    P1, P2, P3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    a2 = jnp.sum((P2 - P3) ** 2, -1)
    b2 = jnp.sum((P1 - P3) ** 2, -1)
    c2 = jnp.sum((P1 - P2) ** 2, -1)
    ca = jnp.sum(f2 * f3, -1)   # cos(alpha)
    cb = jnp.sum(f1 * f3, -1)   # cos(beta)
    cg = jnp.sum(f1 * f2, -1)   # cos(gamma)

    z = jnp.zeros_like(a2)

    def sym3(m00, m01, m02, m11, m12, m22):
        r0 = jnp.stack([m00, m01, m02], -1)
        r1 = jnp.stack([m01, m11, m12], -1)
        r2 = jnp.stack([m02, m12, m22], -1)
        return jnp.stack([r0, r1, r2], -2)

    # conic (i):  -b^2 u^2 + 2 b^2 ca uv + (a^2-b^2) v^2 - 2 a^2 cb v + a^2
    Q1 = sym3(-b2, b2 * ca, z, a2 - b2, -a2 * cb, a2)
    # conic (ii): (a^2-c^2) u^2 + 2 c^2 ca uv - c^2 v^2 - 2 a^2 cg u + a^2
    Q2 = sym3(a2 - c2, c2 * ca, -a2 * cg, -c2, z, a2)

    # det(Q1 + lam Q2) = 0 -> cubic in lam
    def det3(M):
        return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                                - M[..., 1, 2] * M[..., 2, 1])
                - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                                  - M[..., 1, 2] * M[..., 2, 0])
                + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                                  - M[..., 1, 1] * M[..., 2, 0]))

    d0 = det3(Q1)
    d3 = det3(Q2)
    # interpolate to get the middle coefficients: det(Q1 + t Q2) at
    # t = 1, -1 gives linear system for c1, c2
    dp = det3(Q1 + Q2)
    dm = det3(Q1 - Q2)
    c1 = (dp - dm) / 2.0 - d3
    c2_ = (dp + dm) / 2.0 - d0
    lam, real = _cubic_roots(d3, c2_, c1, d0)          # [..., 3]
    # use the first real root (any root of the cubic works in theory)
    lam0 = jnp.take_along_axis(
        jnp.where(real, lam, jnp.nan),
        jnp.argmax(real, axis=-1)[..., None], axis=-1)[..., 0]
    Q = Q1 + lam0[..., None, None] * Q2

    # split the degenerate conic Q (rank 2) into two lines l, m:
    # adj(Q) = -p p^T with p the lines' intersection; D = Q + [p]x has
    # rank-1 rows/cols proportional to the two lines.
    def adj3(M):
        c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
        c01 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
        c02 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
        c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
        c12 = M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1]
        c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
        r0 = jnp.stack([c00, c01, c02], -1)
        r1 = jnp.stack([c01, c11, c12], -1)
        r2 = jnp.stack([c02, c12, c22], -1)
        return jnp.stack([r0, r1, r2], -2)

    B = adj3(Q)
    diag = -jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], -1)
    i_best = jnp.argmax(diag, axis=-1)
    di = jnp.take_along_axis(diag, i_best[..., None], -1)[..., 0]
    di = jnp.sqrt(jnp.maximum(di, 1e-30))
    p = jnp.take_along_axis(
        B, i_best[..., None, None].repeat(3, -2), -1)[..., 0] / di[..., None]
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    Px = jnp.stack([
        jnp.stack([z, -pz, py], -1),
        jnp.stack([pz, z, -px], -1),
        jnp.stack([-py, px, z], -1)], -2)
    D = Q + Px
    # pick the row/column with the largest norm: row -> line l, col -> m
    rn = jnp.sum(D * D, -1)
    ri = jnp.argmax(rn, -1)
    l_line = jnp.take_along_axis(D, ri[..., None, None].repeat(3, -1),
                                 -2)[..., 0, :]
    cn = jnp.sum(D * D, -2)
    ci = jnp.argmax(cn, -1)
    m_line = jnp.take_along_axis(D, ci[..., None, None].repeat(3, -2),
                                 -1)[..., 0]

    # intersect each line with conic (ii) (parameterize u by v or v by u)
    def line_conic(line):
        """Solve conic(ii)=0 on the line lu*u + lv*v + lw = 0.

        Returns two (u, v) solutions [..., 2, 2]."""
        lu, lv, lw = line[..., 0], line[..., 1], line[..., 2]
        # choose substitution by the larger coefficient
        use_u = jnp.abs(lu) >= jnp.abs(lv)
        # u = -(lv v + lw)/lu   OR  v = -(lu u + lw)/lv
        A = Q2[..., 0, 0]
        Bq = 2 * Q2[..., 0, 1]
        Cq = Q2[..., 1, 1]
        Dq = 2 * Q2[..., 0, 2]
        Eq = 2 * Q2[..., 1, 2]
        Fq = Q2[..., 2, 2]
        lus = jnp.where(jnp.abs(lu) < 1e-30, 1e-30, lu)
        lvs = jnp.where(jnp.abs(lv) < 1e-30, 1e-30, lv)
        # substitute u = alpha v + beta (alpha = -lv/lu, beta = -lw/lu)
        al_u = -lv / lus
        be_u = -lw / lus
        qa_u = A * al_u ** 2 + Bq * al_u + Cq
        qb_u = 2 * A * al_u * be_u + Bq * be_u + Dq * al_u + Eq
        qc_u = A * be_u ** 2 + Dq * be_u + Fq
        # substitute v = alpha u + beta (alpha = -lu/lv, beta = -lw/lv)
        al_v = -lu / lvs
        be_v = -lw / lvs
        qa_v = Cq * al_v ** 2 + Bq * al_v + A
        qb_v = 2 * Cq * al_v * be_v + Bq * be_v + Eq * al_v + Dq
        qc_v = Cq * be_v ** 2 + Eq * be_v + Fq
        qa = jnp.where(use_u, qa_u, qa_v)
        qb = jnp.where(use_u, qb_u, qb_v)
        qc = jnp.where(use_u, qc_u, qc_v)
        disc = qb * qb - 4 * qa * qc
        ok = (disc >= 0) & (jnp.abs(qa) > 1e-30)
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        qas = jnp.where(jnp.abs(qa) < 1e-30, 1e-30, qa)
        r1 = (-qb + sq) / (2 * qas)
        r2 = (-qb - sq) / (2 * qas)
        outs = []
        for r in (r1, r2):
            u_u = al_u * r + be_u      # if use_u: param is v
            v_v = al_v * r + be_v      # if not: param is u
            uu = jnp.where(use_u, u_u, r)
            vv = jnp.where(use_u, r, v_v)
            outs.append(jnp.stack([uu, vv], -1))
        return jnp.stack(outs, -2), jnp.stack([ok, ok], -1)

    uv_l, ok_l = line_conic(l_line)
    uv_m, ok_m = line_conic(m_line)
    uv = jnp.concatenate([uv_l, uv_m], axis=-2)           # [..., 4, 2]
    okq = jnp.concatenate([ok_l, ok_m], axis=-1)          # [..., 4]

    u = uv[..., 0]
    v = uv[..., 1]
    den1 = 1.0 + u * u - 2.0 * u * cg[..., None]
    den1 = jnp.where(jnp.abs(den1) < 1e-30, 1e-30, den1)
    s1 = jnp.sqrt(jnp.maximum(c2[..., None] / den1, 0.0))
    s2 = u * s1
    s3 = v * s1
    ok = okq & (s1 > 0) & (s2 > 0) & (s3 > 0) & jnp.isfinite(u) \
        & jnp.isfinite(v)

    cam1 = s1[..., None] * f1[..., None, :]
    cam2 = s2[..., None] * f2[..., None, :]
    cam3 = s3[..., None] * f3[..., None, :]
    cam = jnp.stack([cam1, cam2, cam3], axis=-2)
    worldr = jnp.broadcast_to(world[..., None, :, :], cam.shape)
    R, t = rigid_from_three_points(worldr.astype(jnp.float32),
                                   cam.astype(jnp.float32))
    return R.astype(dtype), t.astype(dtype), ok


def pnp_dlt(world, obs):
    """DLT PnP for N>=6 points (PoseFromPairLinear6 analog).

    world: [..., N, 3]; obs: [..., N, 2] normalized coords.  Returns
    (R, t) camera-from-world with R projected onto SO(3).
    """
    world = world.astype(jnp.float64)
    obs = obs.astype(jnp.float64)
    X, Y, Z = world[..., 0], world[..., 1], world[..., 2]
    x, y = obs[..., 0], obs[..., 1]
    z = jnp.zeros_like(X)
    o = jnp.ones_like(X)
    r1 = jnp.stack([X, Y, Z, o, z, z, z, z, -x * X, -x * Y, -x * Z, -x], axis=-1)
    r2 = jnp.stack([z, z, z, z, X, Y, Z, o, -y * X, -y * Y, -y * Z, -y], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # [..., 2N, 12]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w, v = jnp.linalg.eigh(AtA)
    p = v[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    # fix sign: points should have positive depth
    Xh = jnp.concatenate([world, jnp.ones_like(world[..., :1])], axis=-1)
    depth = jnp.einsum("...j,...nj->...n", P[..., 2, :], Xh)
    sign = jnp.where(jnp.mean(jnp.sign(depth), axis=-1, keepdims=True) < 0, -1.0, 1.0)
    P = P * sign[..., None]
    M = P[..., :3]
    # scale so that R has unit determinant-ish: use norm of third row
    scale = jnp.linalg.norm(M[..., 2, :], axis=-1)
    M = M / scale[..., None, None]
    t = P[..., 3] / scale[..., None]
    R = se3.project_to_so3(M)
    return R, t


def epnp(world, obs, refine_iterations: int = 10):
    """EPnP (PnPLepetitEPnP.java:104 analog): O(N) PnP via 4 control
    points.

    world: [N, 3], obs: [N, 2] normalized coords.  The 12x12 normal
    matrix of the control-point system is eigendecomposed; the null-space
    dimension-1 and -2 cases are solved from the inter-control-point
    distance constraints and the better (by reprojection) seeds a GN
    polish — the reference's relinearization step is replaced by the same
    full GN refine it applies afterwards anyway.  Returns (R, t).
    """
    world = world.astype(jnp.float64)
    obs = obs.astype(jnp.float64)
    n = world.shape[0]

    # control points: centroid + principal axes (Lepetit eq. 2 choice)
    c0 = jnp.mean(world, axis=0)
    dev = world - c0
    cov = dev.T @ dev / n
    w_eig, v_eig = jnp.linalg.eigh(cov)
    scale = jnp.sqrt(jnp.maximum(w_eig, 1e-12))
    ctrl = jnp.concatenate([c0[None],
                            c0[None] + (v_eig * scale[None, :]).T], axis=0)

    # barycentric coordinates: [4] per point with sum = 1
    Cmat = jnp.concatenate([ctrl.T, jnp.ones((1, 4), jnp.float64)], axis=0)
    rhs = jnp.concatenate([world.T, jnp.ones((1, n), jnp.float64)], axis=0)
    # normal-equations solve via eigh (written for a first target without
    # f64 LU; see smalllinalg); Cmat is well-conditioned by the
    # principal-axes control-point choice
    from boofcv_tpu.geo.smalllinalg import inv_spd, solve33
    alpha = (inv_spd(Cmat.T @ Cmat) @ (Cmat.T @ rhs)).T     # [N, 4]

    # M x = 0 with x = camera coords of the 4 control points (12 vector)
    u = obs[:, 0]
    v = obs[:, 1]
    zero = jnp.zeros_like(alpha)
    row_x = jnp.stack([alpha, zero, -alpha * u[:, None]],
                      axis=-1).reshape(n, 12)
    row_y = jnp.stack([zero, alpha, -alpha * v[:, None]],
                      axis=-1).reshape(n, 12)
    M = jnp.concatenate([row_x, row_y], axis=0)             # [2N, 12]
    MtM = M.T @ M
    _, V = jnp.linalg.eigh(MtM)
    v1 = V[:, 0].reshape(4, 3)
    v2 = V[:, 1].reshape(4, 3)

    iu, ju = jnp.triu_indices(4, k=1)
    dw = jnp.linalg.norm(ctrl[iu] - ctrl[ju], axis=1)       # [6] world dists

    def pose_from_ctrl(cc):
        """Camera control points -> (R, t) with cheirality fix."""
        cam = alpha @ cc
        sign = jnp.where(jnp.mean(cam[:, 2]) < 0, -1.0, 1.0)
        return absolute_orientation(world, cam * sign)

    # case N=1: x = beta v1, beta from matching distances
    d1 = jnp.linalg.norm(v1[iu] - v1[ju], axis=1)
    beta1 = jnp.sum(d1 * dw) / jnp.maximum(jnp.sum(d1 * d1), 1e-30)
    Ra, ta = pose_from_ctrl(beta1 * v1)

    # case N=2: x = b1 v1 + b2 v2; 6 distance constraints linear in
    # (b1^2, b1 b2, b2^2)
    e1 = v1[iu] - v1[ju]
    e2 = v2[iu] - v2[ju]
    L = jnp.stack([jnp.sum(e1 * e1, 1), 2 * jnp.sum(e1 * e2, 1),
                   jnp.sum(e2 * e2, 1)], axis=1)            # [6, 3]
    bb = solve33(L.T @ L, L.T @ (dw * dw))
    b1 = jnp.sqrt(jnp.maximum(bb[0], 1e-30))
    b2 = jnp.sign(bb[1]) * jnp.sqrt(jnp.maximum(bb[2], 0.0))
    Rb, tb = pose_from_ctrl(b1 * v1 + b2 * v2)

    err_a = jnp.sum(jnp.where(jnp.isfinite(
        reprojection_error_sq(Ra, ta, world, obs)),
        reprojection_error_sq(Ra, ta, world, obs), 1e12))
    err_b = jnp.sum(jnp.where(jnp.isfinite(
        reprojection_error_sq(Rb, tb, world, obs)),
        reprojection_error_sq(Rb, tb, world, obs), 1e12))
    better = err_a <= err_b
    R = jnp.where(better, Ra, Rb)
    t = jnp.where(better, ta, tb)
    if refine_iterations > 0:
        R, t = gauss_newton_pose(R, t, world, obs,
                                 iterations=refine_iterations)
    return R, t


def pnp_planar(world_xy, obs, refine_iterations: int = 10):
    """Planar PnP (IPPE use-case, alg/geo/pose/IPPE_to_EstimatePnP /
    Zhang99DecomposeHomography analog): pose from N>=4 coplanar points.

    world_xy: [N, 2] plane coordinates (world z = 0); obs: [N, 2]
    normalized image coords.  The plane->image homography H = [r1 r2 t]
    is decomposed directly (no K: obs are normalized) and polished with
    the same GN refine the reference's IPPE wrapper applies.  Returns
    (R, t) camera-from-world.
    """
    from boofcv_tpu.geo.epipolar import homography_dlt
    world_xy = world_xy.astype(jnp.float64)
    obs = obs.astype(jnp.float64)
    H = homography_dlt(world_xy, obs)
    s = 1.0 / jnp.linalg.norm(H[:, 0])
    s = jnp.where(H[2, 2] * s < 0, -s, s)   # points must sit in front
    r1 = H[:, 0] * s
    r2 = H[:, 1] * s
    r3 = jnp.cross(r1, r2)
    t = H[:, 2] * s
    R = se3.project_to_so3(jnp.stack([r1, r2, r3], axis=1))
    world3 = jnp.concatenate([world_xy, jnp.zeros_like(world_xy[:, :1])], 1)
    return refine_pnp(R, t, world3, obs, iterations=refine_iterations)


def reprojection_error_sq(R, t, world, obs):
    """Squared reprojection error in normalized image coords, batched.

    R: [..., 3, 3], t: [..., 3], world: [..., N, 3], obs: [..., N, 2].
    Returns [..., N].  (PnPDistanceReprojectionSq analog; behind-camera
    points get +inf as the reference marks them unusable.)
    """
    Xc = world @ jnp.swapaxes(R, -1, -2) + t[..., None, :]
    zc = Xc[..., 2]
    proj = Xc[..., :2] / jnp.where(jnp.abs(zc) < 1e-12, 1e-12, zc)[..., None]
    err = jnp.sum((proj - obs) ** 2, axis=-1)
    return jnp.where(zc <= 0, jnp.inf, err)


def _gn_pose_loop(R, t, world, obs, wgt, iterations, damping, dtype,
                  step_tol):
    """One precision tier of the GN pose loop (see gauss_newton_pose)."""
    world = world.astype(dtype)
    obs = obs.astype(dtype)
    wgt = wgt.astype(dtype)
    damping = jnp.asarray(damping, dtype)

    def body(state):
        R0, t0 = state
        Xc = world @ R0.T + t0
        z = jnp.where(jnp.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
        inv_z = 1.0 / z
        x = Xc[..., 0] * inv_z
        y = Xc[..., 1] * inv_z
        r = jnp.stack([x, y], -1) - obs                    # [N, 2]
        # J = dproj/dXc @ [-hat(Xc) | I]  -> [N, 2, 6]
        zeros = jnp.zeros_like(inv_z)
        # dproj/dXc rows [1/z, 0, -x/z], [0, 1/z, -y/z]; rotation block
        # dproj/dw = dproj/dXc @ (-hat(Xc)) in closed form:
        jw_x = jnp.stack([-x * y, 1.0 + x * x, -y], -1)    # d x / dw
        jw_y = jnp.stack([-(1.0 + y * y), x * y, x], -1)   # d y / dw
        jv_x = jnp.stack([inv_z, zeros, -x * inv_z], -1)
        jv_y = jnp.stack([zeros, inv_z, -y * inv_z], -1)
        Jx = jnp.concatenate([jw_x, jv_x], -1)             # [N, 6]
        Jy = jnp.concatenate([jw_y, jv_y], -1)
        J = jnp.stack([Jx, Jy], 1)                         # [N, 2, 6]
        w2 = wgt[:, None]
        H = jnp.einsum("nij,nik->jk", J * w2[..., None], J,
                       precision=jax.lax.Precision.HIGHEST)
        g = jnp.einsum("nij,ni->j", J, r * w2,
                       precision=jax.lax.Precision.HIGHEST)
        H = H + damping * jnp.eye(6, dtype=dtype)
        L6 = jnp.linalg.cholesky(H)
        y6 = jax.scipy.linalg.solve_triangular(L6, g, lower=True)
        dx = -jax.scipy.linalg.solve_triangular(L6.T, y6, lower=False)
        dR, dt = se3.exp_se3(dx)
        Rn, tn = se3.compose(dR, dt, R0, t0)
        return Rn, tn, jnp.max(jnp.abs(dx))

    # early exit once the step stalls: GN on reprojection converges
    # quadratically, typically 3-4 iterations
    def cond(state):
        it, _, _, step = state
        return (it < iterations) & (step > step_tol)

    def wbody(state):
        it, R0, t0, _ = state
        Rn, tn, step = body((R0, t0))
        return it + 1, Rn, tn, step

    _, R, t, _ = jax.lax.while_loop(
        cond, wbody, (jnp.int32(0), R.astype(dtype),
                      t.astype(dtype), jnp.asarray(1.0, dtype)))
    return R, t


def gauss_newton_pose(R, t, world, obs, weights=None, iterations: int = 10,
                      damping: float = 1e-8, polish_iterations: int = 2):
    """Weighted GN pose refinement with the ANALYTIC reprojection
    Jacobian (left-perturbation: Xc' = exp(w)Xc + v, so
    dXc/d(w,v) = [-hat(Xc) | I] and dproj/dXc is the standard pinhole
    2x3) — one residual pass per iteration instead of jacfwd's six
    tangent passes.

    Mixed precision: the convergence iterations run in f32 (f64 is
    several times slower on accelerators) — GN's quadratic convergence
    reaches f32 machine accuracy in 3-4 steps — then
    ``polish_iterations`` full-f64 steps land the solution at f64
    accuracy (each f64 step squares the error of the f32 estimate).
    Set ``polish_iterations=iterations`` to force the all-f64 path.
    """
    if weights is None:
        weights = jnp.ones(world.shape[:-1], jnp.float64)
    fast_iters = iterations - polish_iterations
    if fast_iters > 0:
        R, t = _gn_pose_loop(R, t, world, obs, weights, fast_iters,
                             max(damping, 1e-12), jnp.float32, 1e-6)
        # the f32 loop leaves R orthogonal only to ~1e-7, and exp-update
        # composition preserves that off-manifold error forever (GN then
        # floors at 1e-7).  Newton polar iteration R(3I - R^T R)/2 restores
        # orthogonality quadratically — two steps reach f64 accuracy —
        # without SVD.
        R = R.astype(jnp.float64)
        for _ in range(2):
            R = R @ (1.5 * jnp.eye(3, dtype=jnp.float64) - 0.5 * (R.T @ R))
    if polish_iterations > 0:
        R, t = _gn_pose_loop(R, t, world, obs, weights,
                             min(polish_iterations, iterations),
                             damping, jnp.float64, 1e-14)
    return R.astype(jnp.float64), t.astype(jnp.float64)


def refine_pnp(R, t, world, obs, iterations: int = 10, damping: float = 1e-8):
    """Gauss-Newton refinement of (R, t) minimizing reprojection error.

    Replaces the reference's ddogleg LM refiner (PnPRefineRodrigues).
    world: [N, 3], obs: [N, 2] normalized coords.  Runs a fixed number of
    iterations (static shape); each iteration is one 6x6 solve.
    """
    return gauss_newton_pose(R, t, world, obs, iterations=iterations,
                             damping=damping)
