"""Epipolar geometry: Fundamental / Essential / Homography estimation.

Reference analog: boofcv-geo alg/geo/f/ (FundamentalLinear8.java,
FundamentalLinear7.java, EssentialNister5.java), alg/geo/h/
(HomographyDirectLinearTransform.java), and the residuals in
alg/geo/f/FundamentalResidualSampson.java / DistanceEpipolarConstraint.

Design: every solver is written over a *batch* of minimal sample sets
(leading axis = RANSAC hypotheses), so K hypotheses are solved as one
batched SVD/eig — the hypothesis-parallel RANSAC sweet spot (SURVEY §2.4
"robust estimation glue").  All solvers run in f64 (conditioning), points
are Hartley-normalized internally as in the reference's
LowLevelMultiViewOps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def normalize_points(pts):
    """Hartley normalization: [..., N, 2] -> (normed, T [3,3]).

    T maps raw pixels to zero-mean, sqrt(2)-mean-radius coordinates
    (LowLevelMultiViewOps.computeNormalization).
    """
    pts = pts.astype(jnp.float64)
    mean = jnp.mean(pts, axis=-2, keepdims=True)
    centered = pts - mean
    # reference uses per-axis stdev normalization
    std = jnp.std(centered, axis=-2, keepdims=True) + 1e-12
    normed = centered / std
    sx = 1.0 / std[..., 0, 0]
    sy = 1.0 / std[..., 0, 1]
    cx = mean[..., 0, 0]
    cy = mean[..., 0, 1]
    z = jnp.zeros_like(sx)
    o = jnp.ones_like(sx)
    T = jnp.stack([
        jnp.stack([sx, z, -sx * cx], axis=-1),
        jnp.stack([z, sy, -sy * cy], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ], axis=-2)
    return normed, T


def _epipolar_design(p1, p2):
    """Rows x2^T F x1 = 0: [..., N, 9] for F in row-major flatten order."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    return jnp.stack([x2 * x1, x2 * y1, x2,
                      y2 * x1, y2 * y1, y2,
                      x1, y1, o], axis=-1)


def _smallest_singular_vector(A):
    """Right singular vector of least singular value: [..., M, 9] -> [..., 9].

    Uses eigh of A^T A (symmetric 9x9) — batched, f64.
    """
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w, v = jnp.linalg.eigh(AtA)
    return v[..., :, 0]  # eigh sorts ascending


def _nullspace2(A):
    """Two right singular vectors of the two smallest singular values."""
    AtA = jnp.swapaxes(A, -1, -2) @ A
    w, v = jnp.linalg.eigh(AtA)
    return v[..., :, 0], v[..., :, 1]


def fundamental_8pt(p1, p2, weights=None):
    """Normalized 8-point fundamental matrix (FundamentalLinear8.java).

    p1, p2: [..., N>=8, 2] pixel coords.  Returns [..., 3, 3] with rank-2
    constraint enforced, denormalized, scaled so ||F||=1.  ``weights``
    ([..., N], e.g. an inlier mask) scales the design rows — used for the
    local-optimization refit after RANSAC.
    """
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    A = _epipolar_design(n1, n2)
    if weights is not None:
        A = A * weights.astype(A.dtype)[..., None]
    f = _smallest_singular_vector(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    # enforce rank 2
    U, s, Vt = jnp.linalg.svd(F)
    s = s.at[..., 2].set(0.0)
    F = (U * s[..., None, :]) @ Vt
    F = jnp.swapaxes(T2, -1, -2) @ F @ T1
    norm = jnp.linalg.norm(F, axis=(-2, -1), keepdims=True)
    return F / jnp.where(norm == 0, 1.0, norm)


def _cubic_roots(a3, a2, a1, a0):
    """Real cubic roots — closed-form Cardano (no batched eigvals on
    the accelerator; see smalllinalg).  Returns (roots [..., 3], real_mask [..., 3])."""
    from boofcv_tpu.geo.smalllinalg import cubic_roots
    return cubic_roots(a3, a2, a1, a0)


def fundamental_7pt(p1, p2):
    """7-point fundamental (FundamentalLinear7.java): up to 3 solutions.

    p1, p2: [..., 7, 2].  Returns (F [..., 3, 3, 3], valid [..., 3]) — the
    three candidate matrices with a validity mask (cubic real roots).
    """
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    A = _epipolar_design(n1, n2)
    f1, f2 = _nullspace2(A)
    F1 = f1.reshape(f1.shape[:-1] + (3, 3))
    F2 = f2.reshape(f2.shape[:-1] + (3, 3))

    # det(a*F1 + (1-a)*F2) = 0 -> cubic in a.  Build coefficients by
    # evaluating the determinant at 4 points and interpolating (numerically
    # stable and avoids symbolic expansion).
    def det_at(t):
        return jnp.linalg.det(t * F1 + (1.0 - t) * F2)

    d0 = det_at(0.0)
    d1 = det_at(1.0)
    dm = det_at(-1.0)
    d2 = det_at(2.0)
    # p(t)=c3 t^3+c2 t^2+c1 t+c0 with p(0)=d0,p(1)=d1,p(-1)=dm,p(2)=d2
    # p(1)+p(-1): 2c2 + 2c0;  p(2) - [p(1)-p(-1)] elimination gives c3
    # (verified: the interpolated cubic reproduces det() to ~1e-16; the
    # previous c3 formula was off by (d0-d1)/3, so the "roots" left
    # det(F) ~ 0.03 and no returned candidate was rank-2)
    c0 = d0
    c2 = (d1 + dm) / 2.0 - d0
    c3 = (d2 + 3.0 * d0 - 3.0 * d1 - dm) / 6.0
    c1 = d1 - d0 - c2 - c3
    roots, real = _cubic_roots(c3, c2, c1, c0)

    a = roots[..., :, None, None]  # [..., 3, 1, 1]
    F = a * F1[..., None, :, :] + (1.0 - a) * F2[..., None, :, :]
    F = jnp.swapaxes(T2, -1, -2)[..., None, :, :] @ F @ T1[..., None, :, :]
    norm = jnp.linalg.norm(F, axis=(-2, -1), keepdims=True)
    F = F / jnp.where(norm == 0, 1.0, norm)
    return F, real


def essential_8pt(p1, p2, weights=None):
    """Essential matrix from >=8 *normalized image coords* via the linear
    solver + projection onto the essential manifold (sigma=(1,1,0)).

    The reference exposes Nister-5pt for minimal sets; for hypothesis-
    parallel RANSAC an 8-point minimal set with exact manifold projection
    is equally usable and far more regular in shape.  p1, p2: [..., N>=8, 2]
    in normalized (K^-1) coordinates.  ``weights`` scales design rows
    (inlier-mask refits).
    """
    A = _epipolar_design(p1.astype(jnp.float64), p2.astype(jnp.float64))
    if weights is not None:
        A = A * weights.astype(A.dtype)[..., None]
    e = _smallest_singular_vector(A)
    E = e.reshape(e.shape[:-1] + (3, 3))
    U, s, Vt = jnp.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    s_new = jnp.stack([sm, sm, jnp.zeros_like(sm)], axis=-1)
    return (U * s_new[..., None, :]) @ Vt


def sampson_error(F, p1, p2):
    """First-order geometric (Sampson) distance^2 per point.

    F: [..., 3, 3]; p1, p2: [..., N, 2].  Returns [..., N]
    (FundamentalResidualSampson.java).
    """
    ones = jnp.ones_like(p1[..., :1])
    x1 = jnp.concatenate([p1, ones], axis=-1)
    x2 = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)
    Fx1 = x1 @ jnp.swapaxes(F, -1, -2)   # [..., N, 3] = (F @ x1)
    Ftx2 = x2 @ F                          # [..., N, 3] = (F^T @ x2)
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-30)


def epipolar_constraint(F, p1, p2):
    """|x2^T F x1| per point (DistanceEpipolarConstraint)."""
    ones = jnp.ones_like(p1[..., :1])
    x1 = jnp.concatenate([p1, ones], axis=-1)
    x2 = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)
    Fx1 = x1 @ jnp.swapaxes(F, -1, -2)
    return jnp.abs(jnp.sum(x2 * Fx1, axis=-1))


def homography_dlt(p1, p2):
    """N>=4-point homography DLT (HomographyDirectLinearTransform.java).

    p1, p2: [..., N, 2]; returns [..., 3, 3] with H[2,2] ~ 1 scaling.
    """
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([-x, -y, -o, z, z, z, u * x, u * y, u], axis=-1)
    r2 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)
    h = _smallest_singular_vector(A)
    H = h.reshape(h.shape[:-1] + (3, 3))
    from boofcv_tpu.geo.smalllinalg import inv3
    H = inv3(T2) @ H @ T1
    scale = H[..., 2:3, 2:3]
    return H / jnp.where(jnp.abs(scale) < 1e-12, 1.0, scale)


def homography_transfer_error(H, p1, p2):
    """Symmetric-ish forward transfer error^2 per point."""
    ones = jnp.ones_like(p1[..., :1])
    x1 = jnp.concatenate([p1, ones], axis=-1)
    Hx = x1 @ jnp.swapaxes(H, -1, -2)
    w = Hx[..., 2]
    proj = Hx[..., :2] / jnp.where(jnp.abs(w) < 1e-12, 1.0, w)[..., None]
    return jnp.sum((proj - p2) ** 2, axis=-1)


def essential_from_fundamental(F, K1, K2):
    """E = K2^T F K1 (MultiViewOps)."""
    return jnp.swapaxes(K2, -1, -2) @ F @ K1


def fundamental_from_essential(E, K1, K2):
    from boofcv_tpu.geo.smalllinalg import inv3
    return inv3(jnp.swapaxes(K2, -1, -2)) @ E @ inv3(K1)


def decompose_essential(E):
    """E -> 4 candidate (R, t) (DecomposeEssential.java).

    Returns R: [..., 4, 3, 3], t: [..., 4, 3] (unit translation).
    """
    U, s, Vt = jnp.linalg.svd(E)
    # make proper rotations
    detU = jnp.linalg.det(U)
    detV = jnp.linalg.det(jnp.swapaxes(Vt, -1, -2))
    U = U * jnp.where(detU < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * jnp.where(detV < 0, -1.0, 1.0)[..., None, None]
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  dtype=E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    R4 = jnp.stack([Ra, Ra, Rb, Rb], axis=-3)
    t4 = jnp.stack([t, -t, t, -t], axis=-2)
    return R4, t4


def select_pose_cheirality(R4, t4, p1, p2):
    """Pick the (R, t) with most points in front of both cameras.

    p1, p2: [N, 2] normalized coords.  Returns (R [3,3], t [3], best_idx).
    Uses the midpoint-free linear two-view triangulation per candidate.
    """
    from boofcv_tpu.geo.triangulate import triangulate_two_view_linear

    def count(R, t):
        X = triangulate_two_view_linear(p1, p2, R, t)
        z1 = X[..., 2]
        X2 = X @ jnp.swapaxes(R, -1, -2) + t
        z2 = X2[..., 2]
        return jnp.sum((z1 > 0) & (z2 > 0), axis=-1)

    if R4.ndim == 3:
        counts = jax.vmap(count, in_axes=(0, 0))(R4, t4)
        best = jnp.argmax(counts)
        return R4[best], t4[best], best
    # batched candidates [..., 4, 3, 3]: select per batch element (the
    # old flattened argmax indexed the wrong axis)
    lead = R4.shape[:-3]
    Rf = R4.reshape((-1, 4, 3, 3))
    tf = t4.reshape((-1, 4, 3))
    Rb, tb, bb = jax.vmap(
        lambda R_, t_: select_pose_cheirality(R_, t_, p1, p2))(Rf, tf)
    return (Rb.reshape(lead + (3, 3)), tb.reshape(lead + (3,)),
            bb.reshape(lead))


def epipoles_from_fundamental(F):
    """Left/right epipoles (null vectors of F / F^T): F e1 = 0,
    F^T e2 = 0 (MultiViewOps.extractEpipoles analog).  Returns
    (e1 [3], e2 [3]) homogeneous."""
    F = F.astype(jnp.float64)
    _, _, Vt = jnp.linalg.svd(F)
    e1 = Vt[-1]
    _, _, Vt2 = jnp.linalg.svd(F.T)
    e2 = Vt2[-1]
    return e1, e2


def cameras_from_fundamental(F):
    """Canonical projective camera pair from F
    (MultiViewOps.fundamentalToProjective / F->P):
    P1 = [I | 0], P2 = [[e2]x F | e2].  Returns (P1 [3,4], P2 [3,4])."""
    F = F.astype(jnp.float64)
    _, e2 = epipoles_from_fundamental(F)
    ex = jnp.array([[0.0, -e2[2], e2[1]],
                    [e2[2], 0.0, -e2[0]],
                    [-e2[1], e2[0], 0.0]], jnp.float64)
    P1 = jnp.concatenate([jnp.eye(3, dtype=jnp.float64),
                          jnp.zeros((3, 1), jnp.float64)], axis=1)
    P2 = jnp.concatenate([ex @ F, e2[:, None]], axis=1)
    return P1, P2


# ---------------------------------------------------------------------------
# Nister 5-point essential solver
# ---------------------------------------------------------------------------
# Reference: boofcv-geo alg/geo/f/EssentialNister5.java:62 (+ SymPy generator
# main/boofcv-geo/src/generate/python/nister5.py).  Design: instead of
# symbolically expanded coefficient code, the ten cubic constraint
# polynomials are expanded NUMERICALLY by evaluating them at 20 fixed sample
# points and interpolating over the 20 cubic monomials (one small matmul —
# exact for polynomials, batched over all RANSAC hypotheses).  The action of
# Nister's Gauss-Jordan elimination is a batched 10x10 solve; the degree-10
# determinant polynomial's roots come from a batched Durand-Kerner iteration
# (smalllinalg.poly_roots) since XLA has no general eigvals on the
# accelerator.

# Nister's monomial order: x3 y3 x2y xy2 x2z x2 y2z y2 xyz xy |
#                          xz2 xz x yz2 yz y z3 z2 z 1
_N5_POWERS = np.array([
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0), (1, 0, 2), (1, 0, 1),
    (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0), (0, 0, 3), (0, 0, 2),
    (0, 0, 1), (0, 0, 0)], dtype=np.float64)

def _n5_sample_points():
    rng = np.random.default_rng(42)
    # well-spread sample points in [-1,1]^3; fixed once, shared by all calls
    for _ in range(64):
        pts = rng.uniform(-1.0, 1.0, size=(20, 3))
        V = np.prod(pts[:, None, :] ** _N5_POWERS[None, :, :], axis=-1)
        if np.linalg.cond(V) < 5e3:
            return pts, np.linalg.inv(V)
    raise RuntimeError("could not condition Nister interpolation points")

_N5_PTS, _N5_VINV = _n5_sample_points()


def _polymul(a, b):
    """[..., m] x [..., n] -> [..., m+n-1], highest-degree-first coeffs."""
    m = a.shape[-1]
    n = b.shape[-1]
    out = jnp.zeros(a.shape[:-1] + (m + n - 1,), dtype=a.dtype)
    for i in range(m):
        out = out.at[..., i:i + n].add(a[..., i:i + 1] * b)
    return out


def essential_nister5(p1, p2):
    """Nister 5-point essential matrix: up to 10 solutions per sample.

    p1, p2: [..., 5, 2] *normalized* (K^-1) image coordinates.
    Returns (E [..., 10, 3, 3], valid [..., 10]).  Batched over any
    leading hypothesis axes (EssentialNister5.java:62 analog).
    """
    p1 = p1.astype(jnp.float64)
    p2 = p2.astype(jnp.float64)
    A = _epipolar_design(p1, p2)                       # [..., 5, 9]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, v = jnp.linalg.eigh(AtA)
    # 4-dim nullspace basis -> E(x,y,z) = x E1 + y E2 + z E3 + E4
    Es = jnp.stack([v[..., :, i] for i in range(4)], axis=-2)
    Es = Es.reshape(Es.shape[:-1] + (3, 3))            # [..., 4, 3, 3]

    # evaluate the 10 constraints at the 20 interpolation points
    pts = jnp.asarray(_N5_PTS)                         # [20, 3]
    coef = jnp.concatenate([pts, jnp.ones((20, 1), dtype=pts.dtype)], axis=-1)
    Epts = jnp.einsum('sk,...kij->...sij', coef, Es)   # [..., 20, 3, 3]
    det = (Epts[..., 0, 0] * (Epts[..., 1, 1] * Epts[..., 2, 2]
                              - Epts[..., 1, 2] * Epts[..., 2, 1])
           - Epts[..., 0, 1] * (Epts[..., 1, 0] * Epts[..., 2, 2]
                                - Epts[..., 1, 2] * Epts[..., 2, 0])
           + Epts[..., 0, 2] * (Epts[..., 1, 0] * Epts[..., 2, 1]
                                - Epts[..., 1, 1] * Epts[..., 2, 0]))
    EEt = Epts @ jnp.swapaxes(Epts, -1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    trace_con = 2.0 * (EEt @ Epts) - tr[..., None, None] * Epts
    P = jnp.concatenate([det[..., None, :],
                         jnp.swapaxes(trace_con.reshape(
                             trace_con.shape[:-2] + (9,)), -1, -2)],
                        axis=-2)                       # [..., 10, 20]
    C = P @ jnp.asarray(_N5_VINV).T                    # [..., 10, 20] coeffs

    # Gauss-Jordan: G = C1^-1 C2 over the last 10 monomials
    C1 = C[..., :, :10]
    C2 = C[..., :, 10:]
    # QR + triangular solve instead of linalg.solve (written for a first
    # target without f64 LU; ROADMAP D4)
    Q, Rq = jnp.linalg.qr(C1)
    G = jax.lax.linalg.triangular_solve(
        Rq, jnp.swapaxes(Q, -1, -2) @ C2, left_side=True, lower=False)

    # rows e..j (leading monomials x2z, x2, y2z, y2, xyz, xy) give
    # B(z) [x y 1]^T = 0 with  k=<e>-z<f>, l=<g>-z<h>, m=<i>-z<j>
    def row_pair(ei, fi):
        e = G[..., ei, :]
        f = G[..., fi, :]
        bx = jnp.stack([-f[..., 0], e[..., 0] - f[..., 1],
                        e[..., 1] - f[..., 2], e[..., 2]], axis=-1)
        by = jnp.stack([-f[..., 3], e[..., 3] - f[..., 4],
                        e[..., 4] - f[..., 5], e[..., 5]], axis=-1)
        b1 = jnp.stack([-f[..., 6], e[..., 6] - f[..., 7],
                        e[..., 7] - f[..., 8], e[..., 8] - f[..., 9],
                        e[..., 9]], axis=-1)
        return bx, by, b1

    rows = [row_pair(4, 5), row_pair(6, 7), row_pair(8, 9)]

    def minor(r_a, r_b):
        # by_a * b1_b - b1_a * by_b  (and the x/1 pairing variants)
        bx_a, by_a, b1_a = rows[r_a]
        bx_b, by_b, b1_b = rows[r_b]
        p1_ = _polymul(by_a, b1_b) - _polymul(b1_a, by_b)   # deg 7 [8]
        p2_ = _polymul(b1_a, bx_b) - _polymul(bx_a, b1_b)   # deg 7 [8]
        p3_ = _polymul(bx_a, by_b) - _polymul(by_a, bx_b)   # deg 6 [7]
        return p1_, p2_, p3_

    m1, m2, m3 = minor(1, 2)
    bx0, by0, b10 = rows[0]
    n_poly = (_polymul(bx0, m1) + _polymul(by0, m2))        # deg 10 [11]
    n3 = _polymul(b10, m3)                                  # deg 10 [11]
    n_poly = n_poly + n3

    from boofcv_tpu.geo.smalllinalg import poly_roots
    zr, zi = poly_roots(n_poly)                             # [..., 10] each
    scale = jnp.max(jnp.abs(n_poly), axis=-1)
    lead_ok = jnp.abs(n_poly[..., 0]) > 1e-10 * scale
    real = jnp.abs(zi) <= 1e-6 * (1.0 + jnp.abs(zr))

    # back-substitute x(z), y(z) from the null vector of B(z)
    def eval_poly(c, z):
        out = jnp.broadcast_to(c[..., 0:1], z.shape).astype(z.dtype)
        for i in range(1, c.shape[-1]):
            out = out * z + c[..., i:i + 1]
        return out

    z = zr
    B = jnp.stack([
        jnp.stack([eval_poly(rows[r][0], z), eval_poly(rows[r][1], z),
                   eval_poly(rows[r][2], z)], axis=-1)
        for r in range(3)], axis=-2)                        # [..., 10, 3, 3]
    c01 = jnp.cross(B[..., 0, :], B[..., 1, :])
    c02 = jnp.cross(B[..., 0, :], B[..., 2, :])
    c12 = jnp.cross(B[..., 1, :], B[..., 2, :])
    cands = jnp.stack([c01, c02, c12], axis=-2)
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    vvec = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    w = vvec[..., 2]
    w_ok = jnp.abs(w) > 1e-12 * (1.0 + jnp.linalg.norm(vvec, axis=-1))
    ws = jnp.where(w_ok, w, 1.0)
    x = vvec[..., 0] / ws
    y = vvec[..., 1] / ws

    xyz1 = jnp.stack([x, y, z, jnp.ones_like(z)], axis=-1)  # [..., 10, 4]
    E = jnp.einsum('...rk,...kij->...rij', xyz1, Es)
    nrm = jnp.linalg.norm(E, axis=(-2, -1), keepdims=True)
    E = E / jnp.where(nrm == 0, 1.0, nrm)
    valid = real & w_ok & lead_ok[..., None] & jnp.all(
        jnp.isfinite(E), axis=(-2, -1))
    # invalid -> NaN: a zero matrix would score a *perfect* (guarded 0/0)
    # Sampson error on every point and win RANSAC; NaN is filtered there.
    E = jnp.where(valid[..., None, None], E, jnp.nan)
    return E, valid
