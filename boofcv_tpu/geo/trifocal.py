"""Trifocal tensor estimation and transfer.

Reference analog: boofcv-geo alg/geo/trifocal/ —
TrifocalLinearPoint7.java (linear 7+ point solve with normalization),
TrifocalTransfer.java (point transfer), TrifocalExtractGeometries.java
(epipoles + camera matrices).

Design: the linear system is one batched [..., 4N, 27] nullspace via
eigh (hypothesis-parallel ready); transfer is einsum algebra.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from boofcv_tpu.geo.epipolar import normalize_points, _smallest_singular_vector


def _design_rows(p1, p2, p3):
    """Linear constraints: for each correspondence, 4 equations
    x2^i x3^j sum_k x1^k T_k - ... = 0 (point-point-point).

    Standard form: for i in {0,1}, l in {0,1}:
      x1^k ( x2^i x3^l T_k[2,2] - x3^l T_k[i,2] - x2^i T_k[2,l] + T_k[i,l] ) = 0
    """
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)  # [..., N, 3]
    x2 = p2
    x3 = p3
    rows = []
    for i in range(2):
        for l in range(2):
            # coefficient for T[k, a, b] flattened k*9 + a*3 + b
            coef = jnp.zeros(p1.shape[:-1] + (27,), jnp.float64)
            for k in range(3):
                base = x1[..., k]
                coef = coef.at[..., k * 9 + 2 * 3 + 2].add(
                    base * x2[..., i] * x3[..., l])
                coef = coef.at[..., k * 9 + i * 3 + 2].add(
                    -base * x3[..., l])
                coef = coef.at[..., k * 9 + 2 * 3 + l].add(
                    -base * x2[..., i])
                coef = coef.at[..., k * 9 + i * 3 + l].add(base)
            rows.append(coef)
    return jnp.concatenate(rows, axis=-2)  # [..., 4N, 27]


def trifocal_linear(p1, p2, p3):
    """Linear trifocal tensor from N>=7 triple correspondences
    (TrifocalLinearPoint7).  p1/p2/p3: [..., N, 2] pixels.
    Returns T [..., 3, 3, 3] (unit Frobenius norm)."""
    n1, T1 = normalize_points(p1)
    n2, T2 = normalize_points(p2)
    n3, T3 = normalize_points(p3)
    A = _design_rows(n1, n2, n3)
    t = _smallest_singular_vector(A)
    T = t.reshape(t.shape[:-1] + (3, 3, 3))
    # denormalize: T'_k = N2^-1 (sum_r N1[r,k] T_r) N3^-T  with N = T mats
    from boofcv_tpu.geo.smalllinalg import inv3
    N2i = inv3(T2)
    N3i = inv3(T3)
    # T_out[k] = N2i @ (sum_r T1[r, k] * T[r]) @ N3i^T
    mix = jnp.einsum("...rk,...rij->...kij", T1, T)
    T_out = jnp.einsum("...ia,...kab,...jb->...kij", N2i, mix, N3i)
    norm = jnp.sqrt(jnp.sum(T_out ** 2, axis=(-3, -2, -1), keepdims=True))
    return T_out / jnp.where(norm == 0, 1.0, norm)


def transfer_1_to_3(T, p1, p2):
    """Point transfer view1+view2 -> view3 (TrifocalTransfer.transfer_1_to_3).

    Using line transfer with a line through x2 perpendicular to... the
    standard method: choose line l2 through x2 (vertical), x3^j ~
    x1^k l2_i T_k[i, j]."""
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    # two candidate lines through x2 — vertical (1, 0, -x2) and
    # horizontal (0, 1, -y2) — and keep, per point, the one whose
    # transferred vector is larger before dehomogenization: a line that
    # (nearly) coincides with x2's epipolar line transfers to ~0 (the
    # reference avoids this by picking the line perpendicular to the
    # epipolar line; the norm test selects the same nondegenerate choice
    # without extracting epipoles)
    one = jnp.ones_like(p2[..., 0])
    zero = jnp.zeros_like(p2[..., 0])
    l2v = jnp.stack([one, zero, -p2[..., 0]], axis=-1)
    l2h = jnp.stack([zero, one, -p2[..., 1]], axis=-1)
    x3v = jnp.einsum("...nk,...ni,kij->...nj", x1, l2v, T)
    x3h = jnp.einsum("...nk,...ni,kij->...nj", x1, l2h, T)
    use_v = (jnp.linalg.norm(x3v, axis=-1)
             >= jnp.linalg.norm(x3h, axis=-1))[..., None]
    x3 = jnp.where(use_v, x3v, x3h)
    w = x3[..., 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return x3[..., :2] / w[..., None]


def transfer_error(T, p1, p2, p3):
    """Squared transfer error in view 3 (DistanceTrifocalTransferSq analog,
    single-direction)."""
    pred = transfer_1_to_3(T, p1, p2)
    return jnp.sum((pred - p3) ** 2, axis=-1)


def extract_epipoles(T):
    """Epipoles e2, e3 from the tensor (TrifocalExtractGeometries).

    e2: common intersection of left null vectors of T_k; e3: of right."""
    U_list = []
    V_list = []
    for k in range(3):
        Tk = T[k]
        # left/right null vectors via eigh of Tk Tk^T / Tk^T Tk
        w_l, v_l = jnp.linalg.eigh(Tk @ Tk.T)
        w_r, v_r = jnp.linalg.eigh(Tk.T @ Tk)
        U_list.append(v_l[:, 0])
        V_list.append(v_r[:, 0])
    U = jnp.stack(U_list)  # rows = null vectors
    V = jnp.stack(V_list)
    _, vu = jnp.linalg.eigh(U.T @ U)
    _, vv = jnp.linalg.eigh(V.T @ V)
    e2 = vu[:, 0]
    e3 = vv[:, 0]
    return e2 / jnp.linalg.norm(e2), e3 / jnp.linalg.norm(e3)


def tensor_from_cameras(P2, P3):
    """T_k[i, j] = P2[i, k] P3[j, 3] - P2[i, 3] P3[j, k] with P1 = [I | 0]
    (MultiViewOps.createTrifocal)."""
    T = jnp.zeros((3, 3, 3), jnp.float64)
    for k in range(3):
        Tk = (P2[:, k:k + 1] @ P3[:, 3:4].T
              - P2[:, 3:4] @ P3[:, k:k + 1].T)
        T = T.at[k].set(Tk)
    n = jnp.sqrt(jnp.sum(T ** 2))
    return T / n


def _tensor_from_epipoles_ls(M, e2, e3):
    """Inner solve of the algebraic minimization: given epipoles, the
    geometrically-valid tensor minimizing ||M t|| s.t. ||t|| = 1 over
    t = E(e2,e3) [a; b]  (HZ Alg. 16.2 step: T_k[i,j] = A[i,k] e3[j]
    - e2[i] B[j,k]).  Returns (t [27], residual vector M t)."""
    # E: [27, 18], columns 0..8 = A[i,k] (col i*3+k), 9..17 = B[j,k]
    E = jnp.zeros((27, 18), jnp.float64)
    for k in range(3):
        for i in range(3):
            for j in range(3):
                r = k * 9 + i * 3 + j
                E = E.at[r, i * 3 + k].add(e3[j])
                E = E.at[r, 9 + j * 3 + k].add(-e2[i])
    Q, _ = jnp.linalg.qr(E)                      # orthonormal basis, [27, 18]
    MQ = M @ Q
    _, v = jnp.linalg.eigh(MQ.T @ MQ)
    y = v[:, 0]
    t = Q @ y
    return t, M @ t


def trifocal_algebraic_refine(T0, p1, p2, p3, iterations: int = 10,
                              damping: float = 1e-8):
    """Algebraic refinement of a trifocal tensor
    (TrifocalAlgebraicPoint7.java:48 analog).

    Minimizes the algebraic error ||M t|| over the 6 epipole parameters
    with the tensor constrained to the geometrically-valid manifold
    (HZ Algorithm 16.2): inner linear solve per epipole guess, outer
    Gauss-Newton with finite-difference Jacobian.  p1/p2/p3: [N, 2]
    pixels.  Returns refined T [3, 3, 3], unit norm.
    """
    from boofcv_tpu.geo.smalllinalg import inv3, solve_spd

    n1, N1 = normalize_points(p1)
    n2, N2 = normalize_points(p2)
    n3, N3 = normalize_points(p3)
    M = _design_rows(n1, n2, n3).reshape(-1, 27)

    # initial epipoles from the *normalized* version of T0: renormalize T0
    # into the conditioned coordinate system (inverse of the denormalize
    # step in trifocal_linear)
    N2m = N2
    N3m = N3
    N1i = inv3(N1)
    mixed = jnp.einsum("ia,kab,jb->kij", N2m, T0.astype(jnp.float64), N3m)
    Tn = jnp.einsum("rk,rij->kij", N1i, mixed)
    Tn = Tn / jnp.sqrt(jnp.sum(Tn ** 2))
    e2, e3 = extract_epipoles(Tn)

    eps = 1e-7

    def resid(e):
        _, r = _tensor_from_epipoles_ls(M, e[:3] / jnp.linalg.norm(e[:3]),
                                        e[3:] / jnp.linalg.norm(e[3:]))
        # sign-align so finite differences are smooth
        return r * jnp.sign(jnp.sum(r * r0_ref) + 1e-300)

    e = jnp.concatenate([e2, e3])
    for _ in range(iterations):
        t_cur, r0 = _tensor_from_epipoles_ls(
            M, e[:3] / jnp.linalg.norm(e[:3]), e[3:] / jnp.linalg.norm(e[3:]))
        r0_ref = r0
        # FD Jacobian [4N, 6]
        cols = []
        for d in range(6):
            ep = e.at[d].add(eps)
            cols.append((resid(ep) - r0) / eps)
        J = jnp.stack(cols, axis=-1)
        JtJ = J.T @ J + damping * jnp.eye(6, dtype=jnp.float64)
        g = J.T @ r0
        w, v = jnp.linalg.eigh(JtJ)
        step = v @ ((v.T @ g) / jnp.maximum(w, 1e-12))
        e_new = e - step
        # keep the step only if the residual improved (LM-style guard)
        _, r_new = _tensor_from_epipoles_ls(
            M, e_new[:3] / jnp.linalg.norm(e_new[:3]),
            e_new[3:] / jnp.linalg.norm(e_new[3:]))
        better = jnp.sum(r_new ** 2) < jnp.sum(r0 ** 2)
        e = jnp.where(better, e_new, e)

    t_fin, _ = _tensor_from_epipoles_ls(
        M, e[:3] / jnp.linalg.norm(e[:3]), e[3:] / jnp.linalg.norm(e[3:]))
    Tn = t_fin.reshape(3, 3, 3)
    # denormalize (same as trifocal_linear)
    N2i = inv3(N2)
    N3i = inv3(N3)
    mix = jnp.einsum("rk,rij->kij", N1, Tn)
    T_out = jnp.einsum("ia,kab,jb->kij", N2i, mix, N3i)
    return T_out / jnp.sqrt(jnp.sum(T_out ** 2))
