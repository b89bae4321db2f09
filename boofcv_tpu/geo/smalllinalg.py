"""Batched small-matrix linear algebra.

Written for a first target whose XLA backend had no LU decomposition
(linalg.inv/solve) and no general eigendecomposition (eigvals) for f64;
XLA has no general eigvals on the GPU either (ROADMAP D4).  For the batched
2x2/3x3/4x4 systems this framework solves by the thousand, closed forms
are faster than any factorization anyway.  This module provides:

* ``inv2/inv3`` — adjugate inverses, batched;
* ``solve_spd`` — symmetric-positive-definite solve via eigh;
* ``cubic_roots`` / ``quartic_roots`` — closed-form (Cardano / Ferrari)
  real-root extraction, replacing companion-matrix eigvals;
* ``solve33_batch`` — Cramer solve for [..., 3, 3] systems.

These replace the reference's dependence on EJML dense factorizations
(SURVEY layer 0) on the device path.
"""

from __future__ import annotations

import jax.numpy as jnp


def det2(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A):
    d = det2(A)
    ds = jnp.where(jnp.abs(d) < 1e-300, 1e-300, d)
    out = jnp.stack([
        jnp.stack([A[..., 1, 1], -A[..., 0, 1]], axis=-1),
        jnp.stack([-A[..., 1, 0], A[..., 0, 0]], axis=-1),
    ], axis=-2)
    return out / ds[..., None, None]


def det3(A):
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def inv3(A):
    """Adjugate 3x3 inverse, batched over leading axes."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = -(d * i - f * g)
    C02 = d * h - e * g
    C10 = -(b * i - c * h)
    C11 = a * i - c * g
    C12 = -(a * h - b * g)
    C20 = b * f - c * e
    C21 = -(a * f - c * d)
    C22 = a * e - b * d
    det = a * C00 + b * C01 + c * C02
    ds = jnp.where(jnp.abs(det) < 1e-300, 1e-300, det)
    adjT = jnp.stack([
        jnp.stack([C00, C10, C20], axis=-1),
        jnp.stack([C01, C11, C21], axis=-1),
        jnp.stack([C02, C12, C22], axis=-1),
    ], axis=-2)
    return adjT / ds[..., None, None]


def solve33(A, b):
    """[..., 3, 3] @ x = [..., 3] via the adjugate inverse."""
    return (inv3(A) @ b[..., None])[..., 0]


def solve_spd(A, b):
    """SPD solve via eigh.  A: [..., N, N]."""
    w, Q = jnp.linalg.eigh(A)
    ws = jnp.where(jnp.abs(w) < 1e-300, 1e-300, w)
    y = jnp.einsum("...ij,...i->...j", Q, b)  # Q^T b
    return jnp.einsum("...ij,...j->...i", Q, y / ws)


def inv_spd(A):
    w, Q = jnp.linalg.eigh(A)
    ws = jnp.where(jnp.abs(w) < 1e-300, 1e-300, w)
    return jnp.einsum("...ik,...k,...jk->...ij", Q, 1.0 / ws, Q)


def _cbrt(x):
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


def cubic_roots(a3, a2, a1, a0):
    """Real roots of a3 x^3 + a2 x^2 + a1 x + a0 (Cardano), batched.

    Returns (roots [..., 3], real_mask [..., 3]).  Complex roots are
    masked out; repeated roots appear repeated.
    """
    a3s = jnp.where(jnp.abs(a3) < 1e-300, 1e-300, a3)
    b, c, d = a2 / a3s, a1 / a3s, a0 / a3s
    # depressed: t^3 + p t + q, x = t - b/3
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    shift = -b / 3.0

    # disc > 0: one real root (Cardano)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    r_single = u + v + shift

    # disc <= 0: three real roots (trigonometric)
    pm = jnp.minimum(p, -1e-300)
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    k = jnp.arange(3.0)
    r_triple = (m[..., None] * jnp.cos(theta[..., None] - 2.0 * jnp.pi * k / 3.0)
                + shift[..., None])

    single = (disc > 0)[..., None]
    roots = jnp.where(single,
                      jnp.concatenate([r_single[..., None],
                                       jnp.zeros_like(r_triple[..., :2])], -1),
                      r_triple)
    real = jnp.where(single,
                     jnp.concatenate([jnp.ones_like(single),
                                      jnp.zeros_like(r_triple[..., :2], bool)], -1),
                     jnp.ones_like(r_triple, bool))
    return roots, real


def quartic_roots(c4, c3, c2, c1, c0):
    """Real roots of a quartic (Ferrari's method), batched.

    Returns (roots [..., 4], real_mask [..., 4]).
    """
    c4s = jnp.where(jnp.abs(c4) < 1e-300, 1e-300, c4)
    a, b, c, d = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # depressed quartic: y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    shift = -a / 4.0

    # resolvent cubic: 2 m^3 + 2 p m^2 + (p^2 - 4r)/2 ... use the standard
    # m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0
    mroots, mreal = cubic_roots(jnp.ones_like(p), p,
                                p * p / 4.0 - r, -q * q / 8.0)
    # pick the largest real positive root for numerical stability
    mcand = jnp.where(mreal, mroots, -jnp.inf)
    m = jnp.max(mcand, axis=-1)
    m = jnp.maximum(m, 1e-300)

    sqrt2m = jnp.sqrt(2.0 * m)
    qs = jnp.where(jnp.abs(sqrt2m) < 1e-300, 1e-300, sqrt2m)
    # factorization: (y^2 + sqrt(2m) y + C_plus)(y^2 - sqrt(2m) y + C_minus)
    # with C_plus = p/2 + m - q/(2 sqrt(2m)), C_minus = p/2 + m + q/(2 sqrt(2m))
    C_plus = p / 2.0 + m - q / (2.0 * qs)
    C_minus = p / 2.0 + m + q / (2.0 * qs)

    def quad(sgn_b, C):
        # y^2 + sgn_b*sqrt2m*y + C = 0
        disc = m / 2.0 - C  # (sqrt2m/2)^2 - C
        ok = disc >= 0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        y1 = -sgn_b * qs / 2.0 + sq
        y2 = -sgn_b * qs / 2.0 - sq
        return y1, y2, ok

    y1, y2, ok12 = quad(1.0, C_plus)
    y3, y4, ok34 = quad(-1.0, C_minus)
    roots = jnp.stack([y1, y2, y3, y4], axis=-1) + shift[..., None]
    real = jnp.stack([ok12, ok12, ok34, ok34], axis=-1)
    return roots, real


def poly_roots(coeffs, iters: int = 120):
    """Batched all-roots of a real-coefficient polynomial (Durand-Kerner).

    Replaces companion-matrix ``eigvals`` (absent on accelerator backends) for
    the degree-10 polynomial of the Nister 5-point solver.  Complex
    arithmetic is carried as explicit (re, im) f64 pairs so no complex
    dtype is required.

    coeffs: [..., D+1] highest-degree first.  Returns (re [..., D],
    im [..., D]).  The caller decides which roots are "real" (small |im|).
    Degenerate leading coefficients give garbage roots — guard upstream.
    """
    import jax

    c = coeffs.astype(jnp.float64)
    lead = c[..., :1]
    safe = jnp.where(jnp.abs(lead) < 1e-300, 1e-300, lead)
    c = c / safe
    D = c.shape[-1] - 1

    # Cauchy bound start circle, angles offset to dodge real-axis symmetry.
    r = 1.0 + jnp.max(jnp.abs(c[..., 1:]), axis=-1)
    k = jnp.arange(D, dtype=jnp.float64)
    ang = 2.0 * jnp.pi * k / D + 0.4
    zr = r[..., None] * jnp.cos(ang)
    zi = r[..., None] * jnp.sin(ang)

    def eval_poly(zr, zi):
        pr = jnp.broadcast_to(c[..., 0:1], zr.shape)
        pi = jnp.zeros_like(zr)
        for i in range(1, D + 1):
            pr, pi = pr * zr - pi * zi + c[..., i:i + 1], pr * zi + pi * zr
        return pr, pi

    def body(_, zz):
        zr, zi = zz
        pr, pi = eval_poly(zr, zi)
        # denominator prod_{j!=i} (z_i - z_j)
        qr = jnp.ones_like(zr)
        qi = jnp.zeros_like(zr)
        for j in range(D):
            dr = zr - zr[..., j:j + 1]
            di = zi - zi[..., j:j + 1]
            mask = (k != j)
            dr = jnp.where(mask, dr, 1.0)
            di = jnp.where(mask, di, 0.0)
            qr, qi = qr * dr - qi * di, qr * di + qi * dr
        den = qr * qr + qi * qi
        den = jnp.where(den < 1e-300, 1e-300, den)
        wr = (pr * qr + pi * qi) / den
        wi = (pi * qr - pr * qi) / den
        return zr - wr, zi - wi

    zr, zi = jax.lax.fori_loop(0, iters, body, (zr, zi))
    return zr, zi
