"""Bundle adjustment: block-sparse Levenberg-Marquardt with Schur complement.

Reference analog: boofcv-geo abst/geo/bundle/ + alg/geo/bundle/ —
SceneStructureMetric.java:37 / SceneObservations.java (problem structs),
BundleAdjustmentMetricResidualFunction.java (residuals),
BundleAdjustmentMetricSchurJacobian.java:42,231 (Schur-ordered sparse
jacobian), BundleAdjustmentSchur.java:33,87 driving ddogleg's
UnconstrainedLeastSquaresSchur.  The reference delegates the sparse
LM-Schur solve to ddogleg; **this module owns the solver** (SURVEY §3.3).

Design (SURVEY §7 stage 4):
* Observations live in a dense ``[P, L]`` layout — every point has up to L
  observation slots (view index + pixel + valid mask).  Static shapes,
  perfect for vmap/segment ops, and shardable over the point axis.
* Per-point 3x3 Hessian blocks are batch-inverted; the reduced camera
  system S (``[6V, 6V]`` dense — fine for sliding windows and scenes up
  to ~1k views on one chip) is assembled with one einsum over observation
  pairs + a scatter-add, then solved with Cholesky.
* The LM loop runs a fixed number of outer iterations under jit; step
  acceptance is branchless (jnp.where), lambda updates multiplicative —
  same trust-region flavor as ddogleg's LevenbergMarquardt_F64.
* View 0 (or any mask) is gauge-fixed by zeroing its update rows.

Camera models: 'normalized' (observations are K^-1 pixels, no intrinsics
optimized) and 'snavely' (BAL convention: f, k1, k2 per view, z<0 looks
forward) for Bundle-Adjustment-in-the-Large interop
(io/geo/CodecBundleAdjustmentInTheLarge.java).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from boofcv_tpu.geo import se3


class BAProblem(NamedTuple):
    """Scene structure + observations (SceneStructureMetric/SceneObservations).

    R: [V, 3, 3], t: [V, 3] — world->view transforms.
    intr: [V, K] per-view intrinsics (K=0 for 'normalized', 3 for 'snavely').
    points: [P, 3] world points.
    obs_xy: [P, L, 2]; obs_view: [P, L] int32; obs_valid: [P, L] bool.
    fixed_views: [V] bool — gauge-fixed views (updates zeroed).
    """
    R: jnp.ndarray
    t: jnp.ndarray
    intr: jnp.ndarray
    points: jnp.ndarray
    obs_xy: jnp.ndarray
    obs_view: jnp.ndarray
    obs_valid: jnp.ndarray
    fixed_views: jnp.ndarray
    model: str = "normalized"


def _project(model: str, Xc, intr):
    """Camera-frame point -> 2D observation. Xc: [..., 3], intr: [..., K]."""
    if model == "normalized":
        z = Xc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        return Xc[..., :2] / zs[..., None]
    if model == "snavely":
        # BAL: p = -X/X.z; r = 1 + k1|p|^2 + k2|p|^4; proj = f * r * p
        z = Xc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        p = -Xc[..., :2] / zs[..., None]
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        r2 = jnp.sum(p * p, axis=-1)
        distort = 1.0 + k1 * r2 + k2 * r2 * r2
        return (f * distort)[..., None] * p
    if model == "pinhole_f":
        # +z-looking pinhole with a free focal length (principal point
        # at origin): proj = f * X/z — the self-calibration refinement
        # camera (three_view polishes the guess-and-check focal in BA)
        z = Xc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        return intr[..., 0:1] * Xc[..., :2] / zs[..., None]
    raise ValueError(f"unknown camera model {model!r}")


def n_intr(model: str) -> int:
    return {"normalized": 0, "snavely": 3, "pinhole_f": 1}[model]


@partial(jax.jit, static_argnames=("model",))
def _residuals_impl(R, t, intr, points, obs_xy, obs_view, obs_valid, model):
    # full-f32 multiplies: a reduced-precision f32 default (TF32 on a
    # GPU) is far too coarse for reprojection residuals at the 1e-4 level
    with jax.default_matmul_precision("highest"):
        R_o = R[obs_view]        # [P, L, 3, 3]
        t_o = t[obs_view]        # [P, L, 3]
        intr_o = intr[obs_view]  # [P, L, K]
        Xc = jnp.einsum("plij,pj->pli", R_o, points) + t_o
        proj = _project(model, Xc, intr_o)
        r = proj - obs_xy
        return jnp.where(obs_valid[..., None], r, 0.0)


def residuals(prob: BAProblem):
    """[P, L, 2] residuals (proj - obs), zeroed where invalid.

    One jitted dispatch.
    """
    return _residuals_impl(prob.R, prob.t, prob.intr, prob.points,
                           prob.obs_xy, prob.obs_view, prob.obs_valid,
                           prob.model)


def cost(prob: BAProblem):
    """0.5 * sum of squared residuals, accumulated in f64.

    The f64 accumulation costs next to nothing (one [P*L*2] reduction)
    and keeps LM accept/reject decisions reliable on the f32 fast path."""
    r = residuals(prob).astype(jnp.float64)
    return 0.5 * jnp.sum(r * r)


def _proj_jacobian(model: str, Xc, intr):
    """Analytic projection jacobians: dproj/dXc [..., 2, 3] and
    dproj/dintr [..., 2, K].

    Replaces per-observation ``jacfwd`` (the reference writes these out by
    hand too — BundleAdjustmentMetricSchurJacobian.java:231,
    bundle/cameras/BundlePinholeBrown.java); analytic + dtype-polymorphic
    keeps the whole LM iteration in one fused f32 XLA program.
    """
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    iz = 1.0 / zs
    zero = jnp.zeros_like(iz)
    if model == "normalized":
        # proj = (x/z, y/z)
        A = jnp.stack([
            jnp.stack([iz, zero, -x * iz * iz], axis=-1),
            jnp.stack([zero, iz, -y * iz * iz], axis=-1)], axis=-2)
        return A, jnp.zeros(Xc.shape[:-1] + (2, 0), Xc.dtype)
    if model == "snavely":
        # p = -(x,y)/z; s = 1 + k1 r^2 + k2 r^4; proj = f s p
        p = -Xc[..., :2] * iz[..., None]
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        r2 = jnp.sum(p * p, axis=-1)
        s = 1.0 + k1 * r2 + k2 * r2 * r2
        ds_dp = (2.0 * k1 + 4.0 * k2 * r2)[..., None] * p      # [..., 2]
        eye2 = jnp.eye(2, dtype=Xc.dtype)
        dproj_dp = f[..., None, None] * (
            s[..., None, None] * eye2
            + p[..., :, None] * ds_dp[..., None, :])           # [..., 2, 2]
        dp_dXc = jnp.stack([
            jnp.stack([-iz, zero, x * iz * iz], axis=-1),
            jnp.stack([zero, -iz, y * iz * iz], axis=-1)], axis=-2)
        A = dproj_dp @ dp_dXc
        Ji = jnp.stack([s[..., None] * p,
                        (f * r2)[..., None] * p,
                        (f * r2 * r2)[..., None] * p], axis=-1)  # [..., 2, 3]
        return A, Ji
    if model == "pinhole_f":
        f = intr[..., 0]
        A = f[..., None, None] * jnp.stack([
            jnp.stack([iz, zero, -x * iz * iz], axis=-1),
            jnp.stack([zero, iz, -y * iz * iz], axis=-1)], axis=-2)
        Ji = jnp.stack([x * iz, y * iz], axis=-1)[..., None]  # [..., 2, 1]
        return A, Ji
    raise ValueError(f"unknown camera model {model!r}")


def _jacobians(prob: BAProblem):
    """Per-observation analytic jacobians at the current state.

    Local parameterization matches ``_apply_step``: pose perturbed on the
    left by ``exp_se3(xi)`` (xi = (w, v), rotation first), point by +dX,
    intrinsics by +dintr.  At xi=0: dXc/dw = -hat(Xc), dXc/dv = I,
    dXc/dX = R.

    Returns Jv [P, L, 2, D] (D = 6 + n_intr), Jp [P, L, 2, 3], r [P, L, 2].
    """
    k = n_intr(prob.model)
    R_o = prob.R[prob.obs_view]        # [P, L, 3, 3]
    t_o = prob.t[prob.obs_view]        # [P, L, 3]
    intr_o = prob.intr[prob.obs_view]  # [P, L, K]
    Xc = jnp.einsum("plij,pj->pli", R_o, prob.points) + t_o
    r = _project(prob.model, Xc, intr_o) - prob.obs_xy
    A, Ji = _proj_jacobian(prob.model, Xc, intr_o)   # [P,L,2,3], [P,L,2,k]
    Jrot = -jnp.einsum("plij,pljk->plik", A, se3.hat(Xc))
    parts = [Jrot, A] + ([Ji] if k else [])
    Jv = jnp.concatenate(parts, axis=-1)             # [P, L, 2, 6+k]
    Jp = jnp.einsum("plij,pljk->plik", A, R_o)       # [P, L, 2, 3]
    valid = prob.obs_valid[..., None, None]
    Jv = jnp.where(valid, Jv, 0.0)
    Jp = jnp.where(valid, Jp, 0.0)
    r = jnp.where(prob.obs_valid[..., None], r, 0.0)
    return Jv, Jp, r


def _scale_jacobians(obs_view, Jv, Jp, num_views: int, hvv_diag=None):
    """Jacobi (Marquardt) column scaling: divide each parameter column by
    sqrt of its Gauss-Newton diagonal so Hpp / Hvv have unit diagonals.

    Cuts the condition number the (f32) Cholesky must survive by orders
    of magnitude — the same normalization ddogleg's LM applies via diag
    scaling and the reference via ScaleSceneStructure.  Returns
    (Jv_scaled, Jp_scaled, s_v [V, D], s_p [P, 3]); steps computed in the
    scaled space are unscaled by dividing by s_v / s_p again.

    ``hvv_diag``: pre-reduced [V, D] GN diagonal — the distributed path
    passes the psummed diagonal so every shard scales identically.
    """
    if hvv_diag is None:
        V, D = num_views, Jv.shape[-1]
        # segment sum as one-hot matmul (ROADMAP D2)
        O = jax.nn.one_hot(obs_view, V, dtype=Jv.dtype)      # [P, L, V]
        hvv_diag = jnp.einsum("plv,pld->vd", O, jnp.sum(Jv * Jv, axis=2))
    s_v = jnp.maximum(jnp.sqrt(hvv_diag), 1e-6)
    s_p = jnp.maximum(jnp.sqrt(jnp.sum(Jp * Jp, axis=(1, 2))), 1e-6)
    Jv_s = Jv / s_v[obs_view][:, :, None, :]
    Jp_s = Jp / s_p[:, None, None, :]
    return Jv_s, Jp_s, s_v, s_p


def _point_blocks(Jv, Jp, r, lam, solve_dtype):
    """Per-point Schur building blocks shared by BOTH reduced-system
    assemblies (`_local_system` and the chunked `_local_system_kvjw` —
    one source of truth for the block algebra and the damping constant).

    Jv [..., L, 2, D], Jp [..., L, 2, 3], r [..., L, 2] ->
    (Hpp_inv [..., 3, 3], W [..., L, 3, D], gp [..., 3],
     gv_obs [..., L, D], Hvv_obs [..., L, D, D], Y [..., L, 3, D],
     corr [..., L, D]).
    """
    from boofcv_tpu.geo.smalllinalg import inv3

    Hpp = jnp.einsum("plki,plkj->pij", Jp, Jp)
    W = jnp.einsum("plki,plkj->plij", Jp, Jv)
    gp = -jnp.einsum("plki,plk->pi", Jp, r)
    gv_obs = -jnp.einsum("plki,plk->pli", Jv, r)
    eyeP = jnp.eye(3, dtype=solve_dtype)
    Hpp_inv = inv3(Hpp.astype(solve_dtype)
                   + (jnp.asarray(lam, solve_dtype) + 1e-12) * eyeP
                   ).astype(W.dtype)
    Hvv_obs = jnp.einsum("plki,plkj->plij", Jv, Jv)
    Y = jnp.einsum("pij,pljk->plik", Hpp_inv, W)
    hp = jnp.einsum("pij,pj->pi", Hpp_inv, gp)
    corr = jnp.einsum("plij,pi->plj", W, hp)
    return Hpp_inv, W, gp, gv_obs, Hvv_obs, Y, corr


def _local_system(obs_view, Jv, Jp, r, lam, num_views: int,
                  solve_dtype=None):
    """Per-point-shard contributions to the reduced camera system.

    Pure function of a (possibly sharded) slice of the point axis — the
    distributed BA psums its outputs (S_partial, gv_t_partial) across
    shards (SURVEY §2.9 "NEW: model/spatial parallel").

    ``solve_dtype``: dtype for the (tiny, conditioning-critical) 3x3
    point-block inversions — the f32 fast path passes f64 here; the
    batched inverses are ~100 flops/point, so emulated f64 is free, and
    it removes the eps*cond(Hpp) error that otherwise poisons the whole
    Schur complement.

    Returns (S_partial [V, V, D, D] incl. Hvv on the diagonal,
    gv_t_partial [V, D], Hpp_inv [P, 3, 3], W [P, L, 3, D], gp [P, 3]).
    """
    P, L = obs_view.shape
    V = num_views
    D = Jv.shape[-1]
    if solve_dtype is None:
        solve_dtype = Jp.dtype
    Hpp_inv, W, gp, gv_obs, Hvv_obs, Y, corr = _point_blocks(
        Jv, Jp, r, lam, solve_dtype)

    # All view-indexed reductions below are segment sums, formulated as
    # ONE-HOT MATMULS (chosen where scatter-adds serialize; whether they
    # pay on the GPU is open — ROADMAP D2).
    # Memory: the gathered [P, V, 3, D] factors cost P*V*3*D floats —
    # fine through V~few hundred; larger scenes use the scatter fallback.
    use_matmul = P * V * 3 * D <= 32_000_000
    if use_matmul:
        O = jax.nn.one_hot(obs_view, V, dtype=W.dtype)     # [P, L, V]
        Hvv = jnp.einsum("plv,plij->vij", O, Hvv_obs)
        gv = jnp.einsum("plv,pli->vi", O, gv_obs)
        # Schur fill-in: S[v1,v2] = sum_p (sum_l O W)^T_ (sum_m O Y):
        # two gathers-as-matmuls + one [VD, 3P] x [3P, VD] matmul
        Wg = jnp.einsum("plv,plik->pvik", O, W)              # [P, V, 3, D]
        Yg = jnp.einsum("plv,plik->pvik", O, Y)
        S = -jnp.einsum("pvik,pwij->vwkj", Wg, Yg)
        gv_t = gv - jnp.einsum("plv,plj->vj", O, corr)
    else:
        flat_view = obs_view.reshape(-1)
        Hvv = jnp.zeros((V, D, D), W.dtype).at[flat_view].add(
            Hvv_obs.reshape(-1, D, D))
        gv = jnp.zeros((V, D), W.dtype).at[flat_view].add(
            gv_obs.reshape(-1, D))
        pair = jnp.einsum("plik,pmij->plmkj", W, Y)          # [P,L,L,D,D]
        vi = jnp.broadcast_to(obs_view[:, :, None], (P, L, L))
        vj = jnp.broadcast_to(obs_view[:, None, :], (P, L, L))
        flat_idx = (vi * V + vj).reshape(-1)
        S = jnp.zeros((V * V, D, D), W.dtype).at[flat_idx].add(
            pair.reshape(-1, D, D))
        S = -S.reshape(V, V, D, D)
        gv_t = gv - jnp.zeros((V, D), W.dtype).at[flat_view].add(
            corr.reshape(-1, D))
    S = S.at[jnp.arange(V), jnp.arange(V)].add(Hvv)
    return S, gv_t, Hpp_inv, W, gp


def hvv_diag_chunked(obs_view, Jv, num_views: int, chunk: int = 8192):
    """[V, D] Gauss-Newton view diagonal as a chunked one-hot matmul.

    The one-shot formulation materializes a [P, L, V] one-hot (2.4 GB at
    P=100k / V=1k); scanning point chunks bounds the temp at
    [chunk, L, V] while staying a matmul (ROADMAP D2)."""
    P, L = obs_view.shape
    D = Jv.shape[-1]
    V = num_views
    q = jnp.sum(Jv * Jv, axis=2)                             # [P, L, D]
    pad = (-P) % chunk
    if pad:
        obs_view = jnp.concatenate(
            [obs_view, jnp.zeros((pad, L), obs_view.dtype)])
        q = jnp.concatenate([q, jnp.zeros((pad, L, D), q.dtype)])
    nc = obs_view.shape[0] // chunk

    def body(acc, inp):
        ov, qc = inp
        O = jax.nn.one_hot(ov, V, dtype=q.dtype)             # [C, L, V]
        return acc + jnp.einsum("plv,pld->vd", O, qc), None

    acc, _ = jax.lax.scan(
        body, jnp.zeros((V, D), q.dtype),
        (obs_view.reshape(nc, chunk, L), q.reshape(nc, chunk, L, D)))
    return acc


def _local_system_kvjw(obs_view, Jv, Jp, r, lam, num_views: int,
                       solve_dtype=None, chunk: int = 8192):
    """At-scale variant of :func:`_local_system` in the ``kvjw`` layout.

    Returns (T [D, V, D, V], gv_t [V, D], Hpp_inv, W, gp) where
    ``T[k, v, j, w] = S[v, w, k, j]`` (Hvv included on the v == w
    diagonal).  Two scale problems with the [V, V, D, D] layout:

    * trailing dims of size D=6 pad badly on tiled memory layouts (this
      layout was chosen for a (8, 128) tile; ROADMAP D3);
    * the gathered one-hot factors [P, V, 3, D] cost P*V*18 floats in
      one piece.

    Fix: keep V (large, tile-friendly) axes trailing everywhere and
    accumulate the Schur fill over POINT CHUNKS with ``lax.scan`` — per
    chunk one [3D, V] gather-as-matmul per factor and one
    (p,i)-contracted einsum whose output [D, V, D, V] pads only ~1.3x.
    Peak temp is bounded by the chunk, not P.
    """
    P, L = obs_view.shape
    V = num_views
    D = Jv.shape[-1]
    if solve_dtype is None:
        solve_dtype = Jp.dtype
    pad = (-P) % chunk
    if pad:
        z = lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        obs_view, Jv, Jp, r = z(obs_view), z(Jv), z(Jp), z(r)
    Pp = obs_view.shape[0]
    nc = Pp // chunk

    def body(carry, inp):
        T, Hvv, gv_t = carry
        ov, jv, jp, rc = inp                 # [C,L], [C,L,2,D], [C,L,2,3]
        C = ov.shape[0]
        Hpp_inv, W, gp, gv_obs, Hvv_obs, Y, corr = _point_blocks(
            jv, jp, rc, lam, solve_dtype)
        O = jax.nn.one_hot(ov, V, dtype=W.dtype)             # [C, L, V]
        # gather-as-matmul with the SMALL (3D) axis leading and V
        # trailing: [C, 3D, V] pads ~1.3x (vs 21x for [..., V, D])
        Wt = jnp.einsum("pla,plv->pav",
                        W.reshape(C, L, 3 * D), O).reshape(C, 3, D, V)
        Yt = jnp.einsum("pla,plv->pav",
                        Y.reshape(C, L, 3 * D), O).reshape(C, 3, D, V)
        T = T - jnp.einsum("pikv,pijw->kvjw", Wt, Yt)
        Hvv = Hvv + jnp.einsum("plv,plij->vij", O, Hvv_obs)
        gv_t = gv_t + jnp.einsum("plv,pli->vi", O, gv_obs - corr)
        return (T, Hvv, gv_t), (Hpp_inv, W, gp)

    init = (jnp.zeros((D, V, D, V), Jp.dtype),
            jnp.zeros((V, D, D), Jp.dtype),
            jnp.zeros((V, D), Jp.dtype))
    (T, Hvv, gv_t), (Hpp_inv, W, gp) = jax.lax.scan(
        body, init,
        (obs_view.reshape(nc, chunk, L),
         Jv.reshape(nc, chunk, L, 2, D),
         Jp.reshape(nc, chunk, L, 2, 3),
         r.reshape(nc, chunk, L, 2)))
    ar = jnp.arange(V)
    T = T.at[:, ar, :, ar].add(Hvv)          # indexed view is [V, k, j]
    Hpp_inv = Hpp_inv.reshape(Pp, 3, 3)[:P]
    W = W.reshape(Pp, L, 3, D)[:P]
    gp = gp.reshape(Pp, 3)[:P]
    return T, gv_t, Hpp_inv, W, gp


def _solve_reduced(S, gv_t, fixed_views, lam, solve_dtype=None,
                   refine_steps: int = 0):
    """Damp + gauge-fix the (already psummed) reduced system and solve.

    ``solve_dtype``: dtype for the Cholesky factor/solve of the [VD, VD]
    system (the reduced camera system is the conditioning bottleneck of
    BA).  ``refine_steps``: rounds of f64 iterative refinement — factor
    once in S.dtype, then repeat x += solve(b - S x) with the residual
    computed in f64 (one [VD, VD] matvec per round, ~1e4x fewer f64
    flops than an f64 factorization, near-f64 solution quality).
    Returns delta_view [V, D].
    """
    V, _, D, _ = S.shape
    out_dtype = S.dtype
    if solve_dtype is not None and solve_dtype != S.dtype:
        S = S.astype(solve_dtype)
        gv_t = gv_t.astype(solve_dtype)
        lam = jnp.asarray(lam, solve_dtype)
    S = S.at[jnp.arange(V), jnp.arange(V)].add(
        lam * jnp.eye(D, dtype=S.dtype))

    # gauge fixing: zero rows/cols of fixed views' POSE block only
    # (intrinsics of a gauge-fixed view must stay free — they carry no
    # gauge freedom), identity on the frozen diagonal entries.
    pose_col = (jnp.arange(D) < 6).astype(S.dtype)           # [D]
    frozen = fixed_views.astype(S.dtype)[:, None] * pose_col[None, :]
    free_vd = 1.0 - frozen                                   # [V, D]
    S = S * free_vd[:, None, :, None] * free_vd[None, :, None, :]
    S = S.at[jnp.arange(V), jnp.arange(V)].add(
        jax.vmap(jnp.diag)(frozen))
    gv_t = gv_t * free_vd

    Sd = S.transpose(0, 2, 1, 3).reshape(V * D, V * D)
    gd = gv_t.reshape(V * D)
    # f64 path: Cholesky + triangular solves (written for a first target
    # without LU; ROADMAP D4)
    L_chol = jnp.linalg.cholesky(Sd)

    def chol_solve(b):
        y = jax.scipy.linalg.solve_triangular(L_chol, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L_chol.T, y, lower=False)

    x = chol_solve(gd)
    if refine_steps:
        Sd64 = Sd.astype(jnp.float64)
        gd64 = gd.astype(jnp.float64)
        for _ in range(refine_steps):
            res = gd64 - Sd64 @ x.astype(jnp.float64)
            x = x + chol_solve(res.astype(Sd.dtype))
    return (x.reshape(V, D) * free_vd).astype(out_dtype)


def _back_substitute(obs_view, Hpp_inv, W, gp, dv):
    """Point updates given the view step: dp = Hpp^-1 (gp - sum_l W dv)."""
    dv_obs = dv[obs_view]                                    # [P, L, D]
    corr_p = jnp.einsum("plij,plj->pi", W, dv_obs)
    return jnp.einsum("pij,pj->pi", Hpp_inv, gp - corr_p)


def _schur_solve(prob: BAProblem, Jv, Jp, r, lam, solve_dtype=None,
                 refine_steps: int = 0):
    """One damped Schur-complement solve (single-device path).

    Solved in the Jacobi-scaled parameter space (``_scale_jacobians``) —
    lam acts as relative (Marquardt) damping there.  ``solve_dtype``
    applies to the 3x3 point-block inverses; the reduced system is
    factored in the working dtype with ``refine_steps`` rounds of f64
    iterative refinement (see _solve_reduced).  Returns
    (delta_view [V, D], delta_point [P, 3]).
    """
    V = prob.R.shape[0]
    Jv_s, Jp_s, s_v, s_p = _scale_jacobians(prob.obs_view, Jv, Jp, V)
    S, gv_t, Hpp_inv, W, gp = _local_system(
        prob.obs_view, Jv_s, Jp_s, r, lam, V, solve_dtype=solve_dtype)
    dv = _solve_reduced(S, gv_t, prob.fixed_views, lam,
                        refine_steps=refine_steps)
    dp = _back_substitute(prob.obs_view, Hpp_inv, W, gp, dv)
    return dv / s_v, dp / s_p


def _apply_step(prob: BAProblem, dv, dp):
    k = n_intr(prob.model)
    xi = dv[:, :6]
    dR, dt = jax.vmap(se3.exp_se3)(xi)
    Rn, tn = jax.vmap(se3.compose)(dR, dt, prob.R, prob.t)
    intr_n = prob.intr + dv[:, 6:6 + k] if k else prob.intr
    return prob._replace(R=Rn, t=tn, intr=intr_n, points=prob.points + dp)


@partial(jax.jit, static_argnames=("model", "iterations", "lam0", "lam_up",
                                   "lam_down", "mixed"))
def _optimize_impl(R, t, intr, points, obs_xy, obs_view, obs_valid,
                   fixed_views, model, iterations, lam0, lam_up, lam_down,
                   mixed):
    """Whole LM loop as ONE compiled program (one dispatch per solve).

    Traced under matmul precision 'highest': a reduced-precision f32
    default (TF32 on a GPU) wrecks the Schur assembly.  The BA einsums
    have tiny inner dims (3/6), so full-f32 multiplies cost little."""
    dtype = points.dtype
    prob = BAProblem(R, t, intr, points, obs_xy, obs_view, obs_valid,
                     fixed_views, model)
    solve_dtype = jnp.float64 if mixed else None
    refine_steps = 2 if mixed else 0

    def with_state(state):
        R, t, intr, points = state
        return prob._replace(R=R, t=t, intr=intr, points=points)

    def step(carry, _):
        state, lam = carry
        cur = with_state(state)
        Jv, Jp, r = _jacobians(cur)
        dv, dp = _schur_solve(cur, Jv, Jp, r, lam, solve_dtype=solve_dtype,
                              refine_steps=refine_steps)
        cand = _apply_step(cur, dv, dp)
        c0 = cost(cur)
        c1 = cost(cand)
        good = jnp.isfinite(c1) & (c1 < c0)
        new_state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.reshape(good, (1,) * a.ndim), b, a),
            (cur.R, cur.t, cur.intr, cur.points),
            (cand.R, cand.t, cand.intr, cand.points))
        lam_n = jnp.where(good, lam * lam_down, lam * lam_up)
        lam_n = jnp.clip(lam_n, 1e-12, 1e8)
        return (new_state, lam_n), jnp.where(good, c1, c0)

    state0 = (prob.R, prob.t, prob.intr, prob.points)
    with jax.default_matmul_precision("highest"):
        (state, _), costs = jax.lax.scan(
            step, (state0, jnp.asarray(lam0, dtype)), None,
            length=iterations)
        out = with_state(state)
        return ((out.R, out.t, out.intr, out.points), costs, cost(prob),
                cost(out))


def optimize(prob: BAProblem, iterations: int = 20, lam0: float = 1e-3,
             lam_up: float = 10.0, lam_down: float = 0.3,
             mixed_precision: bool | None = None):
    """LM-Schur bundle adjustment (BundleAdjustmentSchur.optimize:87 analog).

    Fixed iteration count, branchless accept/reject.  Returns
    (optimized problem, info dict of per-iteration costs).

    Runs in the problem's own float dtype (``make_problem(dtype=...)``):
    f64 for oracle-grade accuracy, f32 for the fast path.  On the f32
    path, ``mixed_precision`` (default on for
    f32 problems) computes the two conditioning-critical tiny pieces —
    batched 3x3 point-block inverses and the [6V, 6V] reduced-system
    Cholesky — in f64: a negligible flop count that restores
    near-f64 convergence.
    """
    dtype = prob.points.dtype
    if mixed_precision is None:
        mixed_precision = dtype == jnp.float32
    prob = prob._replace(
        R=prob.R.astype(dtype), t=prob.t.astype(dtype),
        intr=prob.intr.astype(dtype),
        points=prob.points.astype(dtype),
        obs_xy=prob.obs_xy.astype(dtype))
    state, costs, c_init, c_final = _optimize_impl(
        prob.R, prob.t, prob.intr, prob.points, prob.obs_xy, prob.obs_view,
        prob.obs_valid, prob.fixed_views, prob.model, int(iterations),
        float(lam0), float(lam_up), float(lam_down), bool(mixed_precision))
    out = prob._replace(R=state[0], t=state[1], intr=state[2],
                        points=state[3])
    return out, {"costs": costs, "initial_cost": c_init,
                 "final_cost": c_final}


def make_problem(R, t, points, obs_xy, obs_view, obs_valid,
                 intr=None, model: str = "normalized", fixed_views=None,
                 dtype=jnp.float64):
    """Convenience constructor with dtype/shape policy applied.

    ``dtype=jnp.float64`` (default) is the oracle/parity path;
    ``jnp.float32`` is the fast path.
    """
    V = R.shape[0]
    if intr is None:
        intr = jnp.zeros((V, n_intr(model)), dtype)
    if fixed_views is None:
        fixed_views = jnp.zeros((V,), bool).at[0].set(True)
    return BAProblem(
        jnp.asarray(R, dtype), jnp.asarray(t, dtype),
        jnp.asarray(intr, dtype), jnp.asarray(points, dtype),
        jnp.asarray(obs_xy, dtype), jnp.asarray(obs_view, jnp.int32),
        jnp.asarray(obs_valid, bool), jnp.asarray(fixed_views, bool), model)
