"""Point-sharded bundle adjustment over a device mesh.

The scaling design from SURVEY §2.9 / §5: the BA problem's point blocks
(and their observations, in the dense ``[P, L]`` layout) are sharded
across devices; views are replicated.  Each device:

1. computes jacobians + per-point Schur contributions for its point shard
   (``ba._local_system`` — embarrassingly parallel),
2. ``psum``s the partial reduced camera system S and rhs over the mesh
   (one [V,V,D,D]+[V,D] all-reduce between devices),
3. solves the (replicated) reduced system locally,
4. back-substitutes its own point updates — no further communication.

This is the BoofCV-analog of "ring-reduced Schur contributions" planned in
SURVEY §5; the same structure runs multi-host across hosts once
jax.distributed is initialized (device order in the mesh keeps the psum
hierarchical).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from boofcv_tpu.geo import ba
from boofcv_tpu.geo.ba import BAProblem
from boofcv_tpu.dist.mesh import SHARD_AXIS


def pad_points_for_mesh(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the point axis to a multiple of n_shards with dead observations."""
    Pn = prob.points.shape[0]
    rem = (-Pn) % n_shards
    if rem == 0:
        return prob
    L = prob.obs_view.shape[1]
    return prob._replace(
        points=jnp.concatenate(
            [prob.points, jnp.ones((rem, 3), prob.points.dtype)]),
        obs_xy=jnp.concatenate(
            [prob.obs_xy, jnp.zeros((rem, L, 2), prob.obs_xy.dtype)]),
        obs_view=jnp.concatenate(
            [prob.obs_view, jnp.zeros((rem, L), prob.obs_view.dtype)]),
        obs_valid=jnp.concatenate(
            [prob.obs_valid, jnp.zeros((rem, L), bool)]),
    )


def _solve_reduced_pcg_kvjw(T_local, gv_t, fixed_views, lam, iters: int,
                            axis: str = SHARD_AXIS):
    """Row-scattered block-Jacobi PCG on the ``kvjw`` layout
    (``T[k, v, j, w] = S[v, w, k, j]``, see ba._local_system_kvjw):
    psum_scatter leaves each device a view-row slab ``[D, V/n, D, V]`` of
    the summed system; matvec = one local einsum + one tiled all_gather
    of [V, D] per CG iteration.  No tensor in the solve carries a
    trailing dim of D, and nothing [V, V, D, D]-shaped is ever summed in
    one piece, so it scales to views where the dense Cholesky path runs
    out of memory."""
    D, V = T_local.shape[0], T_local.shape[1]
    n = jax.lax.psum(1, axis)
    rows = V // n
    T = jax.lax.psum_scatter(T_local, axis, scatter_dimension=1,
                             tiled=True)                  # [D, rows, D, V]
    off = jax.lax.axis_index(axis) * rows
    ar = jnp.arange(rows)
    row_ids = off + ar

    pose_col = (jnp.arange(D) < 6).astype(T.dtype)
    frozen = fixed_views.astype(T.dtype)[:, None] * pose_col[None, :]
    free_vd = 1.0 - frozen                                # [V, D]
    free_rows = jax.lax.dynamic_slice_in_dim(free_vd, off, rows)
    frozen_rows = jax.lax.dynamic_slice_in_dim(frozen, off, rows)

    # damping on the global diagonal blocks; T[:, r, :, off+r] is the
    # [rows, D, D] diagonal-block view (advanced dims move to front)
    eye = jnp.eye(D, dtype=T.dtype)
    T = T.at[:, ar, :, row_ids].add(
        jnp.broadcast_to(lam * eye, (rows, D, D)))
    # gauge fixing: zero frozen rows/cols, identity on the frozen diagonal
    T = T * free_rows.T[:, :, None, None] * free_vd.T[None, None, :, :]
    diag = T[:, ar, :, row_ids] + jax.vmap(jnp.diag)(frozen_rows)
    T = T.at[:, ar, :, row_ids].set(diag)
    b = gv_t * free_vd

    w, vv = jnp.linalg.eigh(diag)
    w = jnp.maximum(w, 1e-12)
    Minv = jnp.einsum("rik,rk,rjk->rij", vv, 1.0 / w, vv)

    def matvec(x):
        y = jnp.einsum("krjw,wj->rk", T, x)
        return jax.lax.all_gather(y, axis, tiled=True)

    def precond(z):
        zr = jax.lax.dynamic_slice_in_dim(z, off, rows)
        y = jnp.einsum("rij,rj->ri", Minv, zr)
        return jax.lax.all_gather(y, axis, tiled=True)

    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)
    tiny = jnp.asarray(jnp.finfo(T.dtype).tiny, T.dtype)

    def body(_, st):
        x, r, p, rz = st
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(pAp <= 0, tiny, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz2 = jnp.sum(r * z)
        beta = rz2 / jnp.where(rz == 0, tiny, rz)
        return x, r, z + beta * p, rz2

    x, r, p, rz = jax.lax.fori_loop(0, iters, body, (x, r, p, rz))
    return x * free_vd


def optimize_sharded(prob: BAProblem, mesh: Mesh, iterations: int = 20,
                     lam0: float = 1e-3, lam_up: float = 10.0,
                     lam_down: float = 0.3, reduced_solver: str = "cholesky",
                     pcg_iterations: int = 100):
    """Distributed LM-Schur BA.  Same semantics as :func:`ba.optimize`
    (bitwise-comparable modulo reduction order), point axis sharded over
    ``mesh``'s '{axis}' dimension.

    ``reduced_solver``:
      * "cholesky" — psum the FULL [V, V, D, D] reduced camera system to
        every device, replicated Cholesky solve.  Exact; memory/traffic
        O(V^2 D^2) per device — fine to a few hundred views.
      * "pcg" — ``psum_scatter`` the reduced system over view-block ROWS
        (each device keeps [V/n, V, D, D] of the summed system) and solve
        by distributed block-Jacobi-preconditioned conjugate gradients:
        matvec = local row-block product + one tiled ``all_gather`` of
        [V, D] per iteration.  Cuts all-reduce traffic O(V^2 D^2) ->
        O(V^2 D^2 / n) and post-reduction storage by n.  Assembly and
        solve both run in the ``kvjw`` layout (ba._local_system_kvjw)
        with the Schur fill accumulated over point chunks, so peak
        memory is one [D, V, D, V] slab (~144 MB f32 at V=1000) plus a
        chunk.  1D meshes only.
    """
    n_shards = mesh.devices.size
    if reduced_solver not in ("cholesky", "pcg"):
        raise ValueError(
            f"unknown reduced_solver {reduced_solver!r}; expected "
            "'cholesky' or 'pcg' (a typo silently took the dense path "
            "and OOMed at the scale pcg exists for)")
    if reduced_solver == "pcg" and len(mesh.axis_names) != 1:
        raise ValueError("pcg reduced solver supports 1D meshes only")
    V_orig = prob.R.shape[0]
    prob = pad_points_for_mesh(prob, n_shards)
    if reduced_solver == "pcg":
        # pad views so block rows split evenly; dummies are unobserved and
        # gauge-frozen (identity diagonal), so the solve is unaffected
        V0 = prob.R.shape[0]
        V_pad = (-V0) % n_shards
        if V_pad:
            eye = jnp.broadcast_to(jnp.eye(3, dtype=prob.R.dtype),
                                   (V_pad, 3, 3))
            prob = prob._replace(
                R=jnp.concatenate([prob.R, eye]),
                t=jnp.concatenate([prob.t, jnp.zeros((V_pad, 3),
                                                     prob.t.dtype)]),
                intr=jnp.concatenate(
                    [prob.intr, jnp.zeros((V_pad, prob.intr.shape[1]),
                                          prob.intr.dtype)]),
                fixed_views=jnp.concatenate(
                    [prob.fixed_views, jnp.ones(V_pad, bool)]))
    # run in the problem's own float dtype (f64 parity path by default;
    # f32 is the fast path — see ba.optimize)
    dtype = prob.points.dtype
    prob = prob._replace(
        R=prob.R.astype(dtype), t=prob.t.astype(dtype),
        intr=prob.intr.astype(dtype),
        points=prob.points.astype(dtype),
        obs_xy=prob.obs_xy.astype(dtype))
    V = prob.R.shape[0]
    model = prob.model
    # mirror ba._optimize_impl's mixed-precision recipe on the f32 fast
    # path: f64 for the tiny conditioning-critical 3x3 point-block
    # inverses + f64 iterative refinement of the reduced solve, so the
    # distributed path converges like the single-device one
    mixed = dtype == jnp.float32
    solve_dtype = jnp.float64 if mixed else None
    refine_steps = 2 if mixed else 0

    # static (non-carried) per-shard data.  The point axis shards over
    # EVERY mesh axis: on a 1D ('shard',) mesh that is plain data
    # parallelism; on a 2D ('host', 'shard') multi-host mesh the reduced
    # camera psum becomes a hierarchical all-reduce — within a host row,
    # then across hosts (SURVEY §2.9 "sequence/ring parallel" row).
    axes = tuple(mesh.axis_names)
    point_specs = P(axes)
    rep = P()

    @partial(
        shard_map, mesh=mesh,
        in_specs=(rep, rep, rep, point_specs, point_specs, point_specs,
                  point_specs, rep, rep),
        out_specs=(rep, point_specs, rep),
        check_vma=False)
    def lm_step(R, t, intr, points, obs_xy, obs_view, obs_valid,
                fixed_views, lam):
        # full-f32 multiplies (see ba._optimize_impl)
        with jax.default_matmul_precision("highest"):
            return _lm_step_inner(R, t, intr, points, obs_xy, obs_view,
                                  obs_valid, fixed_views, lam)

    def _lm_step_inner(R, t, intr, points, obs_xy, obs_view, obs_valid,
                       fixed_views, lam):
        local = BAProblem(R, t, intr, points, obs_xy, obs_view, obs_valid,
                          fixed_views, model)
        Jv, Jp, r = ba._jacobians(local)
        # Jacobi scaling with the globally-psummed GN diagonal so every
        # shard scales the view columns identically (ba._scale_jacobians);
        # segment sum as one-hot matmul (ROADMAP D2).
        # Chunked so the one-hot temp stays bounded at scale.
        hvv_diag = ba.hvv_diag_chunked(obs_view, Jv, V)
        hvv_diag = jax.lax.psum(hvv_diag, axes)
        Jv, Jp, s_v, s_p = ba._scale_jacobians(obs_view, Jv, Jp, V,
                                               hvv_diag=hvv_diag)
        if reduced_solver == "pcg":
            # at-scale path: chunked [D, V, D, V] assembly + row-scattered
            # PCG — no [*, D, D]-trailing tensors anywhere
            T, gv_t, Hpp_inv, W, gp = ba._local_system_kvjw(
                obs_view, Jv, Jp, r, lam, V, solve_dtype=solve_dtype)
            gv_t = jax.lax.psum(gv_t, axes)
            dv = _solve_reduced_pcg_kvjw(T, gv_t, fixed_views, lam,
                                         pcg_iterations, axis=axes[0])
        else:
            S, gv_t, Hpp_inv, W, gp = ba._local_system(
                obs_view, Jv, Jp, r, lam, V, solve_dtype=solve_dtype)
            gv_t = jax.lax.psum(gv_t, axes)
            # one all-reduce for the full reduced camera system
            S = jax.lax.psum(S, axes)
            dv = ba._solve_reduced(S, gv_t, fixed_views, lam,
                                   refine_steps=refine_steps)
        dp = ba._back_substitute(obs_view, Hpp_inv, W, gp, dv)
        dv = dv / s_v
        dp = dp / s_p
        # local cost contribution, accumulated in f64 so the LM
        # accept/reject comparison against ba.cost (also f64) is not
        # dominated by f32 summation noise near convergence
        r64 = r.astype(jnp.float64)
        c_local = 0.5 * jnp.sum(r64 * r64)
        c = jax.lax.psum(c_local, axes)
        return dv, dp, c

    def cost_state(state):
        R, t, intr, points = state
        return ba.cost(prob._replace(R=R, t=t, intr=intr, points=points))

    def step(carry, _):
        state, lam = carry
        R, t, intr, points = state
        dv, dp, c0 = lm_step(R, t, intr, points, prob.obs_xy, prob.obs_view,
                             prob.obs_valid, prob.fixed_views, lam)
        cand = ba._apply_step(
            prob._replace(R=R, t=t, intr=intr, points=points), dv, dp)
        c1 = cost_state((cand.R, cand.t, cand.intr, cand.points))
        good = jnp.isfinite(c1) & (c1 < c0)
        new_state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.reshape(good, (1,) * a.ndim), b, a),
            state, (cand.R, cand.t, cand.intr, cand.points))
        lam_n = jnp.clip(jnp.where(good, lam * lam_down, lam * lam_up),
                         1e-12, 1e8)
        return (new_state, lam_n), jnp.where(good, c1, c0)

    state0 = (prob.R, prob.t, prob.intr, prob.points)
    # trace the WHOLE loop under 'highest' matmul precision, exactly like
    # ba._optimize_impl: lm_step already forces it internally, but
    # _apply_step (rotation compositions) and cost_state (reprojection
    # einsums) would otherwise run at the device's reduced-precision f32
    # default (TF32 on a GPU), which floors the achievable cost
    with jax.default_matmul_precision("highest"):
        (state, _), costs = jax.lax.scan(
            step, (state0, jnp.asarray(lam0, dtype)), None,
            length=iterations)
        final = cost_state(state)
    out = prob._replace(R=state[0], t=state[1], intr=state[2],
                        points=state[3])
    if out.R.shape[0] != V_orig:   # trim pcg view padding
        out = out._replace(R=out.R[:V_orig], t=out.t[:V_orig],
                           intr=out.intr[:V_orig],
                           fixed_views=out.fixed_views[:V_orig])
    return out, {"costs": costs, "final_cost": final}
