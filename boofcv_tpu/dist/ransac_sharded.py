"""Hypothesis-bank-sharded RANSAC over a device mesh.

No reference analog (BoofCV's ddogleg Ransac is single-threaded; SURVEY
§2.9's "NEW: batch/data parallel" row).  The K hypotheses are split
across the mesh's ``shard`` axis: every device solves and scores its
bank against the (replicated) point set, then one argmax rides a pair of
collectives to pick the global winner — communication is O(model size),
never O(points x hypotheses).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from boofcv_tpu.dist.mesh import SHARD_AXIS
from boofcv_tpu.geo import pnp, robust


def ransac_pnp_sharded(mesh: Mesh, key, world, obs,
                       num_hypotheses_per_device: int = 64,
                       inlier_threshold: float = 1e-3,
                       refine_iterations: int = 10):
    """Distributed ransac_pnp: each device runs an independent hypothesis
    bank (distinct fold of ``key``), the best model is selected globally
    by inlier count (MSAC tie-break) via one all_gather of the per-device
    winners, and the GN refine runs replicated on the winning device's
    inlier set.

    Returns (RansacResult, (R, t)) like geo.robust.ransac_pnp with
    effective K = num_hypotheses_per_device * mesh.size: same f32
    hypothesis bank + f32 GN refine recipe.
    """
    n_dev = mesh.shape[SHARD_AXIS]
    keys = jax.random.split(key, n_dev)

    def _scorer(model, points):
        R, t, ok = model
        w, o = points
        err = pnp.reprojection_error_sq(
            R.astype(jnp.float32), t.astype(jnp.float32),
            w.astype(jnp.float32), o.astype(jnp.float32))
        return jnp.where(ok, err, jnp.inf)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(SHARD_AXIS), P(), P()),
             out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                        P(SHARD_AXIS), P(SHARD_AXIS)))
    def per_device(keys_shard, world_rep, obs_rep):
        res = robust.ransac(
            keys_shard[0], (world_rep, obs_rep),
            solver=lambda s: pnp.p3p_grunert(s[0], s[1],
                                             dtype=jnp.float32),
            scorer=_scorer, sample_size=3,
            num_hypotheses=num_hypotheses_per_device,
            inlier_threshold=inlier_threshold,
            solutions_per_sample=4)
        R, t, _ = res.model
        return (R[None], t[None], res.num_inliers[None],
                res.best_error[None], res.inliers[None])

    Rs, ts, counts, errs, inliers = per_device(keys, world, obs)
    # global winner: max inliers, min msac tie-break (host-free argmax)
    order = counts.astype(jnp.float64) - errs / (jnp.max(errs) + 1.0)
    best = jnp.argmax(order)
    Rb, tb = Rs[best], ts[best]
    inl = inliers[best]
    w64 = jnp.where(inl[:, None], world.astype(jnp.float64), 1.0)
    o64 = jnp.where(inl[:, None], obs.astype(jnp.float64), 0.0)
    Rr, tr = pnp.gauss_newton_pose(Rb, tb, w64, o64,
                                   weights=inl.astype(jnp.float64),
                                   iterations=refine_iterations,
                                   damping=1e-9, polish_iterations=0)
    result = robust.RansacResult(model=(Rb, tb, jnp.bool_(True)),
                                 inliers=inl,
                                 num_inliers=counts[best],
                                 best_error=errs[best])
    return result, (Rr, tr)
