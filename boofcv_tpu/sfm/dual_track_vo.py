"""Dual-tracker stereo visual odometry.

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomDualTrackPnP.java:57,181 —
independent point trackers run in the left and right cameras; tracks are
paired stereo-wise at spawn time, cross-validated every frame with the
epipolar constraint, and motion is estimated with RANSAC-PnP from the
left camera's observations of the triangulated stereo points.

Design: ONE fixed-capacity pool carries both cameras' track state
(left/right positions + KLT templates per pyramid level); both KLT
updates are batched GN sweeps; the epipolar cross-check is a masked
row/disparity test; RANSAC-P3P + spawn compaction follow
sfm/stereo_vo.py.  The per-frame update is one jitted step over the
rectified pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.core.pyramid import PyramidConfig
from boofcv_tpu.feature import extract, intensity, klt
from boofcv_tpu.feature import disparity as disp_mod
from boofcv_tpu.geo import robust, se3
from boofcv_tpu.geo.rectify import pixel_to_3d_rectified
from boofcv_tpu.ip import pyramid_ops


@dataclass(frozen=True)
class DualTrackVoConfig:
    num_tracks: int = 512
    pyramid_scales: tuple = (1, 2, 4, 8)
    template_radius: int = 3
    detect_radius: int = 5
    detect_threshold: float = 1.0
    max_disparity: int = 96
    disparity_radius: int = 3
    epipolar_tol_px: float = 1.5      # row tolerance for the L/R cross-check
    ransac_hypotheses: int = 256
    inlier_threshold_px: float = 1.5
    refine_iterations: int = 10
    respawn_below: float = 0.6
    klt: klt.KltConfig = klt.KltConfig()


class DualTrackVoState(NamedTuple):
    lxs: jnp.ndarray        # [N] left-camera track x
    lys: jnp.ndarray
    rxs: jnp.ndarray        # [N] right-camera track x (same feature)
    rys: jnp.ndarray
    world: jnp.ndarray      # [N, 3] f64
    alive: jnp.ndarray      # [N] bool
    tmpl_l: klt.KltTemplates
    tmpl_r: klt.KltTemplates
    R: jnp.ndarray          # world->left-camera
    t: jnp.ndarray
    key: jnp.ndarray


def init_state(cfg: DualTrackVoConfig, seed: int = 0) -> DualTrackVoState:
    n = cfg.num_tracks
    p = 2 * cfg.template_radius + 1
    levels = len(cfg.pyramid_scales)
    zt = tuple(jnp.zeros((n, p, p), jnp.float32) for _ in range(levels))
    zero_tmpl = klt.KltTemplates(zt, zt, zt)
    z = jnp.zeros((n,), jnp.float32)
    return DualTrackVoState(z, z, z, z,
                            jnp.zeros((n, 3), jnp.float64),
                            jnp.zeros((n,), bool), zero_tmpl, zero_tmpl,
                            jnp.eye(3, dtype=jnp.float64),
                            jnp.zeros((3,), jnp.float64),
                            jax.random.PRNGKey(seed))


def _spawn(state: DualTrackVoState, pyr_l, grads_l, pyr_r, grads_r,
           left, right, rectK, baseline, cfg: DualTrackVoConfig):
    """Detect in the left image, stereo-match with sparse BM, fill dead
    slots with the validated pair (addNewTracks analog :181ff)."""
    n = cfg.num_tracks
    inten = intensity.shi_tomasi(left, radius=2)
    det = extract.detect(inten, max_features=n, radius=cfg.detect_radius,
                         threshold=cfg.detect_threshold,
                         border=cfg.template_radius
                         * cfg.pyramid_scales[-1] + 2)
    cand_y = det.ys.astype(jnp.float32)
    cand_x = det.xs.astype(jnp.float32)
    cand_ok = det.valid

    d2 = ((cand_x[:, None] - state.lxs[None, :]) ** 2
          + (cand_y[:, None] - state.lys[None, :]) ** 2)
    d2 = jnp.where(state.alive[None, :], d2, jnp.inf)
    cand_ok &= jnp.min(d2, axis=1) > (2 * cfg.detect_radius) ** 2

    dcfg = disp_mod.DisparityConfig(
        min_disparity=0, max_disparity=cfg.max_disparity,
        radius_x=cfg.disparity_radius, radius_y=cfg.disparity_radius,
        texture_threshold=0.1)
    disp, dvalid = disp_mod.sparse_block_match(
        left, right, cand_y.astype(jnp.int32), cand_x.astype(jnp.int32), dcfg)
    cand_ok &= dvalid & (disp > 0.5)

    Xc = pixel_to_3d_rectified(cand_x.astype(jnp.float64),
                               cand_y.astype(jnp.float64),
                               disp.astype(jnp.float64), rectK, baseline)
    Rinv, tinv = se3.invert(state.R, state.t)
    Xw = Xc @ Rinv.T + tinv

    dead = ~state.alive
    slot_rank = jnp.cumsum(dead) * dead
    cand_rank = jnp.cumsum(cand_ok) * cand_ok
    by_rank = jnp.zeros((n + 1,), jnp.int32).at[cand_rank].set(
        jnp.arange(n, dtype=jnp.int32))
    n_cand = jnp.max(cand_rank)
    take = dead & (slot_rank <= n_cand) & (slot_rank > 0)
    src = by_rank[jnp.clip(slot_rank, 0, n)]

    lxs = jnp.where(take, cand_x[src], state.lxs)
    lys = jnp.where(take, cand_y[src], state.lys)
    rxs = jnp.where(take, cand_x[src] - disp[src], state.rxs)
    rys = jnp.where(take, cand_y[src], state.rys)
    world = jnp.where(take[:, None], Xw[src], state.world)
    alive = state.alive | take

    def mix_tmpl(new, old):
        m = lambda a, b: tuple(jnp.where(take[:, None, None], x, y)
                               for x, y in zip(a, b))
        return klt.KltTemplates(m(new.desc, old.desc),
                                m(new.grad_x, old.grad_x),
                                m(new.grad_y, old.grad_y))

    tl = klt.sample_templates(pyr_l, grads_l, lys, lxs,
                              cfg.pyramid_scales, cfg.template_radius)
    tr = klt.sample_templates(pyr_r, grads_r, rys, rxs,
                              cfg.pyramid_scales, cfg.template_radius)
    return state._replace(
        lxs=lxs, lys=lys, rxs=rxs, rys=rys, world=world, alive=alive,
        tmpl_l=mix_tmpl(tl, state.tmpl_l), tmpl_r=mix_tmpl(tr, state.tmpl_r))


def make_step(cfg: DualTrackVoConfig, rectK, baseline: float):
    fx = float(rectK[0, 0])
    cx = float(rectK[0, 2])
    cy = float(rectK[1, 2])
    fy = float(rectK[1, 1])
    rectK = jnp.asarray(rectK, jnp.float64)
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)

    @jax.jit
    def step(state: DualTrackVoState, left, right):
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        pyr_l = pyramid_ops.pyramid_average(left, pyr_cfg)
        pyr_r = pyramid_ops.pyramid_average(right, pyr_cfg)
        grads_l = pyramid_ops.gradient(pyr_l)
        grads_r = pyramid_ops.gradient(pyr_r)

        # 1. both trackers advance independently
        nlys, nlxs, fl = klt.track_pyramid(pyr_l, state.tmpl_l, state.lys,
                                           state.lxs, cfg.pyramid_scales,
                                           cfg.klt)
        nrys, nrxs, fr = klt.track_pyramid(pyr_r, state.tmpl_r, state.rys,
                                           state.rxs, cfg.pyramid_scales,
                                           cfg.klt)
        tracked = (state.alive & (fl == klt.TRACK_OK)
                   & (fr == klt.TRACK_OK))

        # 2. stereo cross-validation: a surviving pair must stay on the
        # same rectified row with positive bounded disparity
        disp = nlxs - nrxs
        consistent = jnp.abs(nlys - nrys) <= cfg.epipolar_tol_px
        consistent &= (disp > 0.1) & (disp < cfg.max_disparity)
        tracked &= consistent

        lxs = jnp.where(tracked, nlxs, state.lxs)
        lys = jnp.where(tracked, nlys, state.lys)
        rxs = jnp.where(tracked, nrxs, state.rxs)
        rys = jnp.where(tracked, nrys, state.rys)

        # 3. motion from the left camera's observations
        obs = jnp.stack([(lxs - cx) / fx, (lys - cy) / fy],
                        -1).astype(jnp.float64)
        key, sub = jax.random.split(state.key)
        res, (Rn, tn) = robust.ransac_pnp(
            sub, state.world, obs, num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=tracked,
            refine_iterations=cfg.refine_iterations)
        ok = res.num_inliers >= 6
        Rn = jnp.where(ok, Rn, state.R)
        tn = jnp.where(ok, tn, state.t)

        # prune only on an ACCEPTED pose (a failed RANSAC's mask is
        # junk; see stereo_vo)
        alive = tracked & (res.inliers | ~ok)
        new_state = state._replace(lxs=lxs, lys=lys, rxs=rxs, rys=rys,
                                   alive=alive, R=Rn, t=tn, key=key)

        frac = jnp.mean(alive.astype(jnp.float32))
        new_state = jax.lax.cond(
            frac < cfg.respawn_below,
            lambda s: _spawn(s, pyr_l, grads_l, pyr_r, grads_r, left,
                             right, rectK, baseline, cfg),
            lambda s: s, new_state)

        metrics = {"tracked": jnp.sum(tracked), "inliers": res.num_inliers,
                   "alive": jnp.sum(new_state.alive), "pose_ok": ok}
        return new_state, metrics

    return step


def make_bootstrap(cfg: DualTrackVoConfig, rectK, baseline: float):
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rectK = jnp.asarray(rectK, jnp.float64)

    @jax.jit
    def boot(state: DualTrackVoState, left, right):
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        pyr_l = pyramid_ops.pyramid_average(left, pyr_cfg)
        pyr_r = pyramid_ops.pyramid_average(right, pyr_cfg)
        return _spawn(state, pyr_l, pyramid_ops.gradient(pyr_l),
                      pyr_r, pyramid_ops.gradient(pyr_r),
                      left, right, rectK, baseline, cfg)
    return boot


class DualTrackVisualOdometry:
    """Host driver (abst StereoVisualOdometry analog, dual-tracker method)."""

    def __init__(self, cfg: DualTrackVoConfig, rectK, baseline: float,
                 seed: int = 0):
        self.cfg = cfg
        self._step = make_step(cfg, np.asarray(rectK), float(baseline))
        self._boot = make_bootstrap(cfg, np.asarray(rectK), float(baseline))
        self.state = init_state(cfg, seed)
        self._first = True
        self.metrics = {}

    def process(self, left, right) -> bool:
        left = jnp.asarray(left)
        right = jnp.asarray(right)
        if self._first:
            self.state = self._boot(self.state, left, right)
            self._first = False
            return True
        self.state, m = self._step(self.state, left, right)
        self.metrics = {k: int(v) for k, v in m.items()}
        return bool(m["pose_ok"])

    def camera_to_world(self):
        R, t = se3.invert(self.state.R, self.state.t)
        return np.asarray(R), np.asarray(t)
