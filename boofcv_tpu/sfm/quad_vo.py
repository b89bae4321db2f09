"""Quad-matching stereo visual odometry (detect/describe, no tracker).

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomQuadPnP.java:62,173 —
features are detected/described in all four images of two consecutive
stereo pairs (L0,R0 previous; L1,R1 current), associated left-right with
an epipolar constraint and previous-current per camera; features matched
consistently around the quad are triangulated in the previous frame and
motion is estimated with RANSAC-PnP, relative to the left camera.

Design: each association is one descriptor score matrix (one matmul)
(with the epipolar gate folded in as an additive mask) + mutual-NN
argmins; the quad-consistency check is pure index chaining on fixed-
capacity feature sets; triangulation and RANSAC-P3P run batched exactly
as in sfm/stereo_vo.py.  The whole per-frame update is one jitted step.

Assumes a rectified stereo pair (as sfm/stereo_vo.py does) so the
left-right epipolar gate is a row check and stereo 3D is disparity-based.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.feature import associate, describe, fasthessian
from boofcv_tpu.geo import robust, se3
from boofcv_tpu.geo.rectify import pixel_to_3d_rectified
from boofcv_tpu.ip import integral


@dataclass(frozen=True)
class QuadVoConfig:
    num_features: int = 256
    max_disparity: float = 96.0
    epipolar_tol_px: float = 2.0        # |yL - yR| gate (rectified rows)
    max_match_error: float = 0.35       # SURF descriptor distance gate
    # (compared as squared euclidean internally)
    ransac_hypotheses: int = 256
    inlier_threshold_px: float = 1.5
    refine_iterations: int = 10


class FrameFeatures(NamedTuple):
    """One image's fixed-capacity detection set."""
    ys: jnp.ndarray      # [N] f32
    xs: jnp.ndarray      # [N] f32
    desc: jnp.ndarray    # [N, 64] f32 SURF
    valid: jnp.ndarray   # [N] bool


class QuadVoState(NamedTuple):
    left: FrameFeatures
    right: FrameFeatures
    lr_dst: jnp.ndarray    # [N] int32: left i -> right index (prev pair)
    lr_ok: jnp.ndarray     # [N] bool stereo match validity
    R: jnp.ndarray         # [3,3] f64 world->left-camera
    t: jnp.ndarray         # [3] f64
    key: jnp.ndarray


def detect_describe(image, n: int) -> FrameFeatures:
    """SURF detect+describe on one image (DetectDescribeMulti analog)."""
    ii = integral.transform(image.astype(jnp.float32))
    det = fasthessian.detect(ii, max_features=n)
    desc = describe.surf(ii, det.ys, det.xs, det.scales)
    return FrameFeatures(det.ys.astype(jnp.float32),
                         det.xs.astype(jnp.float32),
                         desc.astype(jnp.float32), det.valid)


def _stereo_match(l: FrameFeatures, r: FrameFeatures, cfg: QuadVoConfig):
    """Left->right epipolar-gated mutual-NN (assocL2R analog)."""
    s = associate.score_euclidean_sq(l.desc, r.desc)
    disp = l.xs[:, None] - r.xs[None, :]
    same_row = jnp.abs(l.ys[:, None] - r.ys[None, :]) <= cfg.epipolar_tol_px
    gate = same_row & (disp > 0.1) & (disp < cfg.max_disparity)
    s = jnp.where(gate, s, jnp.float32(jnp.finfo(jnp.float32).max))
    return associate.associate_mutual(s, l.valid, r.valid,
                                      max_error=cfg.max_match_error ** 2)


def _frame_match(a: FrameFeatures, b: FrameFeatures, cfg: QuadVoConfig):
    """Previous->current mutual-NN for the same camera (assocSame analog)."""
    s = associate.score_euclidean_sq(a.desc, b.desc)
    return associate.associate_mutual(s, a.valid, b.valid,
                                      max_error=cfg.max_match_error ** 2)


def init_state(cfg: QuadVoConfig, seed: int = 0) -> QuadVoState:
    n = cfg.num_features
    empty = FrameFeatures(jnp.zeros((n,), jnp.float32),
                          jnp.zeros((n,), jnp.float32),
                          jnp.zeros((n, 64), jnp.float32),
                          jnp.zeros((n,), bool))
    return QuadVoState(empty, empty,
                       jnp.zeros((n,), jnp.int32), jnp.zeros((n,), bool),
                       jnp.eye(3, dtype=jnp.float64),
                       jnp.zeros((3,), jnp.float64),
                       jax.random.PRNGKey(seed))


def make_step(cfg: QuadVoConfig, rectK, baseline: float):
    fx = float(rectK[0, 0])
    fy = float(rectK[1, 1])
    cx = float(rectK[0, 2])
    cy = float(rectK[1, 2])
    rectK = jnp.asarray(rectK, jnp.float64)
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2

    @jax.jit
    def step(state: QuadVoState, left, right):
        n = cfg.num_features
        l1 = detect_describe(left, n)
        r1 = detect_describe(right, n)

        m_lr1 = _stereo_match(l1, r1, cfg)          # current stereo pair
        m_l01 = _frame_match(state.left, l1, cfg)   # left prev->cur
        m_r01 = _frame_match(state.right, r1, cfg)  # right prev->cur

        # quad chain per previous-left feature i (camera numbering as in
        # VisOdomQuadPnP: 0=L0 1=R0 2=L1 3=R1):
        #   i --lr0--> j0 (R0), i --l01--> i1 (L1), i1 --lr1--> j1 (R1)
        # consistent iff R0's prev->cur match lands on the same j1.
        i1 = m_l01.dst
        j0 = state.lr_dst
        j1 = m_lr1.dst[i1]
        quad_ok = (state.lr_ok & m_l01.valid & m_lr1.valid[i1]
                   & m_r01.valid[j0] & (m_r01.dst[j0] == j1))

        # triangulate in the previous LEFT camera frame (rectified stereo)
        disp = state.left.xs - state.right.xs[j0]
        Xp = pixel_to_3d_rectified(state.left.xs.astype(jnp.float64),
                                   state.left.ys.astype(jnp.float64),
                                   disp.astype(jnp.float64), rectK, baseline)
        quad_ok &= disp > 0.1

        # motion: world = previous-left-camera frame, obs = current left
        obs = jnp.stack([(l1.xs[i1] - cx) / fx,
                         (l1.ys[i1] - cy) / fy], -1).astype(jnp.float64)
        key, sub = jax.random.split(state.key)
        res, (Rd, td) = robust.ransac_pnp(
            sub, Xp, obs, num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=quad_ok,
            refine_iterations=cfg.refine_iterations)
        ok = res.num_inliers >= 6
        # (Rd, td) maps prev-left -> cur-left; world->cur = delta ∘ world->prev
        Rn, tn = se3.compose(Rd, td, state.R, state.t)
        Rn = jnp.where(ok, Rn, state.R)
        tn = jnp.where(ok, tn, state.t)

        new_state = QuadVoState(l1, r1, m_lr1.dst, m_lr1.valid, Rn, tn, key)
        metrics = {"quads": jnp.sum(quad_ok), "inliers": res.num_inliers,
                   "pose_ok": ok}
        return new_state, metrics

    return step


def make_bootstrap(cfg: QuadVoConfig):
    @jax.jit
    def boot(state: QuadVoState, left, right):
        n = cfg.num_features
        l0 = detect_describe(left, n)
        r0 = detect_describe(right, n)
        m = _stereo_match(l0, r0, cfg)
        return state._replace(left=l0, right=r0, lr_dst=m.dst, lr_ok=m.valid)
    return boot


class QuadVisualOdometry:
    """Host driver (abst StereoVisualOdometry analog for the quad method)."""

    def __init__(self, cfg: QuadVoConfig, rectK, baseline: float,
                 seed: int = 0):
        self.cfg = cfg
        self._step = make_step(cfg, np.asarray(rectK), float(baseline))
        self._boot = make_bootstrap(cfg)
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
