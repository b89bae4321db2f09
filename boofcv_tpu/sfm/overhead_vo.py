"""Monocular plane VO via a synthetic overhead (bird's-eye) view.

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomMonoOverheadMotion2D.java
+ alg/sfm/overhead/CreateSyntheticOverheadView.java /
OverheadView.java / SelectOverheadParameters.java — with known
plane-to-camera extrinsics, each frame is re-rendered as an orthographic
overhead view of the ground plane (metric cells), 2D rigid motion is
estimated between overhead frames, and the SE2 is lifted back to the
camera's SE3.

Design: the overhead warp is a precomputed gather map applied as one
batched bilinear lookup; frame-to-frame motion is KLT in overhead space +
hypothesis-parallel RANSAC over a 2-point rigid SE2 solver (vmapped
closed form, scored as one [K, N] reduction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.core.pyramid import PyramidConfig
from boofcv_tpu.ip import pyramid_ops
from boofcv_tpu.ip.interpolate import bilinear
from boofcv_tpu.feature import klt, extract, intensity
from boofcv_tpu.geo import robust


class OverheadMap(NamedTuple):
    """Precomputed overhead-pixel -> camera-pixel gather map."""
    map_x: jnp.ndarray   # [OH, OW] f32 source pixel x (or -1 if invalid)
    map_y: jnp.ndarray   # [OH, OW]
    valid: jnp.ndarray   # [OH, OW] bool
    cell: float          # meters per overhead pixel
    center_x: float      # plane x of overhead pixel (0, 0)
    center_z: float      # plane z of overhead pixel (0, 0)


def create_overhead_map(K, R_pc, t_pc, img_h: int, img_w: int,
                        oh: int, ow: int, cell: float,
                        center_x: float, center_z: float) -> OverheadMap:
    """CreateSyntheticOverheadView.configure analog.

    Plane frame: y = 0 is the plane, x right, z forward.  Overhead pixel
    (r, c) corresponds to plane point
      x = center_x + c * cell,   z = center_z + (oh - 1 - r) * cell
    (rows increase towards the camera, matching OverheadView.java).
    (R_pc, t_pc): plane -> camera transform.
    """
    K = jnp.asarray(K, jnp.float64)
    R_pc = jnp.asarray(R_pc, jnp.float64)
    t_pc = jnp.asarray(t_pc, jnp.float64)
    r = jnp.arange(oh, dtype=jnp.float64)
    c = jnp.arange(ow, dtype=jnp.float64)
    rr, cc = jnp.meshgrid(r, c, indexing="ij")
    px = center_x + cc * cell
    pz = center_z + (oh - 1 - rr) * cell
    P = jnp.stack([px, jnp.zeros_like(px), pz], -1)       # [OH, OW, 3]
    Pc = P @ R_pc.T + t_pc
    z = Pc[..., 2]
    u = K[0, 0] * Pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Pc[..., 1] / z + K[1, 2]
    valid = (z > 1e-6) & (u >= 0) & (u <= img_w - 1) & (v >= 0) \
        & (v <= img_h - 1)
    return OverheadMap(u.astype(jnp.float32), v.astype(jnp.float32),
                       valid, float(cell), float(center_x), float(center_z))


@jax.jit
def render_overhead(image, omap: OverheadMap):
    """One gather: camera frame -> overhead view (0 where off-image)."""
    vals = bilinear(jnp.asarray(image, jnp.float32), omap.map_y, omap.map_x)
    return jnp.where(omap.valid, vals, 0.0)


# ---------------------------------------------------------------------------
# Rigid SE2 robust estimation (MotionSe2PointSVD / ImageMotion2D analog)
# ---------------------------------------------------------------------------

def _se2_from_two(sample):
    """Closed-form rigid 2D from 2 correspondences ((p [2,2], q [2,2]))."""
    p, q = sample
    dp = p[1] - p[0]
    dq = q[1] - q[0]
    # rotation aligning dp to dq
    cross = dp[0] * dq[1] - dp[1] * dq[0]
    dot = dp[0] * dq[0] + dp[1] * dq[1]
    ang = jnp.arctan2(cross, dot)
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    pm = (p[0] + p[1]) * 0.5
    qm = (q[0] + q[1]) * 0.5
    tx = qm[0] - (ca * pm[0] - sa * pm[1])
    ty = qm[1] - (sa * pm[0] + ca * pm[1])
    return jnp.stack([ang, tx, ty])


def _se2_apply(model, p):
    ang, tx, ty = model[0], model[1], model[2]
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    x = ca * p[..., 0] - sa * p[..., 1] + tx
    y = sa * p[..., 0] + ca * p[..., 1] + ty
    return jnp.stack([x, y], -1)


def ransac_se2(key, p, q, num_hypotheses: int = 256,
               inlier_threshold_px: float = 2.0, valid_mask=None):
    """Robust rigid SE2 p->q (pixels); returns RansacResult with model
    [angle, tx, ty] plus a weighted least-squares re-fit on the inliers."""
    def scorer(model, pts):
        pp, qq = pts
        d = _se2_apply(model, pp) - qq
        return jnp.sum(d * d, -1)

    res = robust.ransac(key, (p, q), _se2_from_two, scorer, 2,
                        num_hypotheses, inlier_threshold_px ** 2,
                        valid_mask=valid_mask)
    # procrustes re-fit on inliers (MotionSe2PointSVD analog)
    w = res.inliers.astype(jnp.float64)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    pm = jnp.sum(p * w[:, None], 0) / wsum
    qm = jnp.sum(q * w[:, None], 0) / wsum
    pc = (p - pm) * w[:, None]
    qc = q - qm
    sxx = jnp.sum(pc[:, 0] * qc[:, 0] + pc[:, 1] * qc[:, 1])
    sxy = jnp.sum(pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0])
    ang = jnp.arctan2(sxy, sxx)
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    tx = qm[0] - (ca * pm[0] - sa * pm[1])
    ty = qm[1] - (sa * pm[0] + ca * pm[1])
    return res._replace(model=jnp.stack([ang, tx, ty]))


class MonoOverheadVisualOdometry:
    """Host driver.  (R_pc, t_pc): plane->camera extrinsics (plane frame:
    y=0 ground, z forward); cell: meters per overhead pixel."""

    def __init__(self, K, R_pc, t_pc, img_h: int, img_w: int,
                 overhead_shape=(320, 320), cell: float = 0.03,
                 center_x: float | None = None, center_z: float = 0.5,
                 num_tracks: int = 300, scales=(1, 2), seed: int = 0):
        oh, ow = overhead_shape
        if center_x is None:
            center_x = -0.5 * ow * cell
        self.omap = create_overhead_map(K, R_pc, t_pc, img_h, img_w,
                                        oh, ow, cell, center_x, center_z)
        self.oh, self.ow = oh, ow
        self.scales = scales
        self.n = num_tracks
        self.key = jax.random.PRNGKey(seed)
        # plane motion accumulated as SE2 in overhead PIXELS: cur -> first
        self.se2 = np.array([0.0, 0.0, 0.0])
        self.R_pc = np.asarray(R_pc, np.float64)
        self.t_pc = np.asarray(t_pc, np.float64)
        self._prev = None

    def _detect(self, image):
        return extract.detect_tracks(image, max_features=self.n)

    def process(self, image) -> bool:
        over = render_overhead(jnp.asarray(image), self.omap)
        pyr_cfg = PyramidConfig(scales=self.scales)
        pyr = pyramid_ops.pyramid_average(over, pyr_cfg)
        if self._prev is None:
            self._prev = pyr
            ys, xs, valid = self._detect(over)
            grads = pyramid_ops.gradient(pyr)
            self._tmpl = klt.sample_templates(pyr, grads, ys, xs,
                                              self.scales, 3)
            self._tracks = (ys, xs, valid)
            return True

        ys, xs, valid = self._tracks
        cfg = klt.KltConfig(template_radius=3)
        nys, nxs, fault = klt.track_pyramid(pyr, self._tmpl, ys, xs,
                                            self.scales, cfg)
        ok = valid & (fault == klt.TRACK_OK)
        p = jnp.stack([xs, ys], -1).astype(jnp.float64)
        q = jnp.stack([nxs, nys], -1).astype(jnp.float64)
        self.key, sub = jax.random.split(self.key)
        res = ransac_se2(sub, p, q, valid_mask=ok)
        if int(res.num_inliers) < 8:
            return False
        # model maps prev->cur overhead pixels; accumulate cur->first
        ang, tx, ty = [float(v) for v in np.asarray(res.model)]
        a0, x0, y0 = self.se2
        # inverse of (ang, t): (-ang, -R(-ang) t)
        ca, sa = np.cos(-ang), np.sin(-ang)
        ix = -(ca * tx - sa * ty)
        iy = -(sa * tx + ca * ty)
        # compose: first<-prev ∘ prev<-cur
        c0, s0 = np.cos(a0), np.sin(a0)
        self.se2 = np.array([a0 - ang,
                             x0 + c0 * ix - s0 * iy,
                             y0 + s0 * ix + c0 * iy])

        ys2, xs2, valid2 = self._detect(over)
        grads = pyramid_ops.gradient(pyr)
        self._tmpl = klt.sample_templates(pyr, grads, ys2, xs2,
                                          self.scales, 3)
        self._tracks = (ys2, xs2, valid2)
        self._prev = pyr
        return True

    def plane_motion(self):
        """Current camera position on the plane: (x, z, yaw) in meters
        relative to the first frame.

        The accumulated SE2 lives in overhead PIXEL coordinates; plane
        coords are the affine u = A p + b with A = diag(cell, -cell)
        (+col = +x, +row = -z) and b = the plane point of pixel (0, 0).
        Conjugating gives translation A t + (I - R_plane) b — the
        (I - R) b term was previously dropped, so any yaw produced a
        phantom translation of ~|b| * angle (meters).
        """
        ang, tx, ty = self.se2
        cell = self.omap.cell
        bx = self.omap.center_x
        bz = self.omap.center_z + (self.oh - 1) * cell
        ca, sa = np.cos(ang), np.sin(ang)
        x = cell * tx + (1.0 - ca) * bx - sa * bz
        z = -cell * ty + sa * bx + (1.0 - ca) * bz
        return float(x), float(z), float(ang)

    def camera_to_world(self):
        """Camera->world SE3 (world = plane frame at the first frame)."""
        x, z, yaw = self.plane_motion()
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_plane = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0],
                            [-sy, 0.0, cy]])
        t_plane = np.array([x, 0.0, z])
        # camera->plane(now) then plane(now)->plane(first)=world
        R_cp = self.R_pc.T
        t_cp = -self.R_pc.T @ self.t_pc
        return R_plane @ R_cp, R_plane @ t_cp + t_plane
