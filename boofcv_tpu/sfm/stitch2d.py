"""2D image stitching / video mosaic.

Reference analog: boofcv-sfm alg/sfm/d2/ — StitchingFromMotion2D.java
(incremental mosaic via tracked 2D motion models),
ImageMotionPointTrackerKey.java (key-frame tracker + robust model fit).

Design: KLT tracks frame-to-frame, a robust homography (RANSAC over
the matmul-scored matches) accumulates into mosaic-from-frame transforms,
and each frame is warped+blended into the mosaic canvas with one fused
gather — the whole per-frame pipeline is device work, the keyframe logic
is host-side like the reference's.
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


class Stitcher:
    """Host driver (StitchingFromMotion2D analog)."""

    def __init__(self, mosaic_h: int, mosaic_w: int, offset=(0.0, 0.0),
                 num_tracks: int = 300, scales=(1, 2, 4),
                 ransac_hypotheses: int = 256, inlier_px: float = 2.0,
                 retrack_below: float = 0.5, seed: int = 0):
        self.shape = (mosaic_h, mosaic_w)
        self.offset = np.asarray(offset)   # where frame0's origin lands
        self.scales = scales
        self.n = num_tracks
        self.key = jax.random.PRNGKey(seed)
        self.hyp = ransac_hypotheses
        self.inlier_px = inlier_px
        self.retrack_below = retrack_below
        self.H_mosaic_from_frame = np.eye(3)
        self.mosaic = jnp.zeros(self.shape, jnp.float32)
        self.weight = jnp.zeros(self.shape, jnp.float32)
        self._prev = None
        self._tracks = None
        self._n_detected = 0.0

    # ---- device helpers -------------------------------------------------
    def _detect(self, image):
        ys, xs, valid = extract.detect_tracks(image, max_features=self.n)
        self._n_detected = float(jnp.sum(valid.astype(jnp.float32)))
        return ys, xs, valid

    def _track(self, pyr_prev, pyr_cur, ys, xs):
        grads = pyramid_ops.gradient(pyr_prev)
        cfg = klt.KltConfig(template_radius=3, max_iterations=20)
        tmpl = klt.sample_templates(pyr_prev, grads, ys, xs, self.scales,
                                    cfg.template_radius)
        nys, nxs, fault = klt.track_pyramid(pyr_cur, tmpl, ys, xs,
                                            self.scales, cfg)
        return nys, nxs, fault == klt.TRACK_OK

    def _blend(self, image, H_frame_to_mosaic):
        """Warp frame into mosaic canvas and average-blend."""
        Hm = jnp.asarray(np.linalg.inv(H_frame_to_mosaic), jnp.float32)
        h, w = self.shape
        ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                              jnp.arange(w, dtype=jnp.float32), indexing="ij")
        pts = jnp.stack([xs, ys, jnp.ones_like(xs)], -1) @ Hm.T
        z = pts[..., 2]
        z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        fx = pts[..., 0] / z
        fy = pts[..., 1] / z
        ih, iw = image.shape
        inb = (fx >= 0) & (fx <= iw - 1) & (fy >= 0) & (fy <= ih - 1)
        vals = bilinear(jnp.asarray(image, jnp.float32), fy, fx)
        self.mosaic = self.mosaic + jnp.where(inb, vals, 0.0)
        self.weight = self.weight + inb.astype(jnp.float32)

    # ---- public ---------------------------------------------------------
    def process(self, image) -> bool:
        image = jnp.asarray(image, jnp.float32)
        pyr_cfg = PyramidConfig(scales=self.scales)
        pyr = pyramid_ops.pyramid_average(image, pyr_cfg)
        if self._prev is None:
            T = np.eye(3)
            T[0, 2], T[1, 2] = self.offset
            self.H_mosaic_from_frame = T
            self._blend(image, T)
            ys, xs, valid = self._detect(image)
            self._tracks = (ys, xs, valid)
            self._prev = pyr
            return True

        ys, xs, valid = self._tracks
        nys, nxs, ok = self._track(self._prev, pyr, ys, xs)
        ok = ok & valid
        p1 = jnp.stack([xs, ys], -1)
        p2 = jnp.stack([nxs, nys], -1)
        self.key, sub = jax.random.split(self.key)
        res = robust.ransac_homography(sub, p1.astype(jnp.float64),
                                       p2.astype(jnp.float64),
                                       num_hypotheses=self.hyp,
                                       inlier_threshold_px=self.inlier_px,
                                       valid_mask=ok)
        if int(res.num_inliers) < 8:
            return False
        H_cur_from_prev = np.asarray(res.model)
        self.H_mosaic_from_frame = (
            self.H_mosaic_from_frame @ np.linalg.inv(H_cur_from_prev))
        self._blend(image, self.H_mosaic_from_frame)

        # fraction of the tracks valid at the last detection still
        # inlying (a mean over the fixed capacity made feature-sparse
        # scenes re-detect every frame even with 100% of real tracks
        # surviving; a fraction of the previous frame's survivors let
        # slow attrition starve the pool without ever re-detecting)
        alive_frac = float(jnp.sum((ok & res.inliers).astype(jnp.float32))
                           ) / max(self._n_detected, 1.0)
        if alive_frac < self.retrack_below:
            self._tracks = self._detect(image)
        else:
            self._tracks = (nys, nxs, ok & res.inliers)
        self._prev = pyr
        return True

    def image(self):
        w = jnp.maximum(self.weight, 1.0)
        return np.asarray(self.mosaic / w)
