"""Unified point-tracker interface + implementations.

Reference analog: boofcv-geo abst/feature/tracker/ —
PointTracker.java:60 (process/spawn/drop API with track lists),
PointTrackerKltPyramid.java:41 (pyramidal KLT tracker),
DetectDescribeAssociate.java:42 (DDA tracker), and the combined
KLT+re-detection hybrid (CombinedTrackerScalePoint).

Design: every implementation owns a fixed-capacity device pool
(positions, uids, alive mask); the host-facing API returns numpy views of
active tracks like the reference's getActiveTracks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.core.pyramid import PyramidConfig
from boofcv_tpu.ip import pyramid_ops, integral as ii_ops
from boofcv_tpu.feature import klt, extract, intensity, fasthessian, describe, associate


@dataclass
class Track:
    uid: int
    x: float
    y: float


class PointTracker:
    """Interface (PointTracker.java): process -> active tracks; spawn."""

    def process(self, image) -> None:
        raise NotImplementedError

    def spawn(self) -> None:
        raise NotImplementedError

    def active_tracks(self) -> list:
        raise NotImplementedError


class PointTrackerKlt(PointTracker):
    """Pyramidal KLT point tracker (PointTrackerKltPyramid analog)."""

    def __init__(self, max_tracks: int = 400, scales=(1, 2, 4),
                 template_radius: int = 3, detect_radius: int = 5):
        self.n = max_tracks
        self.scales = scales
        self.cfg = klt.KltConfig(template_radius=template_radius)
        self.detect_radius = detect_radius
        self.xs = jnp.zeros((max_tracks,), jnp.float32)
        self.ys = jnp.zeros((max_tracks,), jnp.float32)
        self.alive = jnp.zeros((max_tracks,), bool)
        self.uid = np.full(max_tracks, -1, np.int64)
        self._next_uid = 0
        self._pyr = None
        self._tmpl = None

    def process(self, image) -> None:
        img = jnp.asarray(image, jnp.float32)
        pyr = pyramid_ops.pyramid_average(img, PyramidConfig(scales=self.scales))
        if self._pyr is not None and bool(jnp.any(self.alive)):
            nys, nxs, fault = klt.track_pyramid(
                pyr, self._tmpl, self.ys, self.xs, self.scales, self.cfg)
            ok = self.alive & (fault == klt.TRACK_OK)
            self.xs = jnp.where(ok, nxs, self.xs)
            self.ys = jnp.where(ok, nys, self.ys)
            self.alive = ok
        self._pyr = pyr

    def spawn(self) -> None:
        if self._pyr is None:
            return
        img = self._pyr[0]
        inten = intensity.shi_tomasi(img, radius=2)
        det = extract.detect(inten, max_features=self.n,
                             radius=self.detect_radius, threshold=1.0,
                             border=self.cfg.template_radius *
                             self.scales[-1] + 2)
        cy = det.ys.astype(jnp.float32)
        cx = det.xs.astype(jnp.float32)
        ok = det.valid
        d2 = ((cx[:, None] - self.xs[None, :]) ** 2
              + (cy[:, None] - self.ys[None, :]) ** 2)
        d2 = jnp.where(self.alive[None, :], d2, jnp.inf)
        ok = ok & (jnp.min(d2, axis=1) > (2 * self.detect_radius) ** 2)
        # host-side fill of dead slots (spawn runs rarely)
        ok_np = np.asarray(ok)
        cy_np = np.asarray(cy)
        cx_np = np.asarray(cx)
        alive = np.asarray(self.alive).copy()
        xs = np.asarray(self.xs).copy()
        ys = np.asarray(self.ys).copy()
        dead = np.nonzero(~alive)[0]
        cands = np.nonzero(ok_np)[0]
        take = min(len(dead), len(cands))
        for s, c in zip(dead[:take], cands[:take]):
            xs[s] = cx_np[c]
            ys[s] = cy_np[c]
            alive[s] = True
            self.uid[s] = self._next_uid
            self._next_uid += 1
        self.xs = jnp.asarray(xs)
        self.ys = jnp.asarray(ys)
        self.alive = jnp.asarray(alive)
        grads = pyramid_ops.gradient(self._pyr)
        self._tmpl = klt.sample_templates(self._pyr, grads, self.ys, self.xs,
                                          self.scales,
                                          self.cfg.template_radius)

    def active_tracks(self) -> list:
        alive = np.asarray(self.alive)
        xs = np.asarray(self.xs)
        ys = np.asarray(self.ys)
        return [Track(int(self.uid[i]), float(xs[i]), float(ys[i]))
                for i in np.nonzero(alive)[0]]


class PointTrackerDda(PointTracker):
    """Detect-describe-associate tracker (DetectDescribeAssociate analog):
    SURF detect/describe each frame, mutual-NN association to the track
    pool's descriptors."""

    def __init__(self, max_tracks: int = 300, max_error: float = 0.4):
        self.n = max_tracks
        self.max_error = max_error
        self.desc = None          # [N, 64]
        self.xs = np.zeros(max_tracks)
        self.ys = np.zeros(max_tracks)
        self.alive = np.zeros(max_tracks, bool)
        self.uid = np.full(max_tracks, -1, np.int64)
        self._next_uid = 0
        self._frame = None

    def _detect(self, image):
        ii = ii_ops.transform(jnp.asarray(image, jnp.float32))
        det = fasthessian.detect_multi_octave(
            ii, max_features_per_octave=self.n // 2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs, det.scales)
        d = describe.surf(ii, det.ys, det.xs, det.scales, ang)
        v = np.asarray(det.valid)
        return (np.asarray(det.ys)[v], np.asarray(det.xs)[v],
                np.asarray(d)[v])

    def process(self, image) -> None:
        ys, xs, desc = self._detect(image)
        self._frame = (ys, xs, desc)
        if self.desc is None or not self.alive.any():
            return
        pool = jnp.asarray(self.desc[self.alive], jnp.float32)
        scores = associate.score_euclidean_sq(pool, jnp.asarray(desc, jnp.float32))
        m = associate.associate_mutual(scores, max_error=self.max_error ** 2)
        src = np.asarray(m.src)
        dst = np.asarray(m.dst)
        mv = np.asarray(m.valid)
        alive_idx = np.nonzero(self.alive)[0]
        new_alive = np.zeros_like(self.alive)
        for s, d_, v in zip(src, dst, mv):
            if not v:
                continue
            slot = alive_idx[s]
            self.xs[slot] = xs[d_]
            self.ys[slot] = ys[d_]
            self.desc[slot] = desc[d_]
            new_alive[slot] = True
        self.alive = new_alive

    def spawn(self) -> None:
        if self._frame is None:
            return
        ys, xs, desc = self._frame
        if self.desc is None:
            self.desc = np.zeros((self.n, desc.shape[1]), np.float32)
        dead = np.nonzero(~self.alive)[0]
        # avoid duplicating live tracks
        live = np.nonzero(self.alive)[0]
        for i in range(len(ys)):
            if len(dead) == 0:
                break
            if live.size:
                d2 = (self.xs[live] - xs[i]) ** 2 + (self.ys[live] - ys[i]) ** 2
                if d2.min() < 25.0:
                    continue
            s, dead = dead[0], dead[1:]
            self.xs[s] = xs[i]
            self.ys[s] = ys[i]
            self.desc[s] = desc[i]
            self.alive[s] = True
            self.uid[s] = self._next_uid
            self._next_uid += 1

    def active_tracks(self) -> list:
        return [Track(int(self.uid[i]), float(self.xs[i]), float(self.ys[i]))
                for i in np.nonzero(self.alive)[0]]


class PointTrackerCombined(PointTrackerKlt):
    """KLT + detect-describe re-association hybrid
    (CombinedTrackerScalePoint analog): KLT drives frame-to-frame motion;
    tracks the KLT drops are re-acquired by matching their spawn-time
    SURF descriptors against the current frame's detections."""

    def __init__(self, max_tracks: int = 400, scales=(1, 2, 4),
                 template_radius: int = 3, detect_radius: int = 5,
                 reassociate_error: float = 0.35):
        super().__init__(max_tracks, scales, template_radius, detect_radius)
        self.desc = np.zeros((max_tracks, 64), np.float32)
        self.has_desc = np.zeros(max_tracks, bool)
        self.max_error = reassociate_error

    def process(self, image) -> None:
        was_alive = np.asarray(self.alive).copy()
        super().process(image)
        lost = was_alive & ~np.asarray(self.alive) & self.has_desc
        if not lost.any():
            return
        # re-detection pass: describe the current frame, match lost tracks
        img = self._pyr[0]
        ii = ii_ops.transform(img)
        det = fasthessian.detect_multi_octave(
            ii, max_features_per_octave=self.n // 2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        d = describe.surf(ii, det.ys, det.xs, det.scales, ang)
        lost_idx = np.nonzero(lost)[0]
        scores = associate.score_euclidean_sq(
            jnp.asarray(self.desc[lost_idx]), d.astype(jnp.float32))
        m = associate.associate_mutual(scores, valid_b=det.valid,
                                       max_error=self.max_error ** 2)
        mv = np.asarray(m.valid)
        dst = np.asarray(m.dst)
        dy = np.asarray(det.ys)
        dx = np.asarray(det.xs)
        xs = np.asarray(self.xs).copy()
        ys = np.asarray(self.ys).copy()
        alive = np.asarray(self.alive).copy()
        recovered = False
        for k, slot in enumerate(lost_idx):
            if not mv[k]:
                continue
            xs[slot] = dx[dst[k]]
            ys[slot] = dy[dst[k]]
            alive[slot] = True
            recovered = True
        if recovered:
            self.xs = jnp.asarray(xs)
            self.ys = jnp.asarray(ys)
            self.alive = jnp.asarray(alive)
            grads = pyramid_ops.gradient(self._pyr)
            self._tmpl = klt.sample_templates(
                self._pyr, grads, self.ys, self.xs, self.scales,
                self.cfg.template_radius)

    def spawn(self) -> None:
        """Spawn from Fast-Hessian detections so every track carries a
        scale-consistent SURF descriptor for later re-association (the
        reference's combined tracker spawns from its DDA detector too)."""
        if self._pyr is None:
            return
        img = self._pyr[0]
        ii = ii_ops.transform(img)
        det = fasthessian.detect_multi_octave(
            ii, max_features_per_octave=self.n // 2)
        ang = describe.orientation_average_haar(ii, det.ys, det.xs,
                                                det.scales)
        d = np.asarray(describe.surf(ii, det.ys, det.xs, det.scales, ang),
                       np.float32)
        dy = np.asarray(det.ys)
        dx = np.asarray(det.xs)
        dv = np.asarray(det.valid)
        xs = np.asarray(self.xs).copy()
        ys = np.asarray(self.ys).copy()
        alive = np.asarray(self.alive).copy()
        h, w = img.shape
        b = self.cfg.template_radius * self.scales[-1] + 2
        dead = list(np.nonzero(~alive)[0])
        live = np.nonzero(alive)[0]
        for i in np.nonzero(dv)[0]:
            if not dead:
                break
            if not (b <= dy[i] < h - b and b <= dx[i] < w - b):
                continue
            if live.size:
                d2 = (xs[live] - dx[i]) ** 2 + (ys[live] - dy[i]) ** 2
                if d2.min() < (2 * self.detect_radius) ** 2:
                    continue
            s = dead.pop(0)
            xs[s] = dx[i]
            ys[s] = dy[i]
            alive[s] = True
            self.desc[s] = d[i]
            self.has_desc[s] = True
            self.uid[s] = self._next_uid
            self._next_uid += 1
        self.xs = jnp.asarray(xs)
        self.ys = jnp.asarray(ys)
        self.alive = jnp.asarray(alive)
        grads = pyramid_ops.gradient(self._pyr)
        self._tmpl = klt.sample_templates(self._pyr, grads, self.ys,
                                          self.xs, self.scales,
                                          self.cfg.template_radius)


class PointTrackerTwoPassKlt(PointTrackerKlt):
    """Two-pass KLT tracker (abst/feature/tracker/PointTrackerTwoPass.java
    + PointTrackerTwoPassKltPyramid): the first pass tracks from the
    previous positions; the caller (a VO) estimates motion from the
    provisional tracks and calls :meth:`second_pass` with predicted
    positions, re-tracking hard cases from much better initial guesses;
    :meth:`finish` commits the result."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending = None      # (xs, ys, alive) awaiting finish()
        self._cur_pyr = None

    def process(self, image) -> None:
        img = jnp.asarray(image, jnp.float32)
        pyr = pyramid_ops.pyramid_average(
            img, PyramidConfig(scales=self.scales))
        self._cur_pyr = pyr
        if self._pyr is not None and bool(jnp.any(self.alive)):
            nys, nxs, fault = klt.track_pyramid(
                pyr, self._tmpl, self.ys, self.xs, self.scales, self.cfg)
            ok = self.alive & (fault == klt.TRACK_OK)
            self._pending = (jnp.where(ok, nxs, self.xs),
                             jnp.where(ok, nys, self.ys), ok)
        else:
            # first frame: nothing to track, commit immediately so
            # spawn() can sample templates from it
            self._pyr = pyr
            self._pending = (self.xs, self.ys, self.alive)

    def second_pass(self, pred_ys, pred_xs) -> None:
        """Re-track every slot starting from the caller's predictions
        (e.g. reprojections through the estimated motion)."""
        if self._cur_pyr is None or self._tmpl is None:
            return
        nys, nxs, fault = klt.track_pyramid(
            self._cur_pyr, self._tmpl,
            jnp.asarray(pred_ys, jnp.float32),
            jnp.asarray(pred_xs, jnp.float32), self.scales, self.cfg)
        ok2 = self.alive & (fault == klt.TRACK_OK)
        xs1, ys1, ok1 = self._pending
        # the hinted pass REPLACES the first pass (the reference's
        # performSecondPass re-tracks everything from the predictions;
        # a first pass beyond the motion range converges to false minima,
        # so it only survives where the hinted pass fails)
        self._pending = (jnp.where(ok2, nxs, jnp.where(ok1, xs1, self.xs)),
                         jnp.where(ok2, nys, jnp.where(ok1, ys1, self.ys)),
                         ok1 | ok2)

    def finish(self) -> None:
        """Commit the (possibly second-pass-improved) track update."""
        xs, ys, ok = self._pending
        self.xs = xs
        self.ys = ys
        self.alive = ok
        self._pyr = self._cur_pyr
        self._pending = None
