"""TLD-style long-term object tracker (tracking-learning-detection).

Reference analog: boofcv-recognition alg/tracker/tld/ — TldTracker.java
orchestrating: TldRegionTracker (KLT of an internal grid),
TldVarianceFilter (integral-image variance gate),
TldFernClassifier/TldFernManager (random-fern binary tests),
TldTemplateMatching (NCC nearest-neighbor confirmation),
TldDetection / non-max region selection, TldLearning (P/N updates).

Device/host split: fern bit-tests, variance gates and NCC template scores are
batched device ops over a window grid; the learning bookkeeping (fern
posteriors, template lists with dynamic growth) is host-side numpy, as
in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.ip.interpolate import bilinear


@dataclass
class TldConfig:
    num_ferns: int = 10
    fern_size: int = 8           # bits per fern
    variance_frac: float = 0.5   # min variance vs initial patch
    ncc_confirm: float = 0.6
    track_confirm: float = 0.5   # min fused confidence to stay "found"
    template_size: int = 15
    max_templates: int = 50
    scale_steps: tuple = (0.8, 1.0, 1.25)
    grid_stride: float = 0.1     # window stride as fraction of size
    # full detection pyramid: scales 1.2^k of the INITIAL box size (the
    # reference's TldDetection scans every level of its scale pyramid,
    # so the detector can reacquire after large scale changes)
    pyramid_octaves: int = 5     # k in [-octaves, +octaves]
    max_ncc_candidates: int = 64 # fern survivors scored by NCC per frame


@dataclass
class TldTracker:
    cfg: TldConfig
    rng: np.random.Generator
    fern_pairs: np.ndarray = None      # [F, B, 2, 2] relative sample pts
    posteriors_p: np.ndarray = None    # [F, 2^B] positive counts
    posteriors_n: np.ndarray = None
    pos_templates: list = field(default_factory=list)
    neg_templates: list = field(default_factory=list)
    box: tuple = None                  # (cy, cx, h, w)
    init_var: float = 0.0
    init_size: tuple = None            # (h, w) at initialize (pyramid base)

    # -- patch utilities ---------------------------------------------------
    def _patch(self, image, cy, cx, h, w):
        n = self.cfg.template_size
        ys = jnp.linspace(cy - h / 2, cy + h / 2, n)
        xs = jnp.linspace(cx - w / 2, cx + w / 2, n)
        yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
        p = np.asarray(bilinear(jnp.asarray(image, jnp.float32), yy, xx))
        p = p - p.mean()
        nrm = np.linalg.norm(p) + 1e-9
        return p / nrm

    def _ncc_best(self, patch, templates):
        """Best similarity s = (NCC+1)/2 in [0, 1] (canonical TLD)."""
        if not templates:
            return 0.0
        t = np.stack(templates)
        return float((np.max(np.tensordot(t, patch, axes=2)) + 1.0) / 2.0)

    def _confidence(self, patch):
        sp = self._ncc_best(patch, self.pos_templates)
        sn = self._ncc_best(patch, self.neg_templates)
        return sp / (sp + sn + 1e-9)

    def _fern_codes(self, image, cy, cx, h, w):
        """[F] integer fern codes for one window."""
        img = np.asarray(image)
        H, W = img.shape
        codes = np.zeros(self.cfg.num_ferns, np.int64)
        for f in range(self.cfg.num_ferns):
            code = 0
            for b in range(self.cfg.fern_size):
                (ay, ax), (by, bx) = self.fern_pairs[f, b]
                y1 = int(np.clip(cy + ay * h, 0, H - 1))
                x1 = int(np.clip(cx + ax * w, 0, W - 1))
                y2 = int(np.clip(cy + by * h, 0, H - 1))
                x2 = int(np.clip(cx + bx * w, 0, W - 1))
                code = (code << 1) | int(img[y1, x1] > img[y2, x2])
            codes[f] = code
        return codes

    def _fern_prob(self, codes):
        p = self.posteriors_p[np.arange(self.cfg.num_ferns), codes]
        n = self.posteriors_n[np.arange(self.cfg.num_ferns), codes]
        # Laplace smoothing: unseen codes are neutral (0.5), not negative
        post = (p + 1.0) / (p + n + 2.0)
        return float(post.mean())

    def _learn(self, image, cy, cx, h, w, positive: bool):
        codes = self._fern_codes(image, cy, cx, h, w)
        tgt = self.posteriors_p if positive else self.posteriors_n
        tgt[np.arange(self.cfg.num_ferns), codes] += 1
        patch = self._patch(image, cy, cx, h, w)
        lst = self.pos_templates if positive else self.neg_templates
        if len(lst) < self.cfg.max_templates:
            lst.append(patch)

    # -- public ------------------------------------------------------------
    def initialize(self, image, cy, cx, h, w):
        c = self.cfg
        self.fern_pairs = self.rng.uniform(-0.5, 0.5,
                                           (c.num_ferns, c.fern_size, 2, 2))
        self.posteriors_p = np.zeros((c.num_ferns, 2 ** c.fern_size))
        self.posteriors_n = np.zeros((c.num_ferns, 2 ** c.fern_size))
        self.box = (float(cy), float(cx), float(h), float(w))
        self.init_size = (float(h), float(w))
        img = np.asarray(image, np.float32)
        y0, y1 = int(cy - h / 2), int(cy + h / 2)
        x0, x1 = int(cx - w / 2), int(cx + w / 2)
        self.init_var = float(img[y0:y1, x0:x1].var())
        # several jittered positives (the reference warps the init patch)
        for _ in range(8):
            jy = cy + self.rng.uniform(-0.1, 0.1) * h
            jx = cx + self.rng.uniform(-0.1, 0.1) * w
            js = 1.0 + self.rng.uniform(-0.1, 0.1)
            self._learn(image, jy, jx, h * js, w * js, True)
        # negative samples away from the target
        H, W = img.shape
        for _ in range(10):
            ny = self.rng.uniform(h / 2, H - h / 2)
            nx = self.rng.uniform(w / 2, W - w / 2)
            if abs(ny - cy) > h or abs(nx - cx) > w:
                self._learn(image, ny, nx, h, w, False)
        self._prev_image = img.copy()      # median-flow needs a key frame

    def _fern_codes_batch(self, img, cys, cxs, h, w):
        """[M, F] fern codes for M windows of size (h, w) — vectorized
        fancy-index sampling (the per-window Python loop was the
        detector's wall)."""
        H, W = img.shape
        fp = self.fern_pairs                                  # [F, B, 2, 2]
        y1 = np.clip(cys[:, None, None] + fp[None, :, :, 0, 0] * h,
                     0, H - 1).astype(np.intp)
        x1 = np.clip(cxs[:, None, None] + fp[None, :, :, 0, 1] * w,
                     0, W - 1).astype(np.intp)
        y2 = np.clip(cys[:, None, None] + fp[None, :, :, 1, 0] * h,
                     0, H - 1).astype(np.intp)
        x2 = np.clip(cxs[:, None, None] + fp[None, :, :, 1, 1] * w,
                     0, W - 1).astype(np.intp)
        bits = img[y1, x1] > img[y2, x2]                      # [M, F, B]
        weights = (1 << np.arange(self.cfg.fern_size - 1, -1, -1,
                                  dtype=np.int64))
        return bits @ weights                                  # [M, F]

    def _detect(self, image):
        """Sliding-window cascade over the FULL scale pyramid:
        variance -> ferns -> NCC (TldDetection analog).  Scales are
        1.2^k of the INITIAL box (k in [-octaves, octaves]) so the
        detector reacquires after large scale changes; every stage is
        vectorized over the window grid."""
        img = np.asarray(image, np.float32)
        H, W = img.shape
        h0, w0 = self.init_size
        ii = np.zeros((H + 1, W + 1))
        ii[1:, 1:] = img.cumsum(0).cumsum(1)
        ii2 = np.zeros((H + 1, W + 1))
        ii2[1:, 1:] = (img.astype(np.float64) ** 2).cumsum(0).cumsum(1)

        cand = []                          # (fern_prob, cy, cx, hs, ws)
        ko = self.cfg.pyramid_octaves
        for s in 1.2 ** np.arange(-ko, ko + 1):
            hs, ws = h0 * s, w0 * s
            if hs > H or ws > W or hs < 8 or ws < 8:
                continue
            sy = max(int(hs * self.cfg.grid_stride), 2)
            sx = max(int(ws * self.cfg.grid_stride), 2)
            cys = np.arange(hs / 2, H - hs / 2, sy)
            cxs = np.arange(ws / 2, W - ws / 2, sx)
            if len(cys) == 0 or len(cxs) == 0:
                continue
            gy, gx = np.meshgrid(cys, cxs, indexing="ij")
            gy = gy.ravel()
            gx = gx.ravel()
            y0 = (gy - hs / 2).astype(np.intp)
            x0 = (gx - ws / 2).astype(np.intp)
            y1 = (gy + hs / 2).astype(np.intp)
            x1 = (gx + ws / 2).astype(np.intp)
            area = (y1 - y0) * (x1 - x0)
            sm = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
            sm2 = ii2[y1, x1] - ii2[y0, x1] - ii2[y1, x0] + ii2[y0, x0]
            var = sm2 / area - (sm / area) ** 2
            keep = var >= self.cfg.variance_frac * self.init_var
            if not keep.any():
                continue
            gy, gx = gy[keep], gx[keep]
            codes = self._fern_codes_batch(img, gy, gx, hs, ws)  # [M, F]
            fr = np.arange(self.cfg.num_ferns)
            p = self.posteriors_p[fr[None, :], codes]
            n = self.posteriors_n[fr[None, :], codes]
            prob = ((p + 1.0) / (p + n + 2.0)).mean(axis=1)
            ok = prob >= 0.5
            for i in np.nonzero(ok)[0]:
                cand.append((float(prob[i]), float(gy[i]), float(gx[i]),
                             hs, ws))
        if not cand:
            return None
        # NCC-score the strongest fern survivors only
        cand.sort(reverse=True)
        best = None
        for _, cy, cx, hs, ws in cand[:self.cfg.max_ncc_candidates]:
            patch = self._patch(img, cy, cx, hs, ws)
            conf = self._confidence(patch)
            if conf > self.cfg.ncc_confirm and (
                    best is None or conf > best[0]):
                best = (conf, cy, cx, hs, ws)
        return best

    _prev_image: object = None

    def _track(self, image):
        """Median-flow region tracking with forward-backward validation
        (TldRegionTracker / TldAdjustRegion analog): KLT a point grid
        inside the box forward, track the results backward, keep the
        half with the lowest FB error, move the box by the median
        displacement and rescale by the median pairwise-distance ratio.
        Returns (cy, cx, h, w, confidence) or None.
        """
        from boofcv_tpu.core.pyramid import PyramidConfig
        from boofcv_tpu.feature import klt
        from boofcv_tpu.ip import pyramid_ops

        if self._prev_image is None:
            return None
        cy, cx, h, w = self.box
        g = 5
        gy = np.linspace(cy - 0.4 * h, cy + 0.4 * h, g)
        gx = np.linspace(cx - 0.4 * w, cx + 0.4 * w, g)
        yy, xx = np.meshgrid(gy, gx, indexing="ij")
        ys0 = jnp.asarray(yy.ravel(), jnp.float32)
        xs0 = jnp.asarray(xx.ravel(), jnp.float32)

        scales = (1, 2)
        pcfg = PyramidConfig(scales=scales)
        kcfg = klt.KltConfig(template_radius=3, max_iterations=15)
        prev = jnp.asarray(self._prev_image, jnp.float32)
        cur = jnp.asarray(image, jnp.float32)
        pyr_p = pyramid_ops.pyramid_average(prev, pcfg)
        pyr_c = pyramid_ops.pyramid_average(cur, pcfg)
        grads_p = pyramid_ops.gradient(pyr_p)
        grads_c = pyramid_ops.gradient(pyr_c)

        tmpl = klt.sample_templates(pyr_p, grads_p, ys0, xs0, scales, 3)
        fy, fx, ff = klt.track_pyramid(pyr_c, tmpl, ys0, xs0, scales, kcfg)
        tmpl_b = klt.sample_templates(pyr_c, grads_c, fy, fx, scales, 3)
        by, bx, bf = klt.track_pyramid(pyr_p, tmpl_b, fy, fx, scales, kcfg)

        ok = (np.asarray(ff) == klt.TRACK_OK) \
            & (np.asarray(bf) == klt.TRACK_OK)
        fb = np.hypot(np.asarray(by) - np.asarray(ys0),
                      np.asarray(bx) - np.asarray(xs0))
        if ok.sum() < 6:
            return None
        fb_ok = fb <= np.median(fb[ok])
        keep = ok & fb_ok
        if keep.sum() < 4:
            return None
        y0k, x0k = yy.ravel()[keep], xx.ravel()[keep]
        y1k = np.asarray(fy)[keep]
        x1k = np.asarray(fx)[keep]
        dy = float(np.median(y1k - y0k))
        dx = float(np.median(x1k - x0k))
        # scale: median of pairwise-distance ratios (MedianFlow)
        if keep.sum() >= 2:
            d0 = np.hypot(y0k[:, None] - y0k[None, :],
                          x0k[:, None] - x0k[None, :])
            d1 = np.hypot(y1k[:, None] - y1k[None, :],
                          x1k[:, None] - x1k[None, :])
            iu = np.triu_indices(len(y0k), 1)
            r0, r1 = d0[iu], d1[iu]
            good = r0 > 2.0
            s = float(np.median(r1[good] / r0[good])) if good.any() else 1.0
            s = float(np.clip(s, min(self.cfg.scale_steps),
                              max(self.cfg.scale_steps)))
        else:
            s = 1.0
        ncy, ncx = cy + dy, cx + dx
        nh, nw = h * s, w * s
        H, W = np.asarray(image).shape
        if not (nh / 2 < ncy < H - nh / 2 and nw / 2 < ncx < W - nw / 2):
            return None
        conf = self._confidence(self._patch(image, ncy, ncx, nh, nw))
        return ncy, ncx, nh, nw, conf

    def process(self, image):
        """One frame of TldTracker.process: TRACK (median flow + FB) and
        DETECT (variance -> fern -> NCC cascade) hypotheses are fused —
        a strong detection away from a weak track reacquires the target —
        then P/N learning updates the models.  Returns (found, box)."""
        trk = self._track(image)
        det = self._detect(image)
        cfg = self.cfg

        chosen = None
        if trk is not None:
            ncy, ncx, nh, nw, conf_t = trk
            chosen = (conf_t, ncy, ncx, nh, nw)
        if det is not None:
            conf_d, dcy, dcx, dh, dw = det
            far = chosen is None or (
                abs(dcy - chosen[1]) > 0.5 * chosen[3]
                or abs(dcx - chosen[2]) > 0.5 * chosen[4])
            if chosen is None or (far and conf_d > chosen[0] + 0.05) \
                    or (not far and conf_d > chosen[0]):
                chosen = (conf_d, dcy, dcx, dh, dw)

        self._prev_image = np.asarray(image, np.float32)
        if chosen is None:
            return False, self.box
        conf, cy, cx, h, w = chosen
        # low-confidence hypotheses (occlusion, drift) are neither trusted
        # nor learned from — the reference only learns from confident
        # hypotheses, which keeps the model from training on background
        if conf < cfg.track_confirm:
            return False, self.box
        self.box = (float(cy), float(cx), float(h), float(w))
        # P/N learning: positive at the fused box, gated on a strong
        # confidence so occluded frames don't poison the templates;
        # negatives at windows the detector liked far from it (N-expert)
        if conf >= cfg.ncc_confirm:
            self._learn(image, cy, cx, h, w, True)
        if det is not None:
            _, dcy, dcx, dh, dw = det
            if abs(dcy - cy) > h or abs(dcx - cx) > w:
                self._learn(image, dcy, dcx, dh, dw, False)
        return True, self.box



def make_tracker(cfg: TldConfig | None = None, seed: int = 0) -> TldTracker:
    return TldTracker(cfg or TldConfig(), np.random.default_rng(seed))
