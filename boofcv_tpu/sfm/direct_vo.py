"""Direct (dense photometric) RGB-D visual odometry.

Reference analog: boofcv-sfm alg/sfm/d3/direct/VisOdomDirectColorDepth.java
— photometric Gauss-Newton on an RGB-D pyramid: minimize
sum_p (I_cur(warp(p, xi)) - I_key(p))^2 over the se(3) increment.

Design: this is the most batch-friendly VO — each GN iteration is a
dense warp (block gather) + dense reductions over every valid pixel;
coarse-to-fine over the pyramid; all under one jit.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.core.pyramid import PyramidConfig
from boofcv_tpu.ip import pyramid_ops
from boofcv_tpu.ip.interpolate import bilinear
from boofcv_tpu.geo import se3


def _level_K(K, scale):
    K = np.asarray(K, np.float64).copy()
    Ks = K.copy()
    Ks[0, 0] /= scale
    Ks[1, 1] /= scale
    Ks[0, 2] = (K[0, 2] + 0.5) / scale - 0.5
    Ks[1, 2] = (K[1, 2] + 0.5) / scale - 0.5
    return Ks


def make_direct_step(K, scales=(1, 2, 4), iterations_per_level: int = 10,
                     min_depth: float = 1e-3):
    """Jitted relative-pose estimator between a keyframe (gray+depth) and
    the current gray image.

    Returns fn(key_gray, key_depth, cur_gray, R0, t0) -> (R, t, rmse):
    (R, t) maps keyframe camera coords to current camera coords.
    """
    pyr_cfg = PyramidConfig(scales=tuple(scales))
    Ks = [_level_K(K, s) for s in scales]

    @jax.jit
    def estimate(key_gray, key_depth, cur_gray, R0, t0):
        kg = key_gray.astype(jnp.float32)
        cg = cur_gray.astype(jnp.float32)
        kp = pyramid_ops.pyramid_average(kg, pyr_cfg)
        cp = pyramid_ops.pyramid_average(cg, pyr_cfg)
        # depth pyramid: stride sampling (depth is piecewise smooth)
        dp = [key_depth.astype(jnp.float32)[::s, ::s] for s in scales]

        R, t = R0.astype(jnp.float64), t0.astype(jnp.float64)
        rmse = jnp.float64(0.0)
        for lvl in range(len(scales) - 1, -1, -1):
            Kl = jnp.asarray(Ks[lvl])
            fx, fy = Kl[0, 0], Kl[1, 1]
            cx, cy = Kl[0, 2], Kl[1, 2]
            img_k = kp[lvl]
            img_c = cp[lvl]
            depth = dp[lvl][: img_k.shape[0], : img_k.shape[1]]
            h, w = img_k.shape
            ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float64),
                                  jnp.arange(w, dtype=jnp.float64),
                                  indexing="ij")
            z = depth.astype(jnp.float64)
            valid0 = z > min_depth
            X = jnp.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1)

            def residual(xi, R, t):
                dR, dt = se3.exp_se3(xi)
                Rc, tc = se3.compose(dR, dt, R, t)
                Xc = X @ Rc.T + tc
                zc = jnp.maximum(Xc[..., 2], 1e-6)
                u = Xc[..., 0] / zc * fx + cx
                v = Xc[..., 1] / zc * fy + cy
                inb = (u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2) & \
                    valid0 & (Xc[..., 2] > min_depth)
                warped = bilinear(img_c, v.astype(jnp.float32),
                                  u.astype(jnp.float32))
                r = (warped - img_k).astype(jnp.float64)
                wgt = inb.astype(jnp.float64)
                return r * wgt, wgt

            def gn_iter(_, state):
                R, t = state
                xi0 = jnp.zeros((6,), jnp.float64)
                # jacobian via jvp along the 6 basis directions (forward
                # mode, dense images — 6 extra warps)
                r0, wgt = residual(xi0, R, t)

                def jdir(i):
                    e = jnp.zeros((6,), jnp.float64).at[i].set(1.0)
                    _, jv = jax.jvp(lambda x: residual(x, R, t)[0], (xi0,), (e,))
                    return jv

                J = jnp.stack([jdir(i) for i in range(6)], axis=-1)  # [H,W,6]
                Jf = J.reshape(-1, 6)
                rf = r0.reshape(-1)
                H6 = Jf.T @ Jf + 1e-6 * jnp.eye(6, dtype=jnp.float64)
                g = Jf.T @ rf
                from boofcv_tpu.geo.smalllinalg import solve_spd
                dx = -solve_spd(H6, g)
                dR, dt = se3.exp_se3(dx)
                return se3.compose(dR, dt, R, t)

            R, t = lax.fori_loop(0, iterations_per_level, gn_iter, (R, t))
            r0, wgt = residual(jnp.zeros((6,), jnp.float64), R, t)
            rmse = jnp.sqrt(jnp.sum(r0 * r0) / jnp.maximum(jnp.sum(wgt), 1.0))
        return R, t, rmse

    return estimate


class DirectDepthVisualOdometry:
    """Keyframe-based driver: accumulates world pose, re-keys when the
    photometric overlap degrades."""

    def __init__(self, K, scales=(1, 2, 4), rekey_rmse: float = 20.0):
        self._est = make_direct_step(K, scales)
        self.rekey_rmse = rekey_rmse
        self.R_wk = np.eye(3)       # keyframe->world
        self.t_wk = np.zeros(3)
        self._key = None
        self.R_cw = np.eye(3)       # world->current
        self.t_cw = np.zeros(3)

    def process(self, gray, depth) -> bool:
        if self._key is None:
            self._key = (jnp.asarray(gray), jnp.asarray(depth))
            return True
        kg, kd = self._key
        # warm-start from the last key->cur estimate: far from the
        # keyframe the photometric GN otherwise re-converges from
        # identity each frame and can stall in a local minimum
        R_kw = self.R_wk.T
        t_kw = -R_kw @ self.t_wk
        R0 = self.R_cw @ self.R_wk
        t0 = self.R_cw @ self.t_wk + self.t_cw
        R, t, rmse = self._est(kg, kd, jnp.asarray(gray),
                               jnp.asarray(R0), jnp.asarray(t0))
        R = np.asarray(R)
        t = np.asarray(t)
        self.last_rmse = float(rmse)
        # world->cur = (key->cur) ∘ (world->key)
        self.R_cw = R @ R_kw
        self.t_cw = R @ t_kw + t
        if float(rmse) > self.rekey_rmse:
            # re-key at current frame
            self.R_wk = self.R_cw.T
            self.t_wk = -self.R_cw.T @ self.t_cw
            self._key = (jnp.asarray(gray), jnp.asarray(depth))
        return bool(np.isfinite(rmse))

    def camera_to_world(self):
        return self.R_cw.T, -self.R_cw.T @ self.t_cw
