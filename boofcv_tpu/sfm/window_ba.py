"""Sliding-window bundle adjustment for visual odometry.

Reference analog: none in the reference (its VO refines only the current
pose) — this is the north-star "sliding-window local bundle adjustment"
from BASELINE.json config 4: the last W keyframes' poses and their shared
tracks are jointly refined with the LM-Schur solver.

Host-side ring buffer keyed by the VO track pool's stable uids; the BA
problem is assembled in the dense [P, L<=W] layout and solved on device.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.geo import ba


class SlidingWindowBA:
    def __init__(self, window: int = 8, min_track_len: int = 2,
                 iterations: int = 8):
        self.window = window
        self.min_track_len = min_track_len
        self.iterations = iterations
        self.frames: list = []      # dicts: R, t, uids, obs (normalized)
        self.world: OrderedDict = OrderedDict()  # uid -> xyz (latest)

    def push(self, state, fx: float, fy: float, cx: float, cy: float):
        """Record the current VO state as a keyframe."""
        alive = np.asarray(state.alive)
        uids = np.asarray(state.uid)[alive]
        xs = np.asarray(state.xs)[alive]
        ys = np.asarray(state.ys)[alive]
        obs = np.stack([(xs - cx) / fx, (ys - cy) / fy], 1)
        world = np.asarray(state.world)[alive]
        for u, w in zip(uids, world):
            self.world[int(u)] = w
        self.frames.append({
            "R": np.asarray(state.R), "t": np.asarray(state.t),
            "uids": uids, "obs": obs,
        })
        if len(self.frames) > self.window:
            self.frames.pop(0)

    def optimize(self):
        """Refine window poses + points.  Returns
        (refined [ (R, t) per frame ], info) or None if underconstrained."""
        V = len(self.frames)
        if V < 3:
            return None
        # tracks seen in >= min_track_len frames of the window
        counts: dict = {}
        for f in self.frames:
            for u in f["uids"]:
                counts[int(u)] = counts.get(int(u), 0) + 1
        track_ids = [u for u, c in counts.items()
                     if c >= self.min_track_len and u in self.world]
        if len(track_ids) < 12:
            return None
        pid = {u: i for i, u in enumerate(track_ids)}
        P = len(track_ids)
        L = self.window
        obs_xy = np.zeros((P, L, 2))
        obs_view = np.zeros((P, L), np.int32)
        obs_valid = np.zeros((P, L), bool)
        slot = np.zeros(P, np.int32)
        for v, f in enumerate(self.frames):
            for u, o in zip(f["uids"], f["obs"]):
                i = pid.get(int(u))
                if i is None or slot[i] >= L:
                    continue
                obs_xy[i, slot[i]] = o
                obs_view[i, slot[i]] = v
                obs_valid[i, slot[i]] = True
                slot[i] += 1
        pts = np.stack([self.world[u] for u in track_ids])
        Rs = np.stack([f["R"] for f in self.frames])
        ts = np.stack([f["t"] for f in self.frames])
        fixed = np.zeros(V, bool)
        fixed[:2] = True    # pin gauge incl. scale on the two oldest
        # f32: the fast path;
        # normalized-coordinate residuals at the 1e-4 level are well inside
        # f32 range and LM only needs descent-quality steps
        prob = ba.make_problem(Rs, ts, pts, obs_xy, obs_view, obs_valid,
                               fixed_views=fixed, dtype=jnp.float32)
        # trimmed least squares: the VO data contains KLT-drift outliers
        # and plain LM would absorb them into the poses — drop
        # observations whose initial residual is far beyond the median
        r0 = np.asarray(ba.residuals(prob))
        err = np.linalg.norm(r0, axis=-1)
        med = np.median(err[obs_valid]) + 1e-12
        keep = obs_valid & (err < 6.0 * med)
        # points need >= 2 surviving observations
        enough = keep.sum(axis=1) >= 2
        keep &= enough[:, None]
        prob = prob._replace(obs_valid=jnp.asarray(keep))
        out, info = ba.optimize(prob, iterations=self.iterations)
        refined = [(np.asarray(out.R[v]), np.asarray(out.t[v]))
                   for v in range(V)]
        # write refined points back
        new_pts = np.asarray(out.points)
        for u, i in pid.items():
            self.world[u] = new_pts[i]
        for v, f in enumerate(self.frames):
            f["R"], f["t"] = refined[v]
        return refined, info
