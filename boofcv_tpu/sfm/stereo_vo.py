"""Stereo visual odometry: KLT tracking + sparse stereo depth + RANSAC P3P.

Reference analog: boofcv-sfm alg/sfm/d3/VisOdomPixelDepthPnP.java:56,154
(tracker.process -> estimateMotion [RANSAC P3P + refine, :261] -> drop
unused -> addNewTracks [spawn + sparse stereo 3D, :224]) wrapped by
WrapVisOdomPixelDepthPnP.java:99 (rectification first), assembled by
FactoryVisualOdometry.stereoDepth (FactoryVisualOdometry.java:186-222).

Design (SURVEY §7 stage 4 + §3.1 boundary plan): ALL per-frame math is
one jitted step over a fixed-capacity track pool:
  * track state lives on device (positions, world points, alive mask);
  * KLT advances every slot in parallel (batched pyramidal GN);
  * motion is hypothesis-parallel RANSAC over P3P + a GN refine;
  * dropped/spawned tracks are mask updates + top-k detection compaction;
  * the host sees only the scalar pose per frame.
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
from boofcv_tpu.ip import pyramid_ops


@dataclass(frozen=True)
class StereoVoConfig:
    """FactoryVisualOdometry.stereoDepth config analog (the reference
    example workload: 600 features, pyramid {1,2,4,8}, r=3 templates,
    disparity 0-150, RANSAC 200 iters — ExampleVisualOdometryStereo:66)."""
    num_tracks: int = 512
    pyramid_scales: tuple = (1, 2, 4, 8)
    template_radius: int = 3
    detect_radius: int = 5
    detect_threshold: float = 1.0
    min_disparity: int = 0
    max_disparity: int = 96
    disparity_radius: int = 3
    ransac_hypotheses: int = 256
    inlier_threshold_px: float = 1.5
    refine_iterations: int = 10
    respawn_below: float = 0.6     # respawn when alive fraction drops below
    klt: klt.KltConfig = klt.KltConfig()


class StereoVoState(NamedTuple):
    """Fixed-capacity device-resident VO state."""
    xs: jnp.ndarray          # [N] f32 track x (rectified-left pixels)
    ys: jnp.ndarray          # [N]
    world: jnp.ndarray       # [N, 3] f64 points in world frame
    alive: jnp.ndarray       # [N] bool
    templates: klt.KltTemplates
    R: jnp.ndarray           # [3, 3] f64 world->camera
    t: jnp.ndarray           # [3]
    key: jnp.ndarray         # PRNG state for RANSAC
    uid: jnp.ndarray         # [N] int32 stable track id (windowed BA)
    next_uid: jnp.ndarray    # scalar int32


def init_state(cfg: StereoVoConfig, height: int, width: int,
               seed: int = 0) -> StereoVoState:
    n = cfg.num_tracks
    p = 2 * cfg.template_radius + 1
    levels = len(cfg.pyramid_scales)
    zero_t = tuple(jnp.zeros((n, p, p), jnp.float32) for _ in range(levels))
    return StereoVoState(
        xs=jnp.zeros((n,), jnp.float32), ys=jnp.zeros((n,), jnp.float32),
        world=jnp.zeros((n, 3), jnp.float64),
        alive=jnp.zeros((n,), bool),
        templates=klt.KltTemplates(zero_t, zero_t, zero_t),
        R=jnp.eye(3, dtype=jnp.float64), t=jnp.zeros((3,), jnp.float64),
        key=jax.random.PRNGKey(seed),
        uid=jnp.full((n,), -1, jnp.int32),
        next_uid=jnp.int32(0))


def _detect_candidates(image, cfg: StereoVoConfig, n_cand: int):
    inten = intensity.shi_tomasi(image, radius=2)
    det = extract.detect(inten, max_features=n_cand,
                         radius=cfg.detect_radius,
                         threshold=cfg.detect_threshold,
                         border=cfg.template_radius * cfg.pyramid_scales[-1] + 2)
    return det


def _spawn(state: StereoVoState, pyramid, grads, left, right,
           rectK, baseline, cfg: StereoVoConfig):
    """Fill dead slots with fresh detections + stereo depth.

    addNewTracks analog (VisOdomPixelDepthPnP.java:224): detect, reject
    candidates near live tracks, compute sparse stereo disparity, lift to
    3D in the *world* frame through the current pose.
    """
    n = cfg.num_tracks
    det = _detect_candidates(left, cfg, n)
    cand_y = det.ys.astype(jnp.float32)
    cand_x = det.xs.astype(jnp.float32)
    cand_ok = det.valid

    # minimum-distance constraint against live tracks
    d2 = ((cand_x[:, None] - state.xs[None, :]) ** 2
          + (cand_y[:, None] - state.ys[None, :]) ** 2)
    d2 = jnp.where(state.alive[None, :], d2, jnp.inf)
    min_r = (2 * cfg.detect_radius) ** 2
    cand_ok &= jnp.min(d2, axis=1) > min_r

    # stereo depth at candidates
    dcfg = disp_mod.DisparityConfig(
        min_disparity=cfg.min_disparity, max_disparity=cfg.max_disparity,
        radius_x=cfg.disparity_radius, radius_y=cfg.disparity_radius,
        texture_threshold=0.1, error="sad")
    disp, dvalid = disp_mod.sparse_block_match(
        left, right, cand_y.astype(jnp.int32), cand_x.astype(jnp.int32), dcfg)
    cand_ok &= dvalid & (disp > 0.5)

    # lift: pixel+disp -> camera frame -> world frame
    from boofcv_tpu.geo.rectify import pixel_to_3d_rectified
    Xc = pixel_to_3d_rectified(cand_x.astype(jnp.float64),
                               cand_y.astype(jnp.float64),
                               disp.astype(jnp.float64), rectK, baseline)
    Rinv, tinv = se3.invert(state.R, state.t)
    Xw = Xc @ Rinv.T + tinv

    # compact candidates into dead slots: rank-matching via scatter
    dead = ~state.alive
    slot_rank = jnp.cumsum(dead) * dead          # [N] 1-based rank for dead slots
    cand_rank = jnp.cumsum(cand_ok) * cand_ok    # [N] 1-based rank for good candidates
    # map rank -> candidate index
    by_rank = jnp.zeros((n + 1,), jnp.int32).at[cand_rank].set(
        jnp.arange(n, dtype=jnp.int32))
    n_cand = jnp.max(cand_rank)
    take = dead & (slot_rank <= n_cand) & (slot_rank > 0)
    src = by_rank[jnp.clip(slot_rank, 0, n)]

    new_xs = jnp.where(take, cand_x[src], state.xs)
    new_ys = jnp.where(take, cand_y[src], state.ys)
    new_world = jnp.where(take[:, None], Xw[src], state.world)
    new_alive = state.alive | take
    # fresh stable ids for spawned slots (windowed BA keys on these)
    new_uid = jnp.where(take, state.next_uid + slot_rank.astype(jnp.int32) - 1,
                        state.uid)
    next_uid = state.next_uid + jnp.max(slot_rank * take).astype(jnp.int32)

    # sample templates at the new positions, but KEEP existing tracks'
    # spawn-time templates (the reference's KLT never updates a track's
    # description after spawn — per-frame resampling accumulates drift
    # bias along the motion direction)
    tmpl_new = klt.sample_templates(pyramid, grads, new_ys, new_xs,
                                    cfg.pyramid_scales, cfg.template_radius)
    mix = lambda new, old: tuple(
        jnp.where(take[:, None, None], n_, o_) for n_, o_ in zip(new, old))
    tmpl = klt.KltTemplates(mix(tmpl_new.desc, state.templates.desc),
                            mix(tmpl_new.grad_x, state.templates.grad_x),
                            mix(tmpl_new.grad_y, state.templates.grad_y))
    return state._replace(xs=new_xs, ys=new_ys, world=new_world,
                          alive=new_alive, templates=tmpl,
                          uid=new_uid, next_uid=next_uid)


def _make_step_parts(cfg: StereoVoConfig, rectK, baseline: float):
    """Shared step pieces: (track_estimate, spawn_fn).

    Split so the batched (vmapped) step can gate the expensive spawn
    branch on an ANY-LANE predicate — a per-lane ``lax.cond`` under vmap
    lowers to select-of-both-branches, which forced detection + sparse
    stereo onto EVERY frame of every stream."""
    fx = float(rectK[0, 0])
    fy = float(rectK[1, 1])
    cx = float(rectK[0, 2])
    cy = float(rectK[1, 2])
    norm_thresh = (cfg.inlier_threshold_px / fx) ** 2
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)

    def track_estimate(state: StereoVoState, left, right):
        left = left.astype(jnp.float32)
        pyramid = pyramid_ops.pyramid_average(left, pyr_cfg)

        # 1. track (PointTrackerKltPyramid.process:230)
        nys, nxs, fault = klt.track_pyramid(
            pyramid, state.templates, state.ys, state.xs,
            cfg.pyramid_scales, cfg.klt)
        tracked = state.alive & (fault == klt.TRACK_OK)
        xs = jnp.where(tracked, nxs, state.xs)
        ys = jnp.where(tracked, nys, state.ys)

        # 2. motion (estimateMotion:261): RANSAC P3P on tracked points
        obs = jnp.stack([(xs - cx) / fx, (ys - cy) / fy], axis=-1)
        key, sub = jax.random.split(state.key)
        res, (Rn, tn) = robust.ransac_pnp(
            sub, state.world, obs.astype(jnp.float64),
            num_hypotheses=cfg.ransac_hypotheses,
            inlier_threshold=norm_thresh, valid_mask=tracked,
            refine_iterations=cfg.refine_iterations)

        # guard: if too few inliers, keep previous pose (process() false)
        ok = res.num_inliers >= 6
        Rn = jnp.where(ok, Rn, state.R)
        tn = jnp.where(ok, tn, state.t)

        # 3. drop outlier tracks (dropUnusedTracks:205) — but ONLY when
        # the pose was accepted: a failed RANSAC's inlier mask is from a
        # junk hypothesis, and pruning with it collapses the pool and
        # respawns new landmarks through the STALE pose, baking the
        # missed motion into the map permanently (the reference leaves
        # tracks untouched on failure)
        alive = tracked & (res.inliers | ~ok)

        new_state = state._replace(xs=xs, ys=ys, alive=alive, R=Rn, t=tn,
                                   key=key)
        frac = jnp.mean(alive.astype(jnp.float32))
        return (new_state, pyramid, left, right.astype(jnp.float32), frac,
                (jnp.sum(tracked), res.num_inliers, ok))

    def spawn_fn(s, pyramid, left, right):
        # gradients are only needed for spawn-time template sampling —
        # computing them inside the branch keeps them off the
        # steady-state frame's critical path
        grads = pyramid_ops.gradient(pyramid)
        return _spawn(s, pyramid, grads, left, right, rectK, baseline, cfg)

    return track_estimate, spawn_fn


def _make_step_fn(cfg: StereoVoConfig, rectK, baseline: float):
    """The un-jitted per-frame step body shared by make_step (one frame
    per dispatch) and make_sequence_runner (N frames per dispatch)."""
    track_estimate, spawn_fn = _make_step_parts(cfg, rectK, baseline)

    def step(state: StereoVoState, left, right):
        new_state, pyramid, l32, r32, frac, (n_tracked, n_inl, ok) = \
            track_estimate(state, left, right)

        # 4. spawn into dead slots when the pool runs low (addNewTracks)
        new_state = jax.lax.cond(
            frac < cfg.respawn_below,
            lambda s: spawn_fn(s, pyramid, l32, r32), lambda s: s,
            new_state)

        metrics = {
            "tracked": n_tracked, "inliers": n_inl,
            "alive": jnp.sum(new_state.alive), "pose_ok": ok,
        }
        return new_state, metrics

    return step


def _make_batched_step_fn(cfg: StereoVoConfig, rectK, baseline: float):
    """B-stream step: vmapped track+estimate, spawn gated on a GLOBAL
    any-lane predicate (scalar cond stays a real branch under jit), and
    per-lane selection of the spawned state."""
    track_estimate, spawn_fn = _make_step_parts(cfg, rectK, baseline)

    def bstep(states: StereoVoState, lefts, rights):
        states, pyrs, l32, r32, fracs, (n_tracked, n_inl, ok) = \
            jax.vmap(track_estimate)(states, lefts, rights)
        need = fracs < cfg.respawn_below

        def do(ss):
            spawned = jax.vmap(spawn_fn)(ss, pyrs, l32, r32)
            pick = lambda a, b: jnp.where(
                need.reshape((-1,) + (1,) * (a.ndim - 1)), b, a)
            return jax.tree_util.tree_map(pick, ss, spawned)

        states = jax.lax.cond(jnp.any(need), do, lambda s: s, states)
        metrics = {
            "tracked": n_tracked, "inliers": n_inl,
            "alive": jnp.sum(states.alive, axis=-1), "pose_ok": ok,
        }
        return states, metrics

    return bstep


def make_step(cfg: StereoVoConfig, rectK, baseline: float):
    """Build the jitted per-frame VO step.

    Returns step(state, left, right) -> (state, metrics) where the images
    are the *rectified* pair (apply geo.rectify maps upstream when the raw
    cameras are not already rectified).
    """
    return jax.jit(_make_step_fn(cfg, rectK, baseline))


def make_sequence_runner(cfg: StereoVoConfig, rectK, baseline: float):
    """Whole-sequence VO as ONE dispatch: lax.scan of the per-frame step
    over stacked frames.

    run(state, lefts [N,H,W], rights [N,H,W]) -> (state, (poses, metrics))
    with poses = (R [N,3,3], t [N,3]) world->camera per frame.

    This is the throughput path: one dispatch per sequence instead of
    one per frame, and XLA may overlap adjacent frames' independent
    stages.
    """
    step = _make_step_fn(cfg, rectK, baseline)

    @jax.jit
    def run(state: StereoVoState, lefts, rights):
        def body(s, lr):
            l, r = lr
            s, m = step(s, l, r)
            return s, (s.R, s.t, m)

        state, (Rs, ts, ms) = jax.lax.scan(body, state, (lefts, rights),
                                           unroll=4)
        return state, ((Rs, ts), ms)

    return run


def init_batched_state(cfg: StereoVoConfig, num_streams: int, height: int,
                       width: int, seed: int = 0) -> StereoVoState:
    """Stacked state for ``num_streams`` independent VO streams (leading
    stream axis on every leaf; distinct RANSAC keys per stream)."""
    states = [init_state(cfg, height, width, seed + i)
              for i in range(num_streams)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def make_batched_step(cfg: StereoVoConfig, rectK, baseline: float):
    """B independent VO streams as ONE compiled program: ``vmap`` of the
    per-frame step over a leading stream axis.

    step(states, lefts [B,H,W], rights [B,H,W]) -> (states, metrics).

    This is the throughput lever the reference cannot express
    (BoofConcurrency.java:82 parallelizes within one frame only): one
    stream's step is too small to fill the device, so batching B
    cameras/sequences into one program raises frames/s per device at
    near-constant latency until compute or memory bandwidth saturate.
    Multi-camera rigs, fleet replay, and dataset evaluation are the
    natural users.
    """
    return jax.jit(_make_batched_step_fn(cfg, rectK, baseline))


def make_batched_bootstrap(cfg: StereoVoConfig, rectK, baseline: float):
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rectKj = jnp.asarray(rectK, jnp.float64)

    def boot(state: StereoVoState, left, right):
        left = left.astype(jnp.float32)
        pyramid = pyramid_ops.pyramid_average(left, pyr_cfg)
        grads = pyramid_ops.gradient(pyramid)
        return _spawn(state, pyramid, grads, left,
                      right.astype(jnp.float32), rectKj, baseline, cfg)

    return jax.jit(jax.vmap(boot))


def make_batched_sequence_runner(cfg: StereoVoConfig, rectK,
                                 baseline: float,
                                 shared_frames: bool = False):
    """Throughput x throughput: lax.scan over frames OF the vmapped
    B-stream step — one dispatch runs T frames x B streams.

    run(states, lefts [T,B,H,W], rights [T,B,H,W]) ->
    (states, ((Rs [T,B,3,3], ts [T,B,3]), metrics)).

    ``shared_frames=True`` takes lefts/rights as [T, H, W] and broadcasts
    each frame across the B streams inside the program (benchmark /
    dataset-replay mode: one HBM copy of the sequence, B-fold compute).
    """
    vstep = _make_batched_step_fn(cfg, rectK, baseline)

    @jax.jit
    def run(states: StereoVoState, lefts, rights):
        B = states.xs.shape[0]

        def body(s, lr):
            l, r = lr
            if shared_frames:
                l = jnp.broadcast_to(l, (B,) + l.shape)
                r = jnp.broadcast_to(r, (B,) + r.shape)
            s, m = vstep(s, l, r)
            return s, (s.R, s.t, m)

        states, (Rs, ts, ms) = jax.lax.scan(body, states, (lefts, rights),
                                            unroll=4)
        return states, ((Rs, ts), ms)

    return run


def make_bootstrap(cfg: StereoVoConfig, rectK, baseline: float):
    """Jitted first-frame initializer (one compile, no per-op dispatch)."""
    pyr_cfg = PyramidConfig(scales=cfg.pyramid_scales)
    rectK = jnp.asarray(rectK, jnp.float64)

    @jax.jit
    def boot(state: StereoVoState, left, right):
        left = left.astype(jnp.float32)
        pyramid = pyramid_ops.pyramid_average(left, pyr_cfg)
        grads = pyramid_ops.gradient(pyramid)
        return _spawn(state, pyramid, grads, left,
                      right.astype(jnp.float32), rectK, baseline, cfg)

    return boot


def bootstrap(state: StereoVoState, left, right, rectK, baseline,
              cfg: StereoVoConfig):
    """Initialize the track pool from the first frame pair (jitted)."""
    boot = make_bootstrap(cfg, rectK, baseline)
    return boot(state, jnp.asarray(left), jnp.asarray(right))


class StereoVisualOdometry:
    """Host-facing driver (abst StereoVisualOdometry analog): owns device
    state, exposes process(left, right) -> bool and get_pose()."""

    def __init__(self, cfg: StereoVoConfig, rectK, baseline: float,
                 height: int, width: int, seed: int = 0):
        self.cfg = cfg
        self.rectK = jnp.asarray(rectK, jnp.float64)
        self.baseline = float(baseline)
        self._step = make_step(cfg, np.asarray(rectK), baseline)
        self._boot = make_bootstrap(cfg, np.asarray(rectK), baseline)
        self.state = init_state(cfg, height, width, seed)
        self._first = True
        self.metrics = {}

    def reset(self, seed: int = 0):
        h = w = 0
        self.state = init_state(self.cfg, h, w, seed)
        self._first = True

    def process(self, left, right) -> bool:
        if self._first:
            self.state = self._boot(self.state, jnp.asarray(left),
                                    jnp.asarray(right))
            self._first = False
            return True
        self.state, m = self._step(self.state, jnp.asarray(left),
                                   jnp.asarray(right))
        self.metrics = {k: int(v) if v.ndim == 0 else v for k, v in m.items()}
        return bool(m["pose_ok"])

    def camera_to_world(self):
        """Current camera->world SE3 (i.e. camera position/orientation)."""
        R, t = se3.invert(self.state.R, self.state.t)
        return np.asarray(R), np.asarray(t)
