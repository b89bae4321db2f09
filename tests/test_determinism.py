"""Determinism tests (SURVEY §5: the batched analog of the reference's
ST<->MT equivalence harness — same seed must give bitwise-equal results,
since there is no nondeterministic thread scheduling to race)."""

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.io import simulate
from boofcv_tpu.sfm import stereo_vo
from boofcv_tpu.geo import robust


def _run_vo(frames, K, baseline):
    cfg = stereo_vo.StereoVoConfig(num_tracks=128, pyramid_scales=(1, 2),
                                   max_disparity=48, ransac_hypotheses=96)
    vo = stereo_vo.StereoVisualOdometry(cfg, K, baseline, 120, 160, seed=7)
    out = []
    for left, right in frames:
        vo.process(left, right)
        R, c = vo.camera_to_world()
        out.append((np.asarray(R), np.asarray(c)))
    return out


def test_stereo_vo_bitwise_deterministic():
    H, W = 120, 160
    K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(0)
    poses = [(jnp.eye(3), jnp.asarray([0.0, 0.0, -0.05 * i]))
             for i in range(4)]
    frames = simulate.render_stereo_sequence(rng, K, 0.3, poses, H, W)
    a = _run_vo(frames, K, 0.3)
    b = _run_vo(frames, K, 0.3)
    for (Ra, ca), (Rb, cb) in zip(a, b):
        assert (Ra == Rb).all()
        assert (ca == cb).all()


def test_ransac_bitwise_deterministic():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.uniform(-1, 1, (64, 3)) + np.array([0, 0, 4.0]))
    obs = w[:, :2] / w[:, 2:]
    key = jax.random.PRNGKey(3)
    r1, (Ra, ta) = robust.ransac_pnp(key, w, obs, num_hypotheses=64,
                                     inlier_threshold=1e-4)
    r2, (Rb, tb) = robust.ransac_pnp(key, w, obs, num_hypotheses=64,
                                     inlier_threshold=1e-4)
    assert (np.asarray(Ra) == np.asarray(Rb)).all()
    assert int(r1.num_inliers) == int(r2.num_inliers)
