"""The measured CPU VO baseline (bench_vo_baseline) must be a
functioning odometer — vs_baseline numbers are only honest if the
baseline actually solves the task (VisOdomPixelDepthPnP.java spec)."""

import numpy as np
import jax.numpy as jnp
import pytest


def test_numpy_vo_recovers_trajectory():
    from boofcv_tpu.io import simulate
    import bench_vo_baseline as bvb

    H, W = 240, 320
    K = np.array([[320.0, 0.0, W / 2], [0.0, 320.0, H / 2], [0.0, 0.0, 1.0]])
    baseline = 0.3
    rng = np.random.default_rng(0)
    poses = []
    for i in range(7):
        a = 0.002 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        c = np.array([0.01 * i, 0.0, 0.04 * i])
        poses.append((jnp.asarray(R), jnp.asarray(-R @ c)))
    frames = simulate.render_stereo_sequence(
        rng, K, baseline, poses, H, W, plane_origin=(0.0, 0.0, 6.0),
        texture_scale=40.0)
    frames = [(np.asarray(l), np.asarray(r)) for l, r in frames]

    vo = bvb.NumpyStereoVo(K, baseline, H, W, num_tracks=256,
                           max_disparity=48, hypotheses=128)
    vo.bootstrap(*frames[0])
    assert vo.alive.sum() > 50
    errs = []
    for i, (l, r) in enumerate(frames[1:], start=1):
        R, t = vo.step(l, r)
        errs.append(np.linalg.norm(t - np.asarray(poses[i][1])))
    assert np.mean(errs) < 0.02, errs
    assert vo.alive.mean() > 0.3


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_refuses_unknown_device(kind):
    import bench_breadth
    with pytest.raises(ValueError, match="no published peaks"):
        bench_breadth.peaks(kind)


def test_peak_table_holds_h100_data_sheet():
    import bench_breadth
    pk = bench_breadth.peaks("NVIDIA H100 80GB HBM3")
    assert pk["bf16_flops"] == 989e12
    assert pk["hbm_bytes_per_s"] == 3.35e12


def test_bench_rows_need_a_gpu(capsys):
    import bench_breadth
    with pytest.raises(SystemExit):
        bench_breadth.emit({"metric": "m", "value": 1.0})
    assert capsys.readouterr().out == ""
