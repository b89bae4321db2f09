"""chip_smoke.py: CPU rehearsals of every phase at tiny sizes, its refusal
to run without a GPU, and the same phases at full size on a card."""

import os
import subprocess
import sys

import pytest

import chip_smoke
from boofcv_tpu.sfm import stereo_vo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_VO = stereo_vo.StereoVoConfig(
    num_tracks=96, pyramid_scales=(1, 2), max_disparity=24,
    ransac_hypotheses=64, refine_iterations=4)


def test_vo_phase_rehearsal():
    out = chip_smoke.phase_vo(96, 128, 5, TINY_VO, ate_bound=0.05,
                              process_frames=3)
    assert out["ok"], out


def test_vo_batched_phase_rehearsal():
    out = chip_smoke.phase_vo_batched(96, 128, 4, 2, TINY_VO,
                                      ate_bound=0.05)
    assert out["ok"], out


def test_window_ba_phase_rehearsal():
    out = chip_smoke.phase_window_ba(12, 150, 4, rms_bound=7e-4,
                                     cost_rtol=chip_smoke.BA_COST_RTOL)
    assert out["ok"], out


def test_dense_stereo_phase_rehearsal():
    # the tiny pair has a wider invalid border than the 640x480 one
    out = chip_smoke.phase_dense_stereo(48, 80, 16, bm_bound=(0.5, 0.8),
                                        sgm_bound=(1.0, 0.8))
    assert out["ok"], out


def test_window_gather_phase_rehearsal():
    out = chip_smoke.phase_window_gather(
        32, 40, 56, chip_smoke.window_shapes(TINY_VO))
    assert out["ok"], out


def test_numerics_phase_rehearsal():
    out = chip_smoke.phase_numerics(96, 128, TINY_VO)
    assert out["ok"], out


def test_multi_phase_rehearsal():
    out = chip_smoke.phase_multi(4, 12, 160, 4, iterations=4,
                                 pcg_iterations=60, n_ransac=200,
                                 hyps_per_device=32)
    assert out["ok"], out


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_without_gpu(argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "chip_smoke.py", *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.gpu
def test_main_on_gpu(gpu):
    assert chip_smoke.main([]) == 0
