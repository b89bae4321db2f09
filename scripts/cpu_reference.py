"""Run chip_smoke's accuracy phases at full size on the CPU backend and
print each oracle value: the CPU figures the GPU bounds in chip_smoke.py
are derived from.  Needs several GiB of memory and minutes of CPU time.

    python scripts/cpu_reference.py
"""

import math
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from boofcv_tpu.sfm import stereo_vo  # noqa: E402


def main():
    cfg = stereo_vo.StereoVoConfig()
    inf = math.inf
    runs = [
        ("vo_640x480", chip_smoke.phase_vo, (480, 640, 41, cfg, inf)),
        ("vo_1280x720", chip_smoke.phase_vo, (720, 1280, 13, cfg, inf, 3)),
        ("vo_640x480_8streams", chip_smoke.phase_vo_batched,
         (480, 640, 13, 8, cfg, inf)),
        ("window_ba", chip_smoke.phase_window_ba,
         (100, 2000, 10, inf, inf)),
        ("dense_stereo", chip_smoke.phase_dense_stereo,
         (480, 640, 96, (inf, 0.0), (inf, 0.0))),
    ]
    for name, fn, args in runs:
        out = fn(*args)
        out.pop("setup_s")
        print(f"cpu {name}: {out}", flush=True)


if __name__ == "__main__":
    main()
