"""How much of a stereo-VO frame's device time gathers take.

Runs the 640x480 sequence runner (StereoVoConfig defaults, 40 frames) on
the GPU, times it end to end with ``block_until_ready``, traces one
steady run with ``jax.profiler`` and sums the device time of every
kernel, and of XLA's gather fusions (every kernel whose name holds
"gather": an upper bound on what ``gather_windows`` costs, since the
trace names kernels, not source scopes).  It then traces the window
gathers of one frame alone at the VO shapes.  Writes the traces under
the directory given as its argument (default ``.traces/vo_gather``,
git-ignored).

    python scripts/prof_vo_gather.py [TRACE_DIR]
"""

import collections
import glob
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
import bench_breadth  # noqa: E402
from boofcv_tpu.ip.interpolate import gather_windows  # noqa: E402
from boofcv_tpu.sfm import stereo_vo  # noqa: E402

def _timed(fn, reps):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def traced_kernels(fn, reps, trace_dir):
    """Trace ``reps`` calls of ``fn`` (after a warm-up call) and return
    {kernel name: [total ns, count]} over the CUDA-stream lines of the
    GPU planes."""
    jax.block_until_ready(fn())
    with jax.profiler.trace(trace_dir):
        for _ in range(reps):
            jax.block_until_ready(fn())
    path = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    kernels = collections.defaultdict(lambda: [0, 0])
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                kernels[ev.name][0] += ev.duration_ns
                kernels[ev.name][1] += 1
    return kernels


def _ms(kernels, only_gather=False):
    return sum(ns for name, (ns, _) in kernels.items()
               if "gather" in name or not only_gather) / 1e6


def main(trace_dir):
    device = bench_breadth.require_gpu()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {device} nvidia-smi: {smi}")
    H, W, n = 480, 640, 41
    cfg = stereo_vo.StereoVoConfig()
    K, baseline, frames, _ = bench.vo_sequence(H, W, n)
    lefts = jnp.stack([jnp.asarray(l) for l, _ in frames[1:]])
    rights = jnp.stack([jnp.asarray(r) for _, r in frames[1:]])
    state = stereo_vo.make_bootstrap(cfg, K, baseline)(
        stereo_vo.init_state(cfg, H, W), jnp.asarray(frames[0][0]),
        jnp.asarray(frames[0][1]))
    run = stereo_vo.make_sequence_runner(cfg, K, baseline)
    frame_ms = _timed(lambda: run(state, lefts, rights), 5) / (n - 1) * 1e3
    print(f"vo 640x480 sequence runner: {frame_ms:.4f} ms/frame "
          f"(host clock, block_until_ready, 5 runs of {n - 1} frames)")

    f = n - 1
    k = traced_kernels(lambda: run(state, lefts, rights), 1,
                       trace_dir + "/vo")
    total, gather = _ms(k), _ms(k, only_gather=True)
    print(f"traced run: {total / f:.4f} ms/frame of stream activity "
          f"(kernels and copies); gather "
          f"fusions {gather / f:.4f} ms/frame = "
          f"{100 * gather / max(total, 1e-9):.2f}%")
    for name, (ns, cnt) in sorted(k.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ns / 1e6:9.3f} ms {cnt:6d}x {name[:110]}")
    for name, (ns, cnt) in k.items():
        if "gather" in name:
            print(f"  gather fusion: {ns / 1e6:.3f} ms {cnt}x {name[:110]}")

    # the gathers of one frame alone: KLT windows on every pyramid level
    # (steady frames) plus the sparse-SAD patch and strip (spawn frames)
    import chip_smoke
    pyr = [jnp.asarray(frames[1][0][::s, ::s]) for s in cfg.pyramid_scales]
    rng = np.random.default_rng(0)
    ys = jnp.asarray(rng.integers(0, H, cfg.num_tracks), jnp.int32)
    xs = jnp.asarray(rng.integers(0, W, cfg.num_tracks), jnp.int32)
    (kwy, kwx, _), *sad = chip_smoke.window_shapes(cfg)

    @jax.jit
    def klt_gathers(ys, xs):
        return [gather_windows(p, ys // s, xs // s, kwy, kwx)
                for p, s in zip(pyr, cfg.pyramid_scales)]

    @jax.jit
    def sad_gathers(ys, xs):
        return [gather_windows(pyr[0], ys, xs, wy, wx, pad)
                for wy, wx, pad in sad]

    for name, fn in (("KLT window gathers, 4 levels", klt_gathers),
                     ("sparse-SAD patch + strip gathers", sad_gathers)):
        host_ms = _timed(lambda: fn(ys, xs), 200) * 1e3
        k = traced_kernels(lambda: fn(ys, xs), 50,
                           f"{trace_dir}/{fn.__name__}")
        print(f"isolated {name} (N={cfg.num_tracks}): {_ms(k) / 50:.4f} ms "
              f"device time per call, {host_ms:.4f} ms host clock per "
              f"call; kernels: {sorted(k)}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".traces/vo_gather")
