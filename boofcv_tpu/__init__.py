"""boofcv_tpu — a computer-vision / SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of BoofCV
(reference: /root/reference, v0.35-SNAPSHOT): image processing, feature
detection/description/association/tracking, stereo disparity, multi-view
geometry, robust estimation, bundle adjustment, visual odometry, camera
calibration, and recognition — built accelerator-first:

* images are ``jnp`` arrays (HW / HWC, f32/bf16), never pixel loops;
* per-feature work (KLT, descriptors, minimal solvers) is ``vmap``-batched;
* association and RANSAC scoring are matmul-shaped;
* dynamic structures (track lists, detections) are fixed-capacity pools with
  validity masks so everything stays statically shaped under ``jit``;
* multi-chip scale goes through ``jax.sharding.Mesh`` + ``shard_map`` with XLA
  collectives (see :mod:`boofcv_tpu.dist`), not threads.

Layer map (≈ reference modules, see SURVEY.md):

========  =====================================================================
core      image/dtype policy, borders, kernels, pyramid containers  [boofcv-types]
ip        convolve/blur/gradient/threshold/warp/integral/...        [boofcv-ip]
feature   detect/describe/associate/KLT/disparity/flow/...          [boofcv-feature]
geo       cameras, epipolar, PnP, triangulation, RANSAC, BA         [boofcv-geo]
sfm       stereo depth, visual odometry, reconstruction             [boofcv-sfm]
calib     Zhang99 calibration                                       [boofcv-calibration]
recognition fiducials/QR/trackers/scene                             [boofcv-recognition]
io        calib YAML, PLY, BAL, images, simulation oracle           [boofcv-io]
dist      meshes, sharded BA / matching (no reference analog)
========  =====================================================================
"""

from boofcv_tpu._config import enable_x64_for_geometry  # noqa: F401

__version__ = "0.1.0"
