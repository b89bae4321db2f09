"""Distributed execution: meshes, sharded bundle adjustment, sharded matching.

No reference analog — BoofCV's only parallelism is a single-JVM
ForkJoinPool (boofcv-types concurrency/BoofConcurrency.java:35).  This
package is the scaling layer (SURVEY §2.9, §5): device meshes via
jax.sharding, shard_map + psum/all_gather collectives between devices.
"""

from boofcv_tpu.dist.mesh import make_mesh, device_count  # noqa: F401
