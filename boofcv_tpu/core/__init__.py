"""Core types: image policy, borders, kernels, pyramids, configs.

Reference analog: main/boofcv-types (struct/image, struct/convolve,
struct/border, struct/pyramid, concurrency).  Here an "image" is just a
``jnp.ndarray`` (H, W) or (H, W, C) — subimages are slices, dtype is a jnp
dtype, and the concurrency runtime collapses into XLA.
"""

from boofcv_tpu.core.border import BorderType, pad, pad_mode
from boofcv_tpu.core.kernel import (
    gaussian_kernel,
    gaussian_kernel_2d,
    gaussian_deriv_kernel,
    gaussian_sigma_for_radius,
    gaussian_radius_for_sigma,
    mean_kernel,
    normalize_kernel,
)
from boofcv_tpu.core.image import (
    to_float32,
    to_uint8,
    rescale_to_unit,
    ImageShape,
)
from boofcv_tpu.core.pyramid import PyramidConfig, pyramid_shapes
