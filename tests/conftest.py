"""Test configuration: run on the CPU, with 8 virtual devices so the
shard_map / psum paths run without a multi-card machine.

Both are defaults set before JAX initializes.  Tests marked ``gpu`` need
a card: run them on one with ``JAX_PLATFORMS=cuda,cpu python -m pytest
-m gpu -n 0``; elsewhere their ``gpu`` fixture skips them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.fixture
def image_u8(rng):
    return rng.integers(0, 256, size=(48, 64)).astype(np.uint8)


@pytest.fixture
def image_f32(rng):
    return rng.uniform(0, 255, size=(48, 64)).astype(np.float32)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {devices[0].platform}")
    return devices[0]
