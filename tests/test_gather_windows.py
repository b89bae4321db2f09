"""ip.interpolate.gather_windows against a NumPy clamped-coordinate copy."""

import numpy as np
import jax.numpy as jnp
import pytest

from boofcv_tpu.ip.interpolate import gather_windows


def np_windows(image, oy, ox, wy, wx):
    h, w = image.shape
    rows = np.clip(oy[:, None] + np.arange(wy)[None, :], 0, h - 1)
    cols = np.clip(ox[:, None] + np.arange(wx)[None, :], 0, w - 1)
    return image[rows[:, :, None], cols[:, None, :]]


# (wy, wx, pad): the KLT level window, the sparse-SAD patch and strip at
# the VO defaults (r=3, 96 disparities), and a window taller than the
# image (coarse pyramid levels of small frames)
SHAPES = [(24, 16, 0), (7, 7, 98), (7, 102, 98), (40, 16, 0)]


@pytest.mark.parametrize("wy,wx,pad", SHAPES)
@pytest.mark.parametrize("where", ["interior", "borders"])
def test_gather_windows_matches_numpy(wy, wx, pad, where):
    rng = np.random.default_rng(wy * 1000 + wx + pad)
    h, w = 30, 120
    image = rng.uniform(0, 255, (h, w)).astype(np.float32)
    hi_y = max(h, wy) + pad - wy
    hi_x = max(w, wx) + pad - wx
    if where == "interior":
        oy = rng.integers(0, max(h - wy, 0) + 1, 40)
        ox = rng.integers(0, max(w - wx, 0) + 1, 40)
    else:
        # every corner of the reachable range, and origins just inside it
        oy = np.clip([-pad, -pad, hi_y, hi_y, -pad + 1, hi_y - 1],
                     -pad, hi_y)
        ox = np.clip([-pad, hi_x, -pad, hi_x, hi_x - 1, -pad + 1],
                     -pad, hi_x)
    got = gather_windows(jnp.asarray(image), jnp.asarray(oy, jnp.int32),
                         jnp.asarray(ox, jnp.int32), wy, wx, pad)
    assert got.shape == (len(oy), wy, wx)
    np.testing.assert_array_equal(np.asarray(got),
                                  np_windows(image, oy, ox, wy, wx))


def test_gather_windows_clamps_origins_beyond_pad():
    image = np.arange(20 * 30, dtype=np.float32).reshape(20, 30)
    got = gather_windows(jnp.asarray(image), jnp.asarray([-50, 100]),
                         jnp.asarray([-50, 100]), 4, 5, 2)
    want = np_windows(image, np.array([-2, 18]), np.array([-2, 27]), 4, 5)
    np.testing.assert_array_equal(np.asarray(got), want)
