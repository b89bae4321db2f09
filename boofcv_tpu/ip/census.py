"""Census transform (reference analog: boofcv-ip alg/transform/census/*).

3x3 -> 8-bit and 5x5 -> 24-bit census codes: each bit is (neighbor < center),
packed in raster order skipping the center (CensusTransform.java /
ImplCensusTransformInner.java).  Border pixels use EXTENDED neighbors
(the reference allows an ImageBorder; dense SGM uses extended).
Bit-parallel compares elementwise; output int32.
"""

from __future__ import annotations

import jax.numpy as jnp

from boofcv_tpu.core.border import BorderType, pad


def _census(image: jnp.ndarray, radius: int) -> jnp.ndarray:
    p = pad(image, radius, radius, BorderType.EXTENDED)
    h, w = image.shape
    n = 2 * radius + 1
    out = jnp.zeros((h, w), dtype=jnp.int32)
    bit = 0
    for dy in range(n):
        for dx in range(n):
            if dy == radius and dx == radius:
                continue
            neighbor = p[dy:dy + h, dx:dx + w]
            out = out | ((neighbor < image).astype(jnp.int32) << bit)
            bit += 1
    return out


def dense3x3(image: jnp.ndarray) -> jnp.ndarray:
    """8-bit census (CensusTransform.dense3x3)."""
    return _census(image, 1)


def dense5x5(image: jnp.ndarray) -> jnp.ndarray:
    """24-bit census (CensusTransform.dense5x5)."""
    return _census(image, 2)


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-element popcount(a XOR b) — the census matching cost."""
    x = jnp.bitwise_xor(a, b)
    # popcount via jnp (int32): SWAR bit tricks
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24
