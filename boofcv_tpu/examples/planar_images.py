"""Working with multi-band (Planar) images.

Reference analog: examples/imageprocessing/ExamplePlanarImages.java —
split an interleaved color image into bands, process per band (one vmap),
merge back.  Oracle: planar blur equals per-band blur; band
math (swap red/blue) round-trips.
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu.examples import setup_backend


def main(argv=None) -> int:
    setup_backend(argv)
    import jax.numpy as jnp
    from boofcv_tpu.ip import blur, planar

    rng = np.random.default_rng(4)
    rgb = jnp.asarray(rng.uniform(0, 255, (60, 80, 3)).astype(np.float32))

    bands = planar.split_bands(rgb)
    assert len(bands) == 3
    swapped = planar.merge_bands([bands[2], bands[1], bands[0]])
    back = planar.merge_bands(planar.split_bands(swapped)[::-1])
    round_ok = bool(jnp.array_equal(back, rgb))

    blurred = planar.planar(blur.gaussian)(rgb, sigma=1.5)
    ref = jnp.stack([blur.gaussian(rgb[..., c], sigma=1.5)
                     for c in range(3)], axis=-1)
    blur_err = float(jnp.abs(blurred - ref).max())

    gray = planar.average_bands(rgb)
    print(f"split/merge round-trip: {round_ok}; planar-blur vs "
          f"band-loop max err {blur_err:.2e}; gray mean "
          f"{float(gray.mean()):.1f} (bands mean "
          f"{float(rgb.mean()):.1f})")
    ok = round_ok and blur_err < 1e-4 \
        and abs(float(gray.mean() - rgb.mean())) < 1e-3
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
