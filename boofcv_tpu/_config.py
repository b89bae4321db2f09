"""Global precision policy.

The reference does all geometry in f64 (Java doubles). Here the image /
feature path runs f32 (bf16 where accuracy allows), while the small-matrix
geometry solvers (epipolar, PnP, BA normal equations) want f64 for
conditioning.  We therefore enable jax x64 support once at import time —
this *permits* f64 arrays, it does not change the dtype of any op whose
inputs are f32 — and every image op in this package is explicit about its
compute dtype.

Reference analog: BoofCV generates `_F32` twins of `_F64` geometry code
(main/autocode Autocode64to32App.java:27); here the same solver is
dtype-polymorphic and the caller picks the precision.
"""

import os

import jax

_X64_ENABLED = False
_CACHE_ENABLED = False


# fixed in-checkout cache directory (listed in .gitignore): the cache key
# includes nothing of the path, but a directory that moves never hits
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache() -> None:
    """Enable the JAX persistent compilation cache, in
    ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), else
    in ``.jax_cache`` at the root of the checkout.

    The VO sequence runner is the slowest compile in the package; the
    cache lets a second process (bench rerun, test rerun, CLI) skip it.
    """
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    # cache everything — tests compile hundreds of small programs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # don't embed XLA's internal AOT caches: their loader feature-checks
    # warn about XLA pseudo-features on every deserialization
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    _CACHE_ENABLED = True


def enable_x64_for_geometry() -> None:
    global _X64_ENABLED
    if not _X64_ENABLED:
        jax.config.update("jax_enable_x64", True)
        _X64_ENABLED = True


enable_x64_for_geometry()
enable_compilation_cache()
