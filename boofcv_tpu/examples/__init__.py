"""Runnable examples — the analog of the reference's
``examples/src/main/java/boofcv/examples/`` tree (78 Java examples).

Each module is a self-contained demo: it synthesizes input with a known
ground truth, runs one library pipeline end-to-end, prints a checkable
result, and exits 0 on success.  Run as::

    python -m boofcv_tpu.examples.<name>

Examples default to the CPU backend (their inputs are small and CPU
compiles are quick) — pass ``--accelerator`` to run on JAX's default
device, e.g. the GPU.
"""

from __future__ import annotations

import sys


def setup_backend(argv=None):
    """Force the CPU backend unless --accelerator is passed.

    Returns the remaining argv.  Must be called before first jax backend
    use.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--accelerator" in argv:
        argv.remove("--accelerator")
        return argv
    import jax

    jax.config.update("jax_platforms", "cpu")
    return argv
