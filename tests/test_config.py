"""Package-level setup: compile-cache placement and the main path's
import footprint.  Both are checked in fresh interpreters, since they are
decided when the package is first imported."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, **env):
    base = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**base, **env}, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compilation_cache_dir(env_dir, tmp_path):
    env = {} if env_dir is None else {
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / env_dir)}
    out = _python("import jax, boofcv_tpu; "
                  "print(jax.config.jax_compilation_cache_dir)", **env)
    want = (os.path.join(ROOT, ".jax_cache") if env_dir is None
            else str(tmp_path / env_dir))
    assert out == want
    if env_dir is None:
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


MAIN_PATH = ["boofcv_tpu.sfm.stereo_vo", "boofcv_tpu.geo.ba",
             "boofcv_tpu.feature.disparity", "boofcv_tpu.io.simulate",
             "boofcv_tpu.dist.ba_sharded", "boofcv_tpu.dist.ransac_sharded"]


@pytest.mark.parametrize("module", MAIN_PATH)
def test_main_path_imports_only_jax_numpy_scipy(module):
    """With PIL and matplotlib unimportable, the module imports and loads
    no third-party package beyond what jax, numpy and scipy load."""
    code = f"""
import sys
sys.modules["PIL"] = None
sys.modules["matplotlib"] = None
import jax, numpy, scipy, scipy.linalg, scipy.ndimage
def tops():
    return {{n.split(".")[0] for n, m in sys.modules.items() if m is not None}}
before = tops()
import {module}
new = tops() - before - set(sys.stdlib_module_names) - {{"boofcv_tpu"}}
print(sorted(new))
"""
    assert _python(code) == "[]"
