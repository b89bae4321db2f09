"""Native (C++) host-side runtime: lazy g++ build + ctypes bindings.

The device compute path is JAX/XLA; this package holds the host-side
sequential finishers that BoofCV implements as tight Java loops
(LinearContourLabelChang2004.java:59, LinearExternalContours.java) — here
compiled C++ loaded through ctypes.  Everything degrades gracefully: if the
toolchain is unavailable the pure-Python/JAX fallbacks in
``boofcv_tpu.ip.binary`` are used (the BOverride pluggable-acceleration
idiom, boofcv-ip override/BOverrideManager.java:29).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ccl.cpp")
_SO = os.path.join(_HERE, "_build", "libboofcv_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile ccl.cpp into _build/ (git-ignored).  Each process links
    into its own file and renames it into place, so concurrent first
    uses never load a half-written library."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("BOOFCV_TPU_NO_NATIVE"):
            return None
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.boofcv_ccl.restype = ctypes.c_int32
        lib.boofcv_ccl.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.boofcv_external_contours.restype = ctypes.c_int32
        lib.boofcv_external_contours.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.boofcv_contours_with_holes.restype = ctypes.c_int32
        lib.boofcv_contours_with_holes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        fp = ctypes.POINTER(ctypes.c_float)
        lib.boofcv_fh04.restype = ctypes.c_int32
        lib.boofcv_fh04.argtypes = [
            fp, fp, fp, fp, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is (or can be) loaded."""
    return _load() is not None


def ccl(binary, eight: bool = True):
    """Union-find connected-component labeling on the host.

    Returns (labels int32 [H, W], count); labels numbered 1..N in raster
    order of each component's first pixel — identical numbering to
    ``ip.binary.label_blobs`` + ``relabel_compact``.  Returns None when the
    native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(np.asarray(binary) != 0, dtype=np.uint8)
    h, w = img.shape
    out = np.empty((h, w), dtype=np.int32)
    n = lib.boofcv_ccl(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(h), ctypes.c_int32(w), ctypes.c_int32(int(eight)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, int(n)


def external_contours(binary):
    """External Moore contours; list of [K, 2] int32 (x, y) arrays, same
    output as the Python tracer in ``ip.binary.contour_external``.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(np.asarray(binary) != 0, dtype=np.uint8)
    h, w = img.shape
    # every boundary state visited at most once per direction -> 8*H*W is a
    # hard upper bound; use a generous but bounded first guess and retry once
    cap = max(4096, 4 * (h + 2) * (w + 2))
    max_c = max(1024, h * w // 4 + 8)
    for _ in range(2):
        xy = np.empty((cap, 2), dtype=np.int32)
        starts = np.zeros(max_c + 1, dtype=np.int32)
        nc = lib.boofcv_external_contours(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(h), ctypes.c_int32(w),
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(max_c))
        if nc >= 0:
            return [xy[starts[c]:starts[c + 1]].copy() for c in range(nc)]
        cap = 8 * (h + 2) * (w + 2)
        max_c = h * w + 8
    return None


def fh04_merge(wr, wd, wdr=None, wdl=None, k: float = 300.0,
               min_size: int = 20):
    """Felzenszwalb-Huttenlocher sorted-edge union-find merge (C++).

    wr/wd (+ optional diagonal wdr/wdl) are [H, W] float32 edge-weight
    images (computed on device).  Returns (labels int32 [H, W], count) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    wr = np.ascontiguousarray(np.asarray(wr), dtype=np.float32)
    wd = np.ascontiguousarray(np.asarray(wd), dtype=np.float32)
    h, w = wr.shape
    if (wdr is None) != (wdl is None):
        raise ValueError(
            "fh04_merge: provide both diagonal weight images (wdr AND wdl) "
            "or neither")
    use_diag = int(wdr is not None)
    if use_diag:
        wdr = np.ascontiguousarray(np.asarray(wdr), dtype=np.float32)
        wdl = np.ascontiguousarray(np.asarray(wdl), dtype=np.float32)
    else:
        wdr = wr
        wdl = wr
    out = np.empty((h, w), dtype=np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    n = lib.boofcv_fh04(
        wr.ctypes.data_as(fp), wd.ctypes.data_as(fp),
        wdr.ctypes.data_as(fp), wdl.ctypes.data_as(fp),
        ctypes.c_int32(h), ctypes.c_int32(w), ctypes.c_int32(use_diag),
        ctypes.c_float(k), ctypes.c_int32(min_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, int(n)


def contours_with_holes(binary):
    """Full Chang2004 contours (external + internal per blob) via the
    native tracer; same structure as ``ip.binary.contours_with_holes``.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(np.asarray(binary) != 0, dtype=np.uint8)
    h, w = img.shape
    cap = max(4096, 6 * (h + 2) * (w + 2))
    max_c = max(1024, h * w // 4 + 8)
    for _ in range(2):
        xy = np.empty((cap, 2), dtype=np.int32)
        starts = np.zeros(max_c + 1, dtype=np.int32)
        meta = np.zeros((max_c, 2), dtype=np.int32)
        nc = lib.boofcv_contours_with_holes(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(h), ctypes.c_int32(w),
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(max_c),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if nc >= 0:
            n_blobs = int(meta[:nc, 0].max()) if nc else 0
            out = [{"label": i + 1, "external": None, "internal": []}
                   for i in range(n_blobs)]
            for c in range(nc):
                pts = xy[starts[c]:starts[c + 1]].copy()
                lab, kind = int(meta[c, 0]), int(meta[c, 1])
                if kind == 0:
                    if out[lab - 1]["external"] is None:
                        out[lab - 1]["external"] = pts
                else:
                    out[lab - 1]["internal"].append(pts)
            return out
        cap = 10 * (h + 2) * (w + 2)
        max_c = h * w + 8
    return None
