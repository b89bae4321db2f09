"""Spherical / equirectangular (360) image transforms.

Reference analog: boofcv-geo alg/distort/spherical/ —
EquirectangularTools_F32.java:59 (pixel <-> unit-sphere direction),
CameraToEquirectangular_F64.java (render a camera view onto the
equirect canvas), EquirectangularRotate_F64.java,
MultiCameraToEquirectangular.java (blend several wide cameras into one
360 canvas), and alg/distort/NarrowToWidePtoP_F64.java (pinhole <->
wide-FOV point transforms).

Shape: every transform is a dst->src warp-grid builder on
``ip.distort`` — the map is evaluated once as two [H, W] coordinate
grids (pure jnp, jit-friendly) and applied as a single batched bilinear
gather.  Camera frame convention: +x right, +y down, +z forward (the
library's pinhole convention); the equirect canvas's center pixel looks
along +z, longitude grows to the right, latitude downward.
"""

from __future__ import annotations

import jax.numpy as jnp

from boofcv_tpu.geo import cameras
from boofcv_tpu.ip import distort


def equi_to_unit(x, y, width: int, height: int):
    """Equirect pixel -> unit direction [..., 3]
    (EquirectangularTools.equiToNorm).  Continuous coordinates; the
    horizontal axis wraps."""
    lon = (x / width - 0.5) * (2.0 * jnp.pi)
    lat = (y / (height - 1) - 0.5) * jnp.pi
    cl = jnp.cos(lat)
    return jnp.stack([cl * jnp.sin(lon), jnp.sin(lat),
                      cl * jnp.cos(lon)], axis=-1)


def unit_to_equi(v, width: int, height: int):
    """Unit direction [..., 3] -> equirect pixel (x, y)
    (EquirectangularTools.normToEqui)."""
    lon = jnp.arctan2(v[..., 0], v[..., 2])
    lat = jnp.arcsin(jnp.clip(v[..., 1], -1.0, 1.0))
    x = (lon / (2.0 * jnp.pi) + 0.5) * width
    y = (lat / jnp.pi + 0.5) * (height - 1)
    return x, y


def _equi_grid_dirs(height: int, width: int, dtype=jnp.float32):
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=dtype),
                          jnp.arange(width, dtype=dtype), indexing="ij")
    return equi_to_unit(xs, ys, width, height)          # [H, W, 3]


def equi_rotate(image: jnp.ndarray, R) -> jnp.ndarray:
    """Rotate an equirect image: dst direction = R @ src direction
    (EquirectangularRotate_F64).  dst->src map uses R^T."""
    h, w = image.shape[:2]
    d = _equi_grid_dirs(h, w)
    Rm = jnp.asarray(R, jnp.float32)
    src = d @ Rm                                         # R^T @ d, batched
    mx, my = unit_to_equi(src, w, h)
    # horizontal wrap: warp() treats out-of-range as invalid, so fold x
    mx = jnp.mod(mx, w)
    return distort.warp(image, my, mx)


def equi_to_pinhole(equi: jnp.ndarray, cam: cameras.CameraPinhole, R,
                    out_shape) -> jnp.ndarray:
    """Extract a pinhole view from an equirect image
    (ExampleEquirectangularToPinhole): pinhole pixel -> ray -> rotate by
    camera-to-world ``R`` -> equirect sample."""
    oh, ow = out_shape
    eh, ew = equi.shape[:2]
    Rm = jnp.asarray(R, jnp.float32)

    def tf(xs, ys):
        nx, ny = cameras.pixel_to_norm(cam, xs, ys)
        d = jnp.stack([nx, ny, jnp.ones_like(nx)], axis=-1)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        dw = d @ Rm.T                                    # rotate to world
        ex, ey = unit_to_equi(dw, ew, eh)
        return jnp.mod(ex, ew), ey

    my, mx = distort.make_warp_grid(tf, oh, ow)
    return distort.warp(equi, my, mx)


def camera_to_equi_grid(cam, R, equi_shape, dtype=jnp.float32):
    """CameraToEquirectangular: dst->src map + validity rendering one
    camera (pinhole or universal-omni) onto the equirect canvas.
    Returns (map_y, map_x, valid [H, W]) — directions behind the camera
    are invalid (out-of-frame ones are masked by ``distort.warp``)."""
    eh, ew = equi_shape
    d = _equi_grid_dirs(eh, ew, dtype)                   # world dirs
    Rm = jnp.asarray(R, dtype)
    dc = d @ Rm                                          # R^T @ d: to camera
    if isinstance(cam, cameras.CameraUniversalOmni):
        mx, my = cameras.omni_project(cam, dc)
        # UCM validity: the sphere point must be in front of the
        # projection center shifted by the mirror offset
        valid = dc[..., 2] + cam.mirror_offset > 1e-6
    else:
        z = dc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        nx = dc[..., 0] / zs
        ny = dc[..., 1] / zs
        if isinstance(cam, cameras.CameraPinholeBrown):
            nx, ny = cameras.distort_norm(cam, nx, ny)
        mx, my = cameras.norm_to_pixel(cam, nx, ny)
        valid = z > 1e-6
    return my.astype(dtype), mx.astype(dtype), valid


def camera_to_equi(image: jnp.ndarray, cam, R, equi_shape) -> jnp.ndarray:
    """Render one camera image onto an equirect canvas (invalid -> 0)."""
    my, mx, valid = camera_to_equi_grid(cam, R, equi_shape)
    out = distort.warp(image, my, mx)
    if image.ndim == 3:
        valid = valid[..., None]
    return jnp.where(valid, out, 0.0)


def multi_camera_to_equi(images, cams, Rs, equi_shape) -> jnp.ndarray:
    """MultiCameraToEquirectangular: blend several (wide) cameras into a
    single 360 canvas.  Per-camera weights = validity masks feathered by
    the in-image distance to the frame edge, normalized across cameras."""
    eh, ew = equi_shape
    acc = jnp.zeros((eh, ew) + images[0].shape[2:], jnp.float32)
    wsum = jnp.zeros((eh, ew), jnp.float32)
    for img, cam, R in zip(images, cams, Rs):
        my, mx, valid = camera_to_equi_grid(cam, R, equi_shape)
        h, w = img.shape[:2]
        inb = valid & (my >= 0) & (my <= h - 1) & (mx >= 0) & (mx <= w - 1)
        # feather: distance to the source frame edge, saturating at 10 px
        edge = jnp.minimum(jnp.minimum(my, h - 1 - my),
                           jnp.minimum(mx, w - 1 - mx))
        wgt = jnp.where(inb, jnp.clip(edge / 10.0, 0.0, 1.0) + 1e-3, 0.0)
        smp = distort.warp(img, my, mx)
        acc = acc + (wgt[..., None] if acc.ndim == 3 else wgt) * smp
        wsum = wsum + wgt
    den = jnp.maximum(wsum, 1e-9)
    return acc / (den[..., None] if acc.ndim == 3 else den)


def narrow_to_wide(narrow_cam: cameras.CameraPinhole,
                   wide_cam: cameras.CameraUniversalOmni, R=None):
    """NarrowToWidePtoP_F64: returns ``f(x, y) -> (wx, wy)`` mapping
    narrow (pinhole) pixels to wide (universal-omni) pixels through the
    shared ray, with optional narrow-to-wide rotation ``R``."""
    Rm = None if R is None else jnp.asarray(R, jnp.float64)

    def f(xs, ys):
        nx, ny = cameras.pixel_to_norm(narrow_cam, xs, ys)
        d = jnp.stack([nx, ny, jnp.ones_like(nx)], axis=-1)
        if Rm is not None:
            d = d @ Rm.T
        return cameras.omni_project(wide_cam, d)

    return f


def wide_to_narrow(wide_cam: cameras.CameraUniversalOmni,
                   narrow_cam: cameras.CameraPinhole, R=None):
    """Inverse of :func:`narrow_to_wide` (WideToNarrowPtoP): wide pixel
    -> unit ray -> rotate by R^T -> pinhole pixel."""
    Rm = None if R is None else jnp.asarray(R, jnp.float64)

    def f(xs, ys):
        d = cameras.omni_pixel_to_unit(wide_cam, xs, ys)
        if Rm is not None:
            d = d @ Rm
        z = jnp.where(jnp.abs(d[..., 2]) < 1e-9, 1e-9, d[..., 2])
        return cameras.norm_to_pixel(narrow_cam, d[..., 0] / z,
                                     d[..., 1] / z)

    return f
