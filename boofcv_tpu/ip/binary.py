"""Binary-image operations: morphology, blob labeling, contours.

Reference analog: boofcv-ip alg/filter/binary/BinaryImageOps.java,
LinearContourLabelChang2004.java.  Morphology = min/max stencils (pure
elementwise).  Connected-component labeling — inherently sequential union-find in
the reference — becomes iterative min-label propagation under
``lax.while_loop`` (converges in O(diameter) sweeps, each sweep a fused
9-point stencil; fine for the blob sizes calibration/fiducial work sees).
Contour extraction is a host-side finisher on the labeled image.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _neighbor_stack(image: jnp.ndarray, eight: bool, pad_value):
    p = jnp.pad(image, 1, mode="constant", constant_values=pad_value)
    h, w = image.shape
    offs4 = [(0, 1), (1, 0), (1, 2), (2, 1)]
    offs8 = offs4 + [(0, 0), (0, 2), (2, 0), (2, 2)]
    offs = offs8 if eight else offs4
    return jnp.stack([p[dy:dy + h, dx:dx + w] for dy, dx in offs], axis=0)


def erode4(image: jnp.ndarray) -> jnp.ndarray:
    """BinaryImageOps.erode4: pixel survives iff all 4-neighbors are 1."""
    n = _neighbor_stack(image, False, 0)
    return (image.astype(jnp.uint8) & (jnp.min(n, axis=0) > 0)).astype(jnp.uint8)


def erode8(image: jnp.ndarray) -> jnp.ndarray:
    n = _neighbor_stack(image, True, 0)
    return (image.astype(jnp.uint8) & (jnp.min(n, axis=0) > 0)).astype(jnp.uint8)


def dilate4(image: jnp.ndarray) -> jnp.ndarray:
    n = _neighbor_stack(image, False, 0)
    return ((image > 0) | (jnp.max(n, axis=0) > 0)).astype(jnp.uint8)


def dilate8(image: jnp.ndarray) -> jnp.ndarray:
    n = _neighbor_stack(image, True, 0)
    return ((image > 0) | (jnp.max(n, axis=0) > 0)).astype(jnp.uint8)


def edge4(image: jnp.ndarray, outside_zero: bool = True) -> jnp.ndarray:
    """BinaryImageOps.edge4: 1-pixels with at least one 0 4-neighbor."""
    n = _neighbor_stack(image, False, 0 if outside_zero else 1)
    return ((image > 0) & (jnp.min(n, axis=0) == 0)).astype(jnp.uint8)


def edge8(image: jnp.ndarray, outside_zero: bool = True) -> jnp.ndarray:
    n = _neighbor_stack(image, True, 0 if outside_zero else 1)
    return ((image > 0) & (jnp.min(n, axis=0) == 0)).astype(jnp.uint8)


def remove_point_noise(image: jnp.ndarray) -> jnp.ndarray:
    """BinaryImageOps.removePointNoise: majority vote of 8-neighbors."""
    n = _neighbor_stack(image, True, 0)
    count = jnp.sum(n > 0, axis=0)
    return jnp.where(count > 5, 1, jnp.where(count < 3, 0, image)).astype(jnp.uint8)


def opening(image, eight=False, times=1):
    e, d = (erode8, dilate8) if eight else (erode4, dilate4)
    out = image
    for _ in range(times):
        out = e(out)
    for _ in range(times):
        out = d(out)
    return out


def closing(image, eight=False, times=1):
    e, d = (erode8, dilate8) if eight else (erode4, dilate4)
    out = image
    for _ in range(times):
        out = d(out)
    for _ in range(times):
        out = e(out)
    return out


def thin(binary: jnp.ndarray, max_iters: int = -1) -> jnp.ndarray:
    """Morphological thinning / skeletonization (BinaryThinning.java:45
    analog — the reference applies 8 hit-or-miss masks per pass; here the
    Zhang-Suen two-subpass formulation, whose deletion tests are pure
    parallel stencils, iterated under ``lax.while_loop`` until the
    skeleton stops changing).  Preserves connectivity and endpoints;
    output is a 1-px-wide skeleton."""
    img = (jnp.asarray(binary) > 0)
    h, w = img.shape

    def ring(cur):
        """8-neighbor ring ordered p2..p9 = N, NE, E, SE, S, SW, W, NW."""
        p = jnp.pad(cur, 1)
        offs = [(-1, 0), (-1, 1), (0, 1), (1, 1),
                (1, 0), (1, -1), (0, -1), (-1, -1)]
        return jnp.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy, dx in offs])

    def subpass(cur, parity):
        n = ring(cur)
        b = jnp.sum(n, axis=0)
        nxt = jnp.roll(n, -1, axis=0)
        a = jnp.sum((~n) & nxt, axis=0)          # 0->1 transitions in ring
        p2, p4, p6, p8 = n[0], n[2], n[4], n[6]
        if parity == 0:
            cond = ~(p2 & p4 & p6) & ~(p4 & p6 & p8)
        else:
            cond = ~(p2 & p4 & p8) & ~(p2 & p6 & p8)
        remove = cur & (b >= 2) & (b <= 6) & (a == 1) & cond
        return cur & ~remove

    def body(state):
        cur, _, it = state
        out = subpass(subpass(cur, 0), 1)
        return out, cur, it + 1

    def cond(state):
        cur, prev, it = state
        changed = jnp.any(cur != prev)
        if max_iters > 0:
            return changed & (it < max_iters)
        return changed

    out, _, _ = lax.while_loop(
        cond, body, (subpass(subpass(img, 0), 1), img, jnp.int32(1)))
    return out.astype(jnp.uint8)


def label_blobs(binary: jnp.ndarray, eight: bool = True,
                max_iters: int = 0) -> jnp.ndarray:
    """Connected-component labeling by iterative min-label propagation.

    Returns int32 label image; 0 = background, components numbered by the
    (raster) index of their minimum pixel + 1 (NOT compacted — use
    :func:`relabel_compact` for contiguous ids, as the reference's
    LinearContourLabelChang2004 produces).
    """
    h, w = binary.shape
    fg = binary > 0
    init = jnp.where(
        fg, jnp.arange(1, h * w + 1, dtype=jnp.int32).reshape(h, w), jnp.int32(0)
    )
    big = jnp.int32(h * w + 2)

    def sweep(labels):
        cur = jnp.where(fg, labels, big)
        n = _neighbor_stack(cur, eight, big)
        best = jnp.minimum(jnp.min(n, axis=0), cur)
        return jnp.where(fg, best, 0)

    def cond(state):
        labels, prev, it = state
        changed = jnp.any(labels != prev)
        if max_iters:
            return changed & (it < max_iters)
        return changed

    def body(state):
        labels, _, it = state
        return sweep(labels), labels, it + 1

    labels0 = sweep(init)
    labels, _, _ = lax.while_loop(cond, body, (labels0, init, jnp.int32(0)))
    return labels


def relabel_compact(labels) -> np.ndarray:
    """Host-side: renumber labels to 1..N (background stays 0)."""
    lab = np.asarray(labels)
    uniq = np.unique(lab)
    uniq = uniq[uniq != 0]
    out = np.zeros_like(lab)
    for i, u in enumerate(uniq, start=1):
        out[lab == u] = i
    return out


def label_blobs_host(binary, eight: bool = True):
    """Host-side union-find CCL (native C++ when available): returns
    (labels [H, W] int32 numbered 1..N in raster order, N).  Same output as
    ``relabel_compact(label_blobs(binary))`` but O(H*W) on the host — the
    fast path for host-driven detectors (fiducials, QR, targets)."""
    from boofcv_tpu import native
    res = native.ccl(binary, eight=eight)
    if res is not None:
        return res
    lab = relabel_compact(label_blobs(jnp.asarray(np.asarray(binary) > 0),
                                      eight=eight))
    return lab, int(lab.max())


def contour_external(binary, label: int | None = None) -> list[np.ndarray]:
    """Host-side external contour tracing (Moore neighborhood, CW), analog of
    LinearExternalContours.java.  Returns a list of [K, 2] (x, y) arrays,
    ONE per blob, ordered by blob label (raster order of first pixels).
    ``label`` selects a single blob (1-based ``label_blobs`` id).

    Implementation note: the raw west-neighbor-is-background scan start
    (the old fast path, still used by native boofcv_external_contours)
    ALSO fires on blob pixels east of an interior hole, emitting the
    hole's surrounding walk as a spurious extra "external" contour —
    every dark ring (QR finder, square fiducial border) produced a
    duplicate inner candidate.  Externals are therefore taken from the
    per-label Chang2004 tracer (:func:`contours_with_holes`), which
    keeps exactly one external contour per blob."""
    res = contours_with_holes(binary)
    ext = [d["external"] for d in res if d["external"] is not None]
    if label is not None:
        idx = label - 1
        if idx < 0 or idx >= len(res) or res[idx]["external"] is None:
            return []
        return [res[idx]["external"]]
    return ext


# Moore neighborhood (dy, dx), clockwise in image coords starting from W
_NBR = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)]


def _trace_radial(padded, traced, y, x, backtrack):
    """Radial-sweep Moore trace from (y, x) in padded coords, entering
    with the background ``backtrack`` neighbor index; terminates when the
    (pixel, direction) state repeats — visits every boundary pixel
    exactly as the reference's tracer (LinearContourLabelChang2004 uses
    the same walker for external and internal contours, differing only
    in start pixel and initial backtrack)."""
    first = None
    for i in range(1, 9):
        dd = (backtrack + i) % 8
        if padded[y + _NBR[dd][0], x + _NBR[dd][1]]:
            first = dd
            break
    if first is None:  # isolated pixel
        traced[y, x] = True
        return np.array([(x - 1, y - 1)], dtype=np.int32)
    contour = []
    states = set()
    cy, cx, d = y, x, first
    while (cy, cx, d) not in states:
        states.add((cy, cx, d))
        contour.append((cx - 1, cy - 1))
        traced[cy, cx] = True
        cy, cx = cy + _NBR[d][0], cx + _NBR[d][1]
        for i in range(8):
            dd = (d + 6 + i) % 8
            if padded[cy + _NBR[dd][0], cx + _NBR[dd][1]]:
                d = dd
                break
    return np.array(contour, dtype=np.int32)


def contours_with_holes(binary) -> list[dict]:
    """External AND internal contour tracing — the full
    LinearContourLabelChang2004.java:59 behavior (the external-only fast
    path is :func:`contour_external`).  Host-side finisher.

    Returns one dict per blob (raster order, matching
    ``label_blobs_host`` ids 1..N): ``{"label": i, "external": [K, 2]
    (x, y), "internal": [[K_j, 2], ...]}`` where each internal contour
    walks the blob pixels surrounding one hole.  Uses the native C++
    tracer (native/ccl.cpp boofcv_contours_with_holes) when available;
    the Python walker below is the reference fallback."""
    from boofcv_tpu import native
    res = native.contours_with_holes(binary)
    if res is not None:
        return res
    img = np.asarray(binary) > 0
    h, w = img.shape
    labels, n = label_blobs_host(img, eight=True)

    padded = np.zeros((h + 2, w + 2), dtype=bool)
    padded[1:-1, 1:-1] = img
    traced = np.zeros_like(padded)

    out = [{"label": i + 1, "external": None, "internal": []}
           for i in range(n)]
    for y in range(1, h + 1):
        for x in range(1, w + 1):
            if not padded[y, x] or traced[y, x] or padded[y, x - 1]:
                continue
            c = _trace_radial(padded, traced, y, x, 0)
            lab = labels[c[0, 1], c[0, 0]]
            if out[lab - 1]["external"] is None:
                out[lab - 1]["external"] = c

    # holes: background components (4-connected, the dual of 8-connected
    # blobs) that do not touch the image border
    bg_labels, n_bg = label_blobs_host(~img, eight=False)
    border = np.zeros(n_bg + 1, bool)
    for edge in (bg_labels[0], bg_labels[-1], bg_labels[:, 0],
                 bg_labels[:, -1]):
        border[np.unique(edge[edge > 0])] = True
    hole_traced = np.zeros_like(padded)
    for hid in range(1, n_bg + 1):
        if border[hid]:
            continue
        ys, xs = np.nonzero(bg_labels == hid)
        k = np.lexsort((xs, ys))[0]          # topmost-leftmost hole pixel
        hy, hx = int(ys[k]) + 1, int(xs[k]) + 1
        # the pixel above it is a blob pixel on the hole's boundary;
        # backtrack points south into the hole (index 6)
        c = _trace_radial(padded, hole_traced, hy - 1, hx, 6)
        lab = labels[c[0, 1], c[0, 0]]
        out[lab - 1]["internal"].append(c)
    return out
