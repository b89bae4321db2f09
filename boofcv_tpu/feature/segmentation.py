"""Image segmentation: SLIC superpixels, Felzenszwalb-style graph merge,
watershed, mean-shift.

Reference analog: boofcv-feature alg/segmentation/ — slic/SegmentSlic.java,
fh04/SegmentFelzenszwalbHuttenlocher04.java, watershed/WatershedVincentSoille1991.java,
ms/SegmentMeanShift*.

Design: SLIC is the batched one (k-means over a 5D embedding with
spatially-limited assignment — all batched); mean-shift filtering is an
iterated local weighted average (stencil); watershed and FH's union-find
merging are host-side finishers on small label images (documented
limitation, as in SURVEY §2.3: "union-find-heavy -> CPU or iterative
relabel").
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def slic(image, num_segments: int = 100, compactness: float = 10.0,
         iterations: int = 10):
    """SLIC superpixels (SegmentSlic.java).

    image: [H, W] gray or [H, W, 3] color.  Returns int32 label image
    [H, W] with labels in [0, num_segments).  Assignment is computed over
    ALL clusters per pixel (regular shapes) rather than the 2S-window trick —
    at BoofCV's segment counts this is one [H*W, K] distance matrix, one
    matmul.
    """
    img = jnp.asarray(image, jnp.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    # initial cluster centers on a grid
    s = int(np.sqrt(h * w / num_segments))
    gy = np.arange(s // 2, h, s)
    gx = np.arange(s // 2, w, s)
    cy, cx = np.meshgrid(gy, gx, indexing="ij")
    cy = cy.ravel()[:num_segments]
    cx = cx.ravel()[:num_segments]
    k = len(cy)
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    feats = jnp.concatenate([img.reshape(-1, c),
                             ys.reshape(-1, 1), xs.reshape(-1, 1)], axis=1)
    ratio = compactness / s

    centers = jnp.concatenate([
        img[jnp.asarray(cy), jnp.asarray(cx)].reshape(k, c),
        jnp.stack([jnp.asarray(cy, jnp.float32),
                   jnp.asarray(cx, jnp.float32)], axis=1)], axis=1)

    scale = jnp.concatenate([jnp.ones((c,), jnp.float32),
                             jnp.full((2,), ratio, jnp.float32)])

    def body(_, centers):
        d = feats[:, None, :] * scale - centers[None, :, :] * scale
        dist = jnp.sum(d * d, axis=-1)                   # [HW, K]
        lab = jnp.argmin(dist, axis=1)
        onehot = jax.nn.one_hot(lab, k, dtype=jnp.float32)  # [HW, K]
        sums = onehot.T @ feats                           # [K, C+2]
        counts = jnp.sum(onehot, axis=0)[:, None]
        return jnp.where(counts > 0, sums / jnp.maximum(counts, 1), centers)

    centers = lax.fori_loop(0, iterations, body, centers)
    d = feats[:, None, :] * scale - centers[None, :, :] * scale
    lab = jnp.argmin(jnp.sum(d * d, axis=-1), axis=1)
    return lab.reshape(h, w).astype(jnp.int32)


def mean_shift_filter(image, spatial_radius: int = 3,
                      range_sigma: float = 15.0, iterations: int = 5):
    """Edge-preserving mean-shift filtering (the smoothing stage of
    SegmentMeanShiftSearchGray): each pixel moves toward the range-weighted
    local mean.  Returns the filtered image."""
    img = jnp.asarray(image, jnp.float32)
    r = spatial_radius
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]

    def body(_, cur):
        num = jnp.zeros_like(cur)
        den = jnp.zeros_like(cur)
        for dy, dx in offs:
            nb = jnp.roll(jnp.roll(cur, dy, 0), dx, 1)
            w = jnp.exp(-0.5 * ((nb - cur) / range_sigma) ** 2)
            num = num + w * nb
            den = den + w
        return num / den

    return lax.fori_loop(0, iterations, body, img)


def segment_mean_shift(image, spatial_radius: int = 3,
                       range_sigma: float = 15.0,
                       merge_threshold: float = 8.0,
                       min_region: int = 20):
    """Mean-shift segmentation: filter, then host-side connected-component
    merge of similar neighbors (SegmentMeanShift pipeline)."""
    filtered = np.asarray(mean_shift_filter(image, spatial_radius,
                                            range_sigma))
    h, w = filtered.shape
    # union-find over 4-neighbors with range merge criterion (host)
    from boofcv_tpu.utils.unionfind import UnionFind
    uf = UnionFind(h * w)
    flat = filtered.ravel()
    for y in range(h):
        for x in range(w):
            i = y * w + x
            if x + 1 < w and abs(flat[i] - flat[i + 1]) < merge_threshold:
                uf.union(i, i + 1)
            if y + 1 < h and abs(flat[i] - flat[i + w]) < merge_threshold:
                uf.union(i, i + w)
    return uf.labels().reshape(h, w).astype(np.int32), filtered


def watershed(image, markers):
    """Marker-controlled watershed (WatershedVincentSoille1991 analog) via
    iterative lowest-neighbor label propagation on device.

    image: [H, W] 'height'; markers: int32 [H, W], 0 = unlabeled.
    Returns label image (every pixel assigned to a marker basin).
    """
    img = jnp.asarray(image, jnp.float32)
    lab0 = jnp.asarray(markers, jnp.int32)
    big = jnp.float32(3.4e38)

    # Minimax-path flood (image foresting transform with max-arc cost):
    # each pixel joins the seed reachable over the LOWEST pass height
    # reach[p] = min over paths of max height along the path.  A parallel
    # fixpoint of Bellman-Ford-style relaxations — order-independent,
    # unlike a BFS race where a near seed's front can cross a ridge
    # before a far seed's front arrives (the failure mode of the naive
    # propagate-per-round formulation).  Equivalent basin assignment to
    # the reference's height-ordered Vincent-Soille flood.
    reach0 = jnp.where(lab0 > 0, img, big)

    def relax(state):
        lab, reach, _ = state
        best_lab, best_reach = lab, reach
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nl = jnp.roll(best_lab, (dy, dx), (0, 1))
            nr = jnp.roll(best_reach, (dy, dx), (0, 1))
            # off-edge wrap: neutralize by making the wrapped lane +inf
            if dy == 1:
                nr = nr.at[0, :].set(big)
            if dy == -1:
                nr = nr.at[-1, :].set(big)
            if dx == 1:
                nr = nr.at[:, 0].set(big)
            if dx == -1:
                nr = nr.at[:, -1].set(big)
            cand = jnp.maximum(nr, img)
            better = (nl > 0) & (cand < best_reach)
            best_lab = jnp.where(better, nl, best_lab)
            best_reach = jnp.where(better, cand, best_reach)
        # seeds never change owner
        best_lab = jnp.where(lab0 > 0, lab0, best_lab)
        best_reach = jnp.where(lab0 > 0, reach0, best_reach)
        return best_lab, best_reach, (best_lab != lab) \
            | (best_reach != reach)

    def body(state):
        lab, reach, _ = state
        changed = jnp.zeros_like(lab, dtype=bool)
        for _ in range(8):          # amortize the while condition
            lab, reach, ch = relax((lab, reach, changed))
            changed = changed | ch
        return lab, reach, jnp.any(changed)

    def cond(state):
        return state[2]

    lab, _, _ = lax.while_loop(
        cond, body, (lab0, reach0, jnp.asarray(True)))
    return lab


def fh04_edge_weights(image, sigma: float = 0.8, eight: bool = True):
    """Device-side edge weights for FH04: Gaussian-smoothed intensity (or
    per-channel color) differences to the right/down(/diagonal) neighbors.

    Returns (wr, wd, wdr, wdl) [H, W] f32 (wdr/wdl None for 4-conn)."""
    from boofcv_tpu.ip import blur

    img = image.astype(jnp.float32)
    if img.ndim == 2:
        img = img[..., None]
    sm = jnp.stack([blur.gaussian(img[..., c], sigma=sigma)
                    for c in range(img.shape[-1])], axis=-1)

    def diff(shift_y, shift_x):
        rolled = jnp.roll(sm, (-shift_y, -shift_x), axis=(0, 1))
        return jnp.sqrt(jnp.sum((sm - rolled) ** 2, axis=-1))

    wr = diff(0, 1)
    wd = diff(1, 0)
    if not eight:
        return wr, wd, None, None
    return wr, wd, diff(1, 1), diff(1, -1)


def segment_fh04(image, k: float = 300.0, min_size: int = 20,
                 sigma: float = 0.8, eight: bool = True):
    """Felzenszwalb-Huttenlocher 2004 graph segmentation
    (SegmentFelzenszwalbHuttenlocher04.java:81).

    Edge weights on device; the sorted-edge union-find merge runs in the
    native C++ finisher (native/ccl.cpp boofcv_fh04), with a NumPy
    fallback.  Returns (labels int32 [H, W], count).
    """
    from boofcv_tpu import native

    wr, wd, wdr, wdl = fh04_edge_weights(image, sigma=sigma, eight=eight)
    res = native.fh04_merge(wr, wd, wdr, wdl, k=k, min_size=min_size)
    if res is not None:
        return res
    return _fh04_merge_numpy(np.asarray(wr), np.asarray(wd),
                             None if wdr is None else np.asarray(wdr),
                             None if wdl is None else np.asarray(wdl),
                             k, min_size)


def _fh04_merge_numpy(wr, wd, wdr, wdl, k, min_size):
    """Pure-NumPy fallback of the FH04 merge (same output as the C++)."""
    h, w = wr.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    ea, eb, ew = [], [], []
    ea.append(idx[:, :-1].ravel()); eb.append(idx[:, 1:].ravel())
    ew.append(wr[:, :-1].ravel())
    ea.append(idx[:-1, :].ravel()); eb.append(idx[1:, :].ravel())
    ew.append(wd[:-1, :].ravel())
    if wdr is not None:
        ea.append(idx[:-1, :-1].ravel()); eb.append(idx[1:, 1:].ravel())
        ew.append(wdr[:-1, :-1].ravel())
        ea.append(idx[:-1, 1:].ravel()); eb.append(idx[1:, :-1].ravel())
        ew.append(wdl[:-1, 1:].ravel())
    ea = np.concatenate(ea); eb = np.concatenate(eb)
    ew = np.concatenate(ew)
    order = np.argsort(ew, kind="stable")
    from boofcv_tpu.utils.unionfind import UnionFind
    uf = UnionFind(n)
    parent = uf.parent          # FH04 keeps bespoke size/threshold unions
    find = uf.find
    size = np.ones(n, np.int64)
    thresh = np.full(n, k, np.float64)

    for e in order:
        a, b, wgt = find(ea[e]), find(eb[e]), ew[e]
        if a == b:
            continue
        if wgt <= thresh[a] and wgt <= thresh[b]:
            if size[a] < size[b]:
                a, b = b, a
            parent[b] = a
            size[a] += size[b]
            thresh[a] = wgt + k / size[a]
    if min_size > 1:
        for e in order:
            a, b = find(ea[e]), find(eb[e])
            if a != b and (size[a] < min_size or size[b] < min_size):
                if size[a] < size[b]:
                    a, b = b, a
                parent[b] = a
                size[a] += size[b]
    labels = uf.labels()
    # renumber in raster order of first occurrence
    first = {}
    out = np.empty(n, np.int32)
    nxt = 0
    for i, r in enumerate(labels):
        if r not in first:
            first[r] = nxt
            nxt += 1
        out[i] = first[r]
    return out.reshape(h, w), nxt
