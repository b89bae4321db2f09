"""Canny edge detection family.

Reference analog: boofcv-feature alg/feature/detect/edge/CannyEdge.java:45
(blur -> gradient -> direction-discretized non-max -> hysteresis threshold),
GradientToEdgeFeatures.java (intensity/direction ops),
HysteresisEdgeTraceMark.java:37 / HysteresisEdgeTracePoints.java (tracing).

Shape: the whole detector is ONE jitted program — Gaussian blur and
Sobel are fused stencils, the direction-discretized non-max is a gather-free
4-way select over shifted images, and hysteresis (a sequential flood fill in
the reference) becomes iterative mask propagation under ``lax.while_loop``
(the same fixpoint trick as ``ip.binary.label_blobs``): strong seeds dilate
through the weak mask until convergence, 8 sweeps per trip to amortize the
loop condition.  Edge-chain extraction (the reference's
HysteresisEdgeTracePoints output) is a host-side finisher on the final mask.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from boofcv_tpu.ip import blur as ip_blur
from boofcv_tpu.ip import derivative


def discretize_direction4(dx: jnp.ndarray, dy: jnp.ndarray) -> jnp.ndarray:
    """GradientToEdgeFeatures.discretizeDirection4: gradient angle folded
    to [0, pi) and binned into 4 sectors: 0 = horizontal gradient (edge
    runs vertically; compare E/W neighbors), 1 = 45deg, 2 = vertical,
    3 = 135deg."""
    theta = jnp.arctan2(dy, dx)
    theta = jnp.where(theta < 0, theta + jnp.pi, theta)          # [0, pi)
    sector = jnp.floor((theta + jnp.pi / 8) / (jnp.pi / 4)).astype(jnp.int32)
    return sector % 4


def _shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img sampled at (y+dy, x+dx) with zero padding (off-image neighbors
    never suppress: they read as 0 intensity)."""
    h, w = img.shape
    p = jnp.pad(img, 1)
    return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def nonmax_direction4(intensity: jnp.ndarray,
                      direction: jnp.ndarray) -> jnp.ndarray:
    """Non-maximum suppression along the discretized gradient direction
    (ImplEdgeNonMaxSuppression analog): a pixel survives iff its intensity
    is strictly > the negative-direction neighbor and >= the positive one
    — the strict side breaks the exact tie a symmetric blurred step
    produces (two equal maxima straddling the edge), keeping edges one
    pixel thin."""
    # neighbors lie ALONG the gradient vector: sector 1 is a gradient at
    # ~45deg = (+x, +y) -> compare the NW/SE diagonal; sector 3 (135deg,
    # gradient (-x, +y)) -> NE/SW.  (These two were swapped originally,
    # which compared along the iso-contour and suppressed diagonal edges.)
    pairs = [((0, -1), (0, 1)),    # sector 0: horizontal gradient
             ((-1, -1), (1, 1)),   # sector 1: 45deg
             ((-1, 0), (1, 0)),    # sector 2: vertical
             ((-1, 1), (1, -1))]   # sector 3: 135deg
    keep = jnp.zeros(intensity.shape, bool)
    for s, (a, b) in enumerate(pairs):
        na = _shift(intensity, *a)
        nb = _shift(intensity, *b)
        ok = (intensity > na) & (intensity >= nb)
        keep = jnp.where(direction == s, ok, keep)
    return jnp.where(keep, intensity, 0.0)


def _dilate8_masked(strong: jnp.ndarray, weak: jnp.ndarray) -> jnp.ndarray:
    h, w = strong.shape
    p = jnp.pad(strong, 1)
    grown = jnp.zeros_like(strong)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown = grown | p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    return grown & weak


def hysteresis(nms: jnp.ndarray, low: float, high: float) -> jnp.ndarray:
    """Double threshold + connectivity: pixels >= high seed; pixels >=
    low are kept iff 8-connected (through other weak pixels) to a seed.
    Sequential flood fill in the reference (HysteresisEdgeTraceMark);
    here a parallel fixpoint of masked dilation."""
    weak = nms >= low
    strong = nms >= high

    def cond(state):
        cur, prev = state
        return jnp.any(cur != prev)

    def body(state):
        cur, _ = state
        nxt = cur
        for _ in range(8):      # amortize the while condition
            nxt = _dilate8_masked(nxt, weak)
        return nxt, cur

    strong, _ = lax.while_loop(
        cond, body, (_dilate8_masked(strong, weak) | strong, strong))
    return strong.astype(jnp.uint8)


def canny(image, low: float, high: float, sigma: float = -1.0,
          radius: int = 2, relative: bool = False) -> jnp.ndarray:
    """CannyEdge.process: returns the binary edge mask [H, W] uint8.

    ``relative=True`` interprets low/high as fractions of the max edge
    intensity (CannyEdge's dynamic-threshold mode).  Intensity is the
    Euclidean gradient norm (GradientToEdgeFeatures.intensityE).
    """
    img = jnp.asarray(image, jnp.float32)
    blurred = ip_blur.gaussian(img, sigma=sigma, radius=radius)
    dx, dy = derivative.sobel(blurred)
    intensity = jnp.hypot(dx, dy)
    direction = discretize_direction4(dx, dy)
    nms = nonmax_direction4(intensity, direction)
    if relative:
        # a featureless frame's max(nms) is float-noise-level (exactly 0
        # or ~eps from the blur); an absolute floor scaled to the image
        # range keeps the thresholds above fp noise so the mask comes
        # back empty instead of all-noise
        floor = 1e-4 * (1.0 + jnp.max(jnp.abs(img)))
        m = jnp.max(nms)
        lo = jnp.maximum(low * m, floor)
        hi = jnp.maximum(high * m, floor)
        return hysteresis(nms, lo, hi)
    return hysteresis(nms, low, high)


def edge_contours(mask) -> list[np.ndarray]:
    """HysteresisEdgeTracePoints analog: group the edge mask into
    8-connected chains and order each chain by walking from an endpoint.

    Host-side finisher, VECTORIZED (r5 — the per-pixel Python walk cost
    ~10 us/pixel and dominated dense 640x480 frames): neighbor ids are
    precomputed as one [N, 8] gather over shifted index images, then ALL
    chains advance one step per numpy iteration in parallel — each
    round seeds ONE walker per 8-connected component of the remaining
    pixels (endpoint preferred), and every walker claims its first
    unvisited neighbor (4-connected directions preferred, matching the
    sequential tracer's tie-break); per-component seeding means walkers
    can never collide.  Wall clock is O(longest chain) numpy steps of
    O(active walkers) work.  Leftover pixels (branches past junctions,
    pure loops) seed further rounds until every pixel is claimed.

    Returns a list of [K, 2] (x, y) int32 arrays covering every edge
    pixel exactly once, consecutive entries 8-adjacent.
    """
    m = np.asarray(mask) > 0
    h, w = m.shape
    ys, xs = np.nonzero(m)
    n = len(ys)
    if n == 0:
        return []
    idx = np.full((h, w), -1, np.int32)
    idx[ys, xs] = np.arange(n, dtype=np.int32)
    # 4-connected offsets first: the sequential tracer preferred the
    # tighter continuation
    offs = [(0, -1), (0, 1), (-1, 0), (1, 0),
            (-1, -1), (-1, 1), (1, -1), (1, 1)]
    p = np.full((h + 2, w + 2), -1, np.int32)
    p[1:-1, 1:-1] = idx
    nbr = np.stack([p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w][ys, xs]
                    for dy, dx in offs], axis=1)            # [N, 8]

    visited = np.zeros(n, bool)
    chain_of = np.empty(n, np.int64)
    step_of = np.empty(n, np.int64)
    next_chain = 0

    def run_walkers(starts):
        nonlocal next_chain
        cur = starts
        cid = next_chain + np.arange(len(starts))
        next_chain += len(starts)
        visited[cur] = True
        chain_of[cur] = cid
        step_of[cur] = 0
        step = 1
        while len(cur):
            cand = nbr[cur]                                  # [A, 8]
            ok = (cand >= 0) & ~visited[np.clip(cand, 0, n - 1)]
            any_ok = ok.any(1)
            cur, cid = cur[any_ok], cid[any_ok]
            if not len(cur):
                break
            pick = ok[any_ok].argmax(1)
            # one walker per 8-connected component (seeding below), so
            # two walkers can never claim the same pixel — no conflict
            # resolution needed
            cur = cand[any_ok, pick]
            visited[cur] = True
            chain_of[cur] = cid
            step_of[cur] = step
            step += 1

    # each round seeds ONE walker per connected component of the
    # remaining pixels (endpoint preferred, like the sequential tracer)
    # — so walkers can never meet on the same curve and split it
    from scipy import ndimage as ndi
    eight = np.ones((3, 3), bool)
    while not visited.all():
        rem = np.zeros((h, w), bool)
        rem[ys[~visited], xs[~visited]] = True
        comp, _ = ndi.label(rem, structure=eight)
        comp_of = comp[ys, xs]                               # 0 if visited
        rem_deg = (nbr >= 0) & ~visited[np.clip(nbr, 0, n - 1)]
        rem_deg = rem_deg.sum(1)
        # rank: endpoints of the remaining subgraph first
        cand = np.flatnonzero(~visited)
        rank = np.lexsort((cand, (rem_deg[cand] > 1).astype(np.int8)))
        cand = cand[rank]
        _, first = np.unique(comp_of[cand], return_index=True)
        run_walkers(cand[first])

    order = np.lexsort((step_of, chain_of))
    pts = np.stack([xs, ys], 1).astype(np.int32)[order]
    bounds = np.flatnonzero(np.diff(chain_of[order])) + 1
    return np.split(pts, bounds)


def canny_contours(image, low: float, high: float, sigma: float = -1.0,
                   radius: int = 2, relative: bool = False
                   ) -> list[np.ndarray]:
    """CannyEdge with point-chain output (HysteresisEdgeTracePoints)."""
    return edge_contours(canny(image, low, high, sigma=sigma, radius=radius,
                               relative=relative))
