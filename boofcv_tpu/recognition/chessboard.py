"""Chessboard calibration-target detection.

Reference analog: boofcv-recognition abst/fiducial/calib/
CalibrationDetectorChessboard + boofcv-feature alg/feature/detect/chess/
DetectChessboardCorners2.java (XCornerAbeles2019Intensity x-corner
response, corner graph assembly into a grid).

Design: the x-corner intensity is a fixed ring-sample stencil over
the blurred image (batched for all pixels); subpixel refinement reuses
extract.subpixel_quadratic; grid assembly (ordering corners into rows x
cols) is a small host-side nearest-neighbor walk.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.ip import blur as blur_mod
from boofcv_tpu.core.border import BorderType, pad
from boofcv_tpu.feature import extract


def xcorner_intensity(image) -> jnp.ndarray:
    """X-corner response (XCornerAbeles2019Intensity analog).

    Samples a radius-2-ish ring at 4 'a' points (diagonal) and 4 'b'
    points (axis-aligned): a chessboard corner has a+c similar, b+d
    similar, and the two pairs very different.
    response = (a1+a3-b2-b4)^2-ish combination; we use the product form
    (a1-m)(a3-m) + (b2-m)(b4-m) with m = local mean, positive at
    x-corners of either polarity.
    """
    img = blur_mod.gaussian(jnp.asarray(image, jnp.float32), sigma=1.0,
                            border=BorderType.EXTENDED)
    p = pad(img, 2, 2, BorderType.EXTENDED)
    h, w = img.shape

    def s(dy, dx):
        return p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    a1 = s(-2, -2)
    a2 = s(-2, 2)
    a3 = s(2, 2)
    a4 = s(2, -2)
    b1 = s(-2, 0)
    b2 = s(0, 2)
    b3 = s(2, 0)
    b4 = s(0, -2)
    mean = (a1 + a2 + a3 + a4 + b1 + b2 + b3 + b4) / 8.0
    # |diagonal-pair correlation - axis-pair correlation|: the absolute
    # value covers the 45-degree-rotated corner (which negates the
    # expression); the old max(r1, -r1) computed the same thing with
    # every product duplicated
    r1 = (a1 - mean) * (a3 - mean) + (a2 - mean) * (a4 - mean) \
        - (b1 - mean) * (b3 - mean) - (b2 - mean) * (b4 - mean)
    return jnp.abs(r1)


def detect_corners(image, max_corners: int = 200, threshold_frac: float = 0.1):
    """X-corner detection + subpixel (DetectChessboardCorners2.process)."""
    inten = xcorner_intensity(image)
    thr = threshold_frac * float(jnp.max(inten))
    det = extract.detect(inten, max_features=max_corners, radius=3,
                         threshold=thr, border=4)
    ys, xs = extract.subpixel_quadratic(inten, det)
    return np.asarray(ys), np.asarray(xs), np.asarray(det.valid)


def assemble_grid(ys, xs, valid, rows: int, cols: int):
    """Order detected x-corners into a rows x cols grid (host-side analog
    of the reference's chessboard corner-graph clustering).

    Works for mildly distorted boards: estimates the dominant lattice
    directions from nearest-neighbor displacement clustering, then sorts
    corners into lattice coordinates.  Returns [rows*cols, 2] (x, y) in
    row-major order, or None if the expected count is missing.
    """
    pts = np.stack([xs[valid], ys[valid]], 1)
    n = rows * cols
    if len(pts) < n:
        return None
    # keep the n strongest is implicit (detect returns by score); if too
    # many, keep the n closest to the centroid cluster by robust distance
    if len(pts) > n:
        c = np.median(pts, axis=0)
        d = np.linalg.norm(pts - c, axis=1)
        pts = pts[np.argsort(d)[:n]]
    return _order_grid(pts, rows, cols)


def _convex_hull(pts):
    """Andrew monotone chain; returns hull vertices counter-clockwise."""
    p = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return ((a[0] - o[0]) * (b[1] - o[1])
                - (a[1] - o[1]) * (b[0] - o[0]))

    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in p[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1])


def _order_grid(pts, rows, cols):
    """Perspective-robust lattice ordering: find the 4 extreme corners on
    the convex hull (max-area quad), fit the grid->image homography for
    each cyclic corner assignment, and accept the one under which every
    corner rounds to a unique in-range lattice cell.  Exact under full
    projective distortion (the reference's corner-graph clustering plays
    the same role)."""
    from itertools import combinations
    from boofcv_tpu.geo import epipolar
    import jax.numpy as jnp

    n = rows * cols
    if len(pts) != n:
        return None
    hull = _convex_hull(pts)
    if len(hull) < 4:
        return None
    best_quad, best_area = None, -1.0
    for comb in combinations(range(len(hull)), 4):
        q = hull[list(comb)]
        area = 0.5 * abs(sum(
            q[i][0] * q[(i + 1) % 4][1] - q[(i + 1) % 4][0] * q[i][1]
            for i in range(4)))
        if area > best_area:
            best_area, best_quad = area, q

    grid_corners = np.array([[0.0, 0.0], [cols - 1.0, 0.0],
                             [cols - 1.0, rows - 1.0], [0.0, rows - 1.0]])
    candidates = []
    for k in range(4):
        quad = np.roll(best_quad, -k, axis=0)
        H = np.asarray(epipolar.homography_dlt(
            jnp.asarray(grid_corners[None]), jnp.asarray(quad[None])))[0]
        Hinv = np.linalg.inv(H)
        ph = np.concatenate([pts, np.ones((n, 1))], 1) @ Hinv.T
        lat = ph[:, :2] / ph[:, 2:]
        ij = np.round(lat).astype(int)
        if np.abs(lat - ij).max() > 0.35:
            continue
        if ij[:, 0].min() < 0 or ij[:, 0].max() >= cols or \
           ij[:, 1].min() < 0 or ij[:, 1].max() >= rows:
            continue
        flat = ij[:, 1] * cols + ij[:, 0]
        if len(set(flat.tolist())) != n:
            continue
        out = np.zeros((n, 2))
        out[flat] = pts
        candidates.append((quad[0], out))
    if not candidates:
        return None
    # canonical orientation among valid candidates: grid origin at the
    # quad corner with the smallest x+y (the board's 180-degree ambiguity
    # is inherent; this picks a deterministic one)
    candidates.sort(key=lambda c: c[0][0] + c[0][1])
    return candidates[0][1]


def _edge_is_lattice(image, p, q, n_t: int = 7, delta: float = 2.0):
    """True when the segment p->q runs along a black/white square border.

    Adjacent lattice corners are joined by a square edge: points offset
    perpendicular to the segment are consistently dark on one side and
    light on the other along its whole length.  Diagonal neighbors cut
    through square interiors and fail the consistency test.  Batched over
    edges: p, q [E, 2] (x, y).  (ChessboardCornerClusterFinder's
    edge-intensity check, vectorized.)
    """
    from boofcv_tpu.ip import interpolate

    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    d = q - p
    length = np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    u = d / length
    nrm = np.stack([-u[:, 1], u[:, 0]], 1)
    ts = (np.arange(1, n_t + 1) / (n_t + 1))[None, :, None]     # [1,T,1]
    mid = p[:, None, :] + d[:, None, :] * ts                     # [E,T,2]
    a = mid + delta * nrm[:, None, :]
    b = mid - delta * nrm[:, None, :]
    img = jnp.asarray(image, jnp.float32)
    va = np.asarray(interpolate.bilinear(img, jnp.asarray(a[..., 1]),
                                         jnp.asarray(a[..., 0])))
    vb = np.asarray(interpolate.bilinear(img, jnp.asarray(b[..., 1]),
                                         jnp.asarray(b[..., 0])))
    diff = va - vb                                               # [E, T]
    mag = np.abs(diff)
    contrast = np.median(mag, axis=1)
    same_sign = (np.abs(diff.sum(axis=1)) > 0.9 * mag.sum(axis=1))
    strong = (mag > 0.25 * contrast[:, None]).all(axis=1)
    return same_sign & strong & (contrast > 1e-3)


def assemble_grid_connectivity(image, ys, xs, valid=None, k_neighbors: int = 8):
    """Connectivity-graph grid assembly: UNKNOWN grid size, tolerant of
    occluded corners (DetectChessboardCorners2.java:60 +
    ChessboardCornerClusterFinder analog).

    1. candidate edges = k nearest neighbors per corner,
    2. keep edges whose segment runs along a square border
       (``_edge_is_lattice``) and is locally shortest-scale,
    3. BFS-assign integer lattice coordinates, each corner propagating
       its own local axis frame (robust to strong perspective),
    4. emit the [R, C, 2] grid (x, y) + [R, C] found-mask.

    Returns (grid, mask) or None when no coherent lattice exists.
    """
    ys = np.asarray(ys, np.float64)
    xs = np.asarray(xs, np.float64)
    if valid is not None:
        ys, xs = ys[np.asarray(valid)], xs[np.asarray(valid)]
    pts = np.stack([xs, ys], 1)
    n = len(pts)
    if n < 4:
        return None

    # --- candidate edges (kNN, deduped)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(k_neighbors, n - 1)
    nbr = np.argsort(d2, axis=1)[:, :k]
    cand = set()
    for i in range(n):
        for j in nbr[i]:
            cand.add((min(i, int(j)), max(i, int(j))))
    cand = sorted(cand)
    E = np.array(cand)                                  # [M, 2]

    # note: skip-one links along a lattice line are rejected by the
    # validator itself — the perpendicular black/white contrast FLIPS at
    # the skipped corner (squares alternate), failing the same-sign test —
    # so no additional length-ratio filter is needed (a ratio filter
    # would wrongly drop genuinely foreshortened edges at oblique views)
    ok = _edge_is_lattice(image, pts[E[:, 0]], pts[E[:, 1]])
    E = E[ok]
    if len(E) < 3:
        return None

    adj = [[] for _ in range(n)]
    for i, j in E:
        adj[i].append(int(j))
        adj[j].append(int(i))

    # --- BFS lattice-coordinate assignment with per-corner axis frames
    # seed: corner with the most edges (interior corners have 4)
    seed = int(np.argmax([len(a) for a in adj]))
    if len(adj[seed]) < 2:
        return None
    # seed axes: shortest edge -> u; most-perpendicular edge -> v
    dirs = [pts[j] - pts[seed] for j in adj[seed]]
    order = np.argsort([np.linalg.norm(d) for d in dirs])
    u0 = dirs[order[0]]
    v0 = None
    for o in order[1:]:
        d = dirs[o]
        cosang = abs(np.dot(u0, d)) / (np.linalg.norm(u0)
                                       * np.linalg.norm(d) + 1e-9)
        if cosang < 0.5:
            v0 = d
            break
    if v0 is None:
        return None
    if u0[0] * v0[1] - u0[1] * v0[0] < 0:
        u0, v0 = v0, u0                       # right-handed frame

    coord = {seed: (0, 0)}
    frame = {seed: (u0, v0)}
    queue = [seed]
    while queue:
        i = queue.pop(0)
        ui, vi = frame[i]
        ci = np.array(coord[i])
        for j in adj[i]:
            if j in coord:
                continue
            d = pts[j] - pts[i]
            # classify d against the local frame
            su = np.dot(d, ui) / (np.dot(ui, ui) + 1e-12)
            sv = np.dot(d, vi) / (np.dot(vi, vi) + 1e-12)
            if abs(su) > 2 * abs(sv) and 0.5 < abs(su) < 1.6:
                step = (int(np.sign(su)), 0)
                new_u, new_v = d * np.sign(su), vi
            elif abs(sv) > 2 * abs(su) and 0.5 < abs(sv) < 1.6:
                step = (0, int(np.sign(sv)))
                new_u, new_v = ui, d * np.sign(sv)
            else:
                continue
            cj = (ci[0] + step[0], ci[1] + step[1])
            coord[j] = cj
            frame[j] = (new_u, new_v)
            queue.append(j)

    if len(coord) < 4:
        return None
    ij = np.array([coord[i] for i in sorted(coord)])
    idxs = sorted(coord)
    ij -= ij.min(axis=0)
    C, R = ij[:, 0].max() + 1, ij[:, 1].max() + 1
    grid = np.zeros((R, C, 2))
    mask = np.zeros((R, C), bool)
    for i, (cu, cv) in zip(idxs, ij):
        if mask[cv, cu]:
            return None                       # coordinate collision
        grid[cv, cu] = pts[i]
        mask[cv, cu] = True
    # canonical orientation: origin corner = smallest x+y among the four
    # grid corners (deterministic under the board's 180-deg ambiguity)
    def score(g, m):
        return g[0, 0] @ np.ones(2) if m[0, 0] else np.inf
    best = (grid, mask)
    best_s = np.inf
    g, m = grid, mask
    for _ in range(4):
        g = np.transpose(g[:, ::-1], (1, 0, 2))      # rotate 90
        m = m[:, ::-1].T
        s = score(g, m)
        if s < best_s:
            best_s, best = s, (g.copy(), m.copy())
    s = score(grid, mask)
    if s < best_s:
        best = (grid, mask)
    return best


def detect_chessboard_auto(image, max_corners: int = 300):
    """Detect a chessboard of UNKNOWN size with possible occlusion.

    Returns (grid [R, C, 2] of (x, y), mask [R, C] bool) or None.
    """
    ys, xs, valid = detect_corners(image, max_corners)
    pts_y, pts_x = ys[valid], xs[valid]
    if len(pts_y) < 4:
        return None
    ok = validate_xcorners(image, pts_y, pts_x)
    if ok.sum() >= 4:
        pts_y, pts_x = pts_y[ok], pts_x[ok]
    return assemble_grid_connectivity(image, pts_y, pts_x)


def detect_chessboard(image, rows: int, cols: int, max_corners: int = 300):
    """Full pipeline: x-corners -> subpixel -> ring validation -> grid
    (CalibrationDetectorChessboard.process).  rows/cols = INNER corner
    counts.  Returns [rows*cols, 2] (x, y) or None."""
    ys, xs, valid = detect_corners(image, max_corners)
    pts = np.stack([xs[valid], ys[valid]], 1)
    n = rows * cols
    if len(pts) < n:
        return None
    # ring validation rejects noise peaks / board-boundary junctions that
    # can outscore true x-corners on real imagery
    ok = validate_xcorners(image, pts[:, 1], pts[:, 0])
    if ok.sum() >= n:
        pts = pts[ok]
    if len(pts) > n:
        # detections are score-ordered; among validated corners prefer the
        # spatially-coherent subset around the centroid
        c = np.median(pts, axis=0)
        d = np.linalg.norm(pts - c, axis=1)
        pts = pts[np.argsort(d)[:n]]
    return _order_grid(pts, rows, cols)


def validate_xcorners(image, ys, xs, radius: float = 4.5,
                      n_samples: int = 16):
    """Ring-sample x-corner validation (DetectChessboardCorners2's
    intensity-circle check, batched).

    A true x-corner shows four alternating dark/light arcs around a small
    circle — its ring intensity is dominated by the SECOND circular
    harmonic.  Edge points, L-corners and board-boundary junctions carry a
    strong first harmonic instead.  Returns a bool mask.
    """
    from boofcv_tpu.ip import interpolate

    th = jnp.arange(n_samples) * (2.0 * jnp.pi / n_samples)
    sy = jnp.asarray(ys)[:, None] + radius * jnp.sin(th)[None, :]
    sx = jnp.asarray(xs)[:, None] + radius * jnp.cos(th)[None, :]
    v = interpolate.bilinear(jnp.asarray(image, jnp.float32), sy, sx)
    v = v - jnp.mean(v, axis=1, keepdims=True)

    def harm(k):
        c = jnp.sum(v * jnp.cos(k * th)[None, :], axis=1)
        s = jnp.sum(v * jnp.sin(k * th)[None, :], axis=1)
        return c * c + s * s

    a1 = harm(1)
    a2 = harm(2)
    energy = jnp.sum(v * v, axis=1)
    # pure 2nd harmonic gives a2 = (n/2) * energy; require the 2nd
    # harmonic to dominate the 1st and carry most of the ring energy
    return np.asarray((a2 > 2.0 * a1)
                      & (a2 > 0.3 * (n_samples / 2.0) * energy))
