"""Square-grid and circle-grid calibration target detectors.

Reference analog: boofcv-recognition abst/fiducial/calib/
CalibrationDetectorSquareGrid.java (grid of black squares; calibration
points = the squares' corners), CalibrationDetectorCircleRegularGrid.java
(circles on a square lattice) and CalibrationDetectorCircleHexagonalGrid
.java (circles on a hexagonal lattice), backed by
alg/fiducial/calib/squares/SquareGridTools.java and
alg/fiducial/calib/circle/Key*Grid.java + EllipseClustersIntoGrid.

Design: thresholding + blob labeling run on device (elementwise +
iterative label propagation); contour tracing, shape fitting, and grid
ordering are host-side on the tiny extracted data — the same
device/host split the chessboard detector uses.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.ip import binary, threshold
from boofcv_tpu.feature import shapes
from boofcv_tpu.recognition.chessboard import _order_grid


def _black_blob_contours(image, min_area: int = 20):
    """Otsu threshold (dark shapes), label, trace external contours.
    Returns list of ([K,2] contour, area) for each big-enough blob.

    One labeling pass + one contour pass + one bincount: the previous
    per-blob ``lab == u`` rescans were O(blobs * H * W) — ~200 full-image
    passes on a noisy 640x480 frame before any detector logic ran."""
    img = jnp.asarray(image, jnp.float32)
    t = threshold.compute_otsu(img, float(jnp.min(img)), float(jnp.max(img)))
    bw = threshold.threshold(img, t, down=True)
    bw = binary.remove_point_noise(bw)
    lab = np.asarray(binary.label_blobs(bw))
    areas = np.bincount(lab.ravel())
    out = []
    for cont in binary.contour_external(np.asarray(bw).astype(np.uint8)):
        if len(cont) == 0:
            continue
        u = int(lab[cont[0][1], cont[0][0]])     # contour points are (x, y)
        if u == 0 or areas[u] < min_area:
            continue
        out.append((cont, int(areas[u])))
    return out


def _square_quad_candidates(image, min_area: int = 20):
    """Convex-quad candidates from dark blobs: list of
    (corners [4,2], center [2], side_length)."""
    h, w = np.asarray(image).shape
    out = []
    for contour, area in _black_blob_contours(image, min_area):
        poly = shapes.fit_polygon(contour, num_sides=4)
        if poly is None or len(poly) != 4:
            continue
        if not shapes.polygon_is_convex(poly):
            continue
        q = np.asarray(poly, np.float64)
        # squares clipped by the image border trace the frame edge and
        # fit a quad with corners far from the true (off-image) ones —
        # the reference's detector likewise drops border-touching shapes
        if (q[:, 0] < 1).any() or (q[:, 0] > w - 2).any() \
                or (q[:, 1] < 1).any() or (q[:, 1] > h - 2).any():
            continue
        sides = np.linalg.norm(np.roll(q, -1, 0) - q, axis=1)
        # a projected square keeps side ratios bounded; blobs that fit a
        # sliver quad are contour noise
        if sides.min() < 0.25 * sides.max():
            continue
        out.append((q, q.mean(0), float(sides.mean())))
    return out



def _canonical_rotation(grid, mask, out_shape):
    """Among the proper rotations of (grid, mask) matching ``out_shape``
    with every cell present, return the one whose origin cell has the
    smallest x+y (the `_order_grid` convention) — or None.  Two of the
    four rotations match for non-square shapes (k and k+2), all four
    for square shapes; picking the FIRST match made per-view orderings
    flip 180 degrees nondeterministically."""
    best = None
    for k in range(4):
        g = np.rot90(grid, k, axes=(0, 1))
        m = np.rot90(mask, k)
        if m.shape == out_shape and m.all():
            s = float(g[0, 0].sum())
            if best is None or s < best[0]:
                best = (s, g)
    return None if best is None else best[1]


def detect_square_grid_auto(image, min_area: int = 20, quads=None):
    """Square-grid target with UNKNOWN size and occlusion tolerance
    (SquaresIntoRegularClusters.java + SquareGridTools.java:37 analog).

    Pipeline: convex-quad candidates (clustered implicitly by the
    size-consistency gate) -> the squares' CENTERS form a regular
    lattice, grown with the same frame-propagating BFS + homography
    refinement the circle grids use (``assemble_ellipse_grid``) -> each
    found square's 4 corners are assigned to the (2r+a, 2c+b) corner
    lattice by the sign of their projection onto the cell's local
    homography axes (SquareGridTools.orderSquareCorners analog).

    Returns (corner_grid [2R, 2C, 2], corner_mask [2R, 2C]) or None;
    cells of occluded/missed squares are mask=False.  ``quads``: optional
    precomputed ``_square_quad_candidates`` output (the known-size entry
    shares one detection pass between the auto and fallback paths).
    """
    if quads is None:
        quads = _square_quad_candidates(image, min_area)
    if len(quads) < 4:
        return None
    centers = np.stack([c for _, c, _ in quads])
    sizes = np.asarray([s for _, _, s in quads])
    res = assemble_ellipse_grid(centers, sizes)
    if res is None:
        return None
    grid, mask = res
    R, C = mask.shape
    # map lattice cells back to their source quad (assemble returns
    # coordinates verbatim, so nearest-center matching is exact)
    vs, us = np.nonzero(mask)
    cell_quad = {}
    for v, u in zip(vs, us):
        d = np.linalg.norm(centers - grid[v, u], axis=1)
        if d.min() < 1e-6 + 0.25 * sizes[d.argmin()]:
            cell_quad[(v, u)] = int(d.argmin())
    if len(cell_quad) < 4:
        return None
    # local lattice axes from the cell-grid homography (u, v) -> (x, y)
    import jax.numpy as _jnp
    from boofcv_tpu.geo import epipolar as _epi
    uv = np.array([(u, v) for (v, u) in cell_quad], np.float64)
    xy = np.array([grid[v, u] for (v, u) in cell_quad])
    Hm = np.asarray(_epi.homography_dlt(_jnp.asarray(uv[None]),
                                        _jnp.asarray(xy[None])))[0]

    def h_apply(p):
        q = np.c_[p, np.ones(len(p))] @ Hm.T
        return q[:, :2] / q[:, 2:]

    out_grid = np.zeros((2 * R, 2 * C, 2))
    out_mask = np.zeros((2 * R, 2 * C), bool)
    for (v, u), qi in cell_quad.items():
        corners = quads[qi][0]
        base = h_apply(np.array([[u, v]], np.float64))[0]
        ud = h_apply(np.array([[u + 0.5, v]]))[0] - base
        vd = h_apply(np.array([[u, v + 0.5]]))[0] - base
        rel = corners - base
        su = (rel @ ud > 0).astype(int)          # 0 = -u side, 1 = +u
        sv = (rel @ vd > 0).astype(int)
        combos = set(zip(su, sv))
        if len(combos) != 4:
            continue                              # degenerate projection
        for k in range(4):
            out_grid[2 * v + sv[k], 2 * u + su[k]] = corners[k]
            out_mask[2 * v + sv[k], 2 * u + su[k]] = True
    if out_mask.sum() < 8:
        return None
    return out_grid, out_mask


def detect_square_grid(image, rows: int, cols: int, min_area: int = 20):
    """Square-grid target: ``rows x cols`` black squares; calibration
    points are all 4 corners of every square, ordered as a
    (2*rows) x (2*cols) point lattice (DetectSquareGridFiducial.java).

    Routed through the cluster-assembly path first
    (:func:`detect_square_grid_auto` — distractor quads and occluded
    cells are rejected by the lattice growth itself, which the
    size-median heuristic cannot do), accepting any proper rotation of
    the recovered lattice that matches the requested shape with every
    corner present.  The legacy most-size-consistent-subset +
    ``_order_grid`` heuristic remains as a frontal fallback.

    Returns [4*rows*cols, 2] (x, y) row-major, or None.
    """
    cand = _square_quad_candidates(image, min_area)
    res = detect_square_grid_auto(image, min_area, quads=cand)
    if res is not None:
        g = _canonical_rotation(*res, (2 * rows, 2 * cols))
        if g is not None:
            return g.reshape(-1, 2)
    want = rows * cols
    quads = [(q, s) for q, _, s in cand]
    if len(quads) < want:
        return None
    if len(quads) > want:
        # keep the most size-consistent subset (equal target squares)
        ss = np.array([s for _, s in quads])
        med = np.median(ss)
        order = np.argsort(np.abs(ss - med))
        quads = [quads[i] for i in order[:want]]
    corners = np.concatenate([q for q, _ in quads], axis=0)
    return _order_grid(corners, 2 * rows, 2 * cols)


def _circle_centers(image, want: int, min_area: int):
    """Ellipse-fit the dark blobs, keep the ``want`` most size-consistent."""
    found = []
    for contour, area in _black_blob_contours(image, min_area):
        e = shapes.fit_ellipse(contour)
        if e is None or e["a"] <= 0 or e["b"] <= 0:
            continue
        if e["b"] / e["a"] < 0.3:   # too eccentric to be a target circle
            continue
        found.append((np.asarray(e["center"], np.float64), area))
    if len(found) < want:
        return None
    if len(found) > want:
        areas = np.array([a for _, a in found])
        med = np.median(areas)
        order = np.argsort(np.abs(areas - med))
        found = [found[i] for i in order[:want]]
    return np.stack([c for c, _ in found])


def _fit_ellipses(image, min_area: int):
    """Dark-blob ellipse candidates: (centers [N, 2], sizes [N])."""
    centers, sizes = [], []
    for contour, area in _black_blob_contours(image, min_area):
        e = shapes.fit_ellipse(contour)
        if e is None or e["a"] <= 0 or e["b"] <= 0:
            continue
        if e["b"] / e["a"] < 0.25:   # too eccentric for a target circle
            continue
        centers.append(np.asarray(e["center"], np.float64))
        sizes.append(float(e["a"]))
    if not centers:
        return np.zeros((0, 2)), np.zeros((0,))
    return np.stack(centers), np.asarray(sizes)


def assemble_ellipse_grid(centers, sizes=None, k_neighbors: int = 6,
                          size_ratio: float = 1.6):
    """Cluster ellipses into a lattice by connectivity growth
    (EllipseClustersIntoRegularGrid.java / EllipseClustersIntoGrid.java
    analog, built like the chessboard's frame-propagating BFS
    ``assemble_grid_connectivity``): candidate edges = size-consistent
    k-nearest neighbors; BFS assigns integer lattice coordinates, each
    node carrying its own local (u, v) axis frame so strong perspective
    and missing (occluded) circles are tolerated — diagonal and
    skip-one links are rejected by the frame classification itself.

    Returns (grid [R, C, 2] of (x, y), mask [R, C] bool) or None.
    """
    pts = np.asarray(centers, np.float64)
    n = len(pts)
    if n < 4:
        return None
    sz = np.asarray(sizes, np.float64) if sizes is not None else None

    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(k_neighbors, n - 1)
    nbr = np.argsort(d2, axis=1)[:, :k]
    adj = [[] for _ in range(n)]
    seen = set()
    for i in range(n):
        for j in nbr[i]:
            j = int(j)
            key = (min(i, j), max(i, j))
            if key in seen:
                continue
            seen.add(key)
            if sz is not None and (
                    max(sz[i], sz[j]) > size_ratio * min(sz[i], sz[j])):
                continue
            adj[i].append(j)
            adj[j].append(i)

    seed = int(np.argmax([len(a) for a in adj]))
    if len(adj[seed]) < 2:
        return None
    dirs = [pts[j] - pts[seed] for j in adj[seed]]
    order = np.argsort([np.linalg.norm(d) for d in dirs])
    u0 = dirs[order[0]]
    v0 = None
    for o in order[1:]:
        d = dirs[o]
        cosang = abs(np.dot(u0, d)) / (np.linalg.norm(u0)
                                       * np.linalg.norm(d) + 1e-9)
        # 45-deg tilt skews the axes: accept up to ~40 deg off-normal
        if cosang < 0.75:
            v0 = d
            break
    if v0 is None:
        return None
    if u0[0] * v0[1] - u0[1] * v0[0] < 0:
        u0, v0 = v0, u0

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
            coord[j] = (ci[0] + step[0], ci[1] + step[1])
            frame[j] = (new_u, new_v)
            queue.append(j)

    if len(coord) < 4:
        return None

    # global projective refinement: a planar lattice maps to the image
    # by an exact homography, so fit (u, v) -> (x, y) over the BFS
    # assignment and re-derive every point's lattice cell by rounding
    # H^-1 (x, y) — this repairs the occasional BFS misclassification
    # under strong perspective (the reference's grid-fit step in
    # EllipseClustersIntoGrid plays the same role)
    import jax.numpy as _jnp
    from boofcv_tpu.geo import epipolar as _epi
    idxs = sorted(coord)
    uv_ass = np.array([coord[i] for i in idxs], np.float64)
    xy_ass = pts[idxs]
    assign = None
    for _ in range(3):
        Hm = np.asarray(_epi.homography_dlt(
            _jnp.asarray(uv_ass[None]), _jnp.asarray(xy_ass[None])))[0]
        Hinv = np.linalg.inv(Hm)
        ph = np.c_[pts, np.ones(n)] @ Hinv.T
        uv_all = ph[:, :2] / ph[:, 2:]
        ij_all = np.round(uv_all).astype(int)
        resid = np.linalg.norm(uv_all - ij_all, axis=1)
        keep = resid < 0.35
        # resolve cell duplicates by smallest residual
        cells = {}
        for i in np.nonzero(keep)[0]:
            c_key = (ij_all[i, 0], ij_all[i, 1])
            if c_key not in cells or resid[i] < resid[cells[c_key]]:
                cells[c_key] = int(i)
        new_assign = {i: c_key for c_key, i in cells.items()}
        if new_assign == assign:
            break
        assign = new_assign
        if len(assign) < 4:
            return None
        idxs = sorted(assign)
        uv_ass = np.array([assign[i] for i in idxs], np.float64)
        xy_ass = pts[idxs]
    if assign is None or len(assign) < 4:
        return None

    ij = np.array([assign[i] for i in sorted(assign)])
    idxs = sorted(assign)
    ij -= ij.min(axis=0)
    C, R = ij[:, 0].max() + 1, ij[:, 1].max() + 1
    if R * C > 4 * len(assign):
        return None                      # incoherent sparse lattice
    grid = np.zeros((R, C, 2))
    mask = np.zeros((R, C), bool)
    for i, (cu, cv) in zip(idxs, ij):
        grid[cv, cu] = pts[i]
        mask[cv, cu] = True

    # canonical orientation (same convention as the chessboard walker)
    def score(g, m):
        return g[0, 0] @ np.ones(2) if m[0, 0] else np.inf
    best = (grid, mask)
    best_s = score(grid, mask)
    g, m = grid, mask
    for _ in range(3):
        g = np.transpose(g[:, ::-1], (1, 0, 2))
        m = m[:, ::-1].T
        s = score(g, m)
        if s < best_s:
            best_s, best = s, (g.copy(), m.copy())
    return best


def detect_circle_regular_grid_auto(image, min_area: int = 20):
    """Regular circle grid with UNKNOWN size and occlusion tolerance:
    ellipse candidates -> connectivity lattice growth.  Returns
    (grid [R, C, 2], mask [R, C]) or None."""
    centers, sizes = _fit_ellipses(image, min_area)
    if len(centers) < 4:
        return None
    return assemble_ellipse_grid(centers, sizes)


def detect_circle_regular_grid(image, rows: int, cols: int,
                               min_area: int = 20):
    """Regular (square-lattice) circle grid: returns the ``rows*cols``
    circle centers as [rows*cols, 2] (x, y) row-major, or None.

    (The reference additionally derives 4 tangent keypoints per circle to
    cancel perspective bias of the center — centers are the lattice used
    for grid ordering there too, KeyPointsCircleRegularGrid.java.)
    """
    # connectivity lattice growth first (oblique-robust); homography
    # cell-rounding _order_grid as the frontal fallback.  Orientation
    # candidates are PROPER rotations of the index lattice (np.rot90) —
    # a bare transpose is a reflection and would hand Zhang99 a
    # mirror-handed world<->image correspondence.
    res = detect_circle_regular_grid_auto(image, min_area)
    if res is not None:
        g = _canonical_rotation(*res, (rows, cols))
        if g is not None:
            return g.reshape(-1, 2)
    centers = _circle_centers(image, rows * cols, min_area)
    if centers is None:
        return None
    return _order_grid(centers, rows, cols)


def detect_circle_hexagonal_grid_auto(image, min_area: int = 10):
    """Hexagonal circle grid with UNKNOWN size + occlusion tolerance
    (EllipseClustersIntoHexagonalGrid analog).

    The hex lattice's nearest-neighbor graph IS a square lattice in the
    two diagonal directions: circle (i, j) [i+j even] maps to diagonal
    coords a=(i+j)/2, b=(i-j)/2, so the SAME frame-propagating BFS
    recovers (a, b) and the hex indices come back as i=a+b, j=a-b.

    Returns {"rows", "cols", "points": [(i, j, x, y), ...]} with hex
    indices satisfying (i + j) even, or None.
    """
    centers, sizes = _fit_ellipses(image, min_area)
    if len(centers) < 4:
        return None
    res = assemble_ellipse_grid(centers, sizes, k_neighbors=6)
    if res is None:
        return None
    grid, mask = res
    vs, us = np.nonzero(mask)
    i_h = us + vs
    j_h = us - vs
    # normalize to >= 0 with a PARITY-PRESERVING shift: independent mins
    # can make every (i + j) odd, violating the documented hex
    # convention (all points share one sum-parity, so a single +1 on j
    # restores it)
    i_h -= i_h.min()
    j_h -= j_h.min()
    if ((i_h + j_h) % 2 != 0).any():
        j_h = j_h + 1
    pts = [(int(i), int(j), float(grid[v, u, 0]), float(grid[v, u, 1]))
           for i, j, v, u in zip(i_h, j_h, vs, us)]
    pts.sort()
    return {"rows": int(i_h.max()) + 1, "cols": int(j_h.max()) + 1,
            "points": pts}


def detect_circle_hexagonal_grid(image, rows: int, cols: int,
                                 min_area: int = 10):
    """Hexagonal circle grid (EllipseClustersIntoHexagonalGrid analog).

    ``rows`` x ``cols`` counts every hex row/column (odd rows hold
    ceil(cols/2) circles, even rows floor(cols/2), as the reference's
    convention: circle (i, j) exists when i+j is even).  Returns
    [num_circles, 2] centers ordered row-major by (row, col), or None.

    Grid ordering: the hexagonal lattice is not projectively a square
    lattice, so homography cell-rounding does not apply; instead the
    dominant axes are estimated from the centers' principal directions,
    rows are clustered along the minor axis, and each row is sorted along
    the major axis — robust to moderate perspective like the reference's
    cluster-into-grid step.
    """
    num = sum((cols + 1) // 2 if r % 2 == 0 else cols // 2
              for r in range(rows))
    # connectivity lattice growth first (oblique-robust).  Orientation
    # candidates are PROPER 90-degree rotations of the hex index lattice
    # ((i, j) -> (j, -i), min-normalized) — an index swap is a
    # reflection and would mirror the world<->image correspondence.  A
    # rotation that breaks the (i + j) even convention (possible when a
    # grid dimension is even) cannot match the requested pattern and is
    # skipped.
    auto = detect_circle_hexagonal_grid_auto(image, min_area)
    if auto is not None and len(auto["points"]) == num:
        ij0 = np.array([(i, j) for i, j, _, _ in auto["points"]])
        xy = np.array([(x, y) for _, _, x, y in auto["points"]])
        # among the shape- and parity-preserving rotations, pick the one
        # whose FIRST ordered point has the smallest x+y — the same
        # deterministic-orientation rule as _canonical_rotation (taking
        # the first match flipped per-view orderings 180 degrees)
        best = None
        for k in range(4):
            p = ij0.copy()
            for _ in range(k):
                p = np.stack([p[:, 1], -p[:, 0]], 1)
            p = p - p.min(axis=0)
            if ((p.sum(1) % 2) != 0).any():
                continue
            if (int(p[:, 0].max()) + 1, int(p[:, 1].max()) + 1) \
                    != (rows, cols):
                continue
            order = np.lexsort((p[:, 1], p[:, 0]))
            s = float(xy[order][0].sum())
            if best is None or s < best[0]:
                best = (s, xy[order])
        if best is not None:
            return best[1]
    pts = _circle_centers(image, num, min_area)
    if pts is None:
        return None

    # principal axes of the center cloud: rows separate along the axis
    # with the SMALLER spacing-variation
    c = pts.mean(0)
    centered = pts - c
    _, _, Vt = np.linalg.svd(centered, full_matrices=False)
    major, minor = Vt[0], Vt[1]
    # SVD axis signs are arbitrary and INDEPENDENT — fixing them
    # independently can order a legitimate view as a REFLECTION of the
    # true lattice.  Enforce a right-handed (major, minor) frame so only
    # the 180-degree rotation remains ambiguous (resolved below).
    if major[0] * minor[1] - major[1] * minor[0] < 0:
        minor = -minor
    tm = centered @ minor     # coordinate across rows
    tj = centered @ major     # coordinate along rows
    # cluster rows: sort by tm, split where the gap exceeds half the
    # median large-gap (hex row spacing is uniform)
    order = np.argsort(tm)
    tm_s = tm[order]
    gaps = np.diff(tm_s)
    if len(gaps) == 0:
        return None
    row_gap = np.median(gaps[gaps > np.max(gaps) * 0.5]) if np.any(
        gaps > np.max(gaps) * 0.5) else np.max(gaps)
    breaks = np.nonzero(gaps > 0.5 * row_gap)[0]
    row_ids = np.zeros(num, dtype=int)
    rid = 0
    prev = -1
    for b in breaks:
        row_ids[order[prev + 1:b + 1]] = rid
        rid += 1
        prev = b
    row_ids[order[prev + 1:]] = rid
    n_rows = rid + 1
    if n_rows != rows:
        return None
    out = []
    for r in range(rows):
        sel = pts[row_ids == r]
        sel = sel[np.argsort((sel - c) @ major)]
        out.append(sel)
    expected = [(cols + 1) // 2 if r % 2 == 0 else cols // 2
                for r in range(rows)]
    # candidates: as-built, and its 180-degree rotation (rows AND
    # within-row order reversed — a PROPER rotation; the old code
    # accepted expected[::-1] without reordering, returning a
    # view-dependent — sometimes exactly reversed — correspondence)
    flip = [o[::-1] for o in out[::-1]]
    cands = [cand for cand in (out, flip)
             if [len(o) for o in cand] == expected]
    if not cands:
        return None
    return min((np.concatenate(cand, axis=0) for cand in cands),
               key=lambda a: float(a[0].sum()))
