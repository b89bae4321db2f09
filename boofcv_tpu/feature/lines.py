"""Line detection: Hough transforms.

Reference analog: boofcv-feature alg/feature/detect/line/ —
HoughTransformBinary.java / HoughTransformGradient.java with polar
(HoughParametersPolar) and foot-of-norm parameterizations,
GridRansacLineDetector.

Design: the accumulator is a scatter-add over all edge pixels at
once ([N_pixels] -> [n_theta, n_rho] bincount); peaks via the standard
nonmax + top-k.  The gradient variant votes only along each pixel's
gradient direction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from boofcv_tpu.feature import extract
from boofcv_tpu.ip import derivative


class HoughLines(NamedTuple):
    rho: jnp.ndarray      # [K] signed distance from center
    theta: jnp.ndarray    # [K] normal angle
    score: jnp.ndarray    # [K]
    valid: jnp.ndarray


def hough_binary(binary, n_theta: int = 180, n_rho: int = 181,
                 max_lines: int = 10, peak_radius: int = 2,
                 threshold_frac: float = 0.3) -> HoughLines:
    """Polar Hough over a binary edge image (HoughTransformBinary).

    rho is measured from the image center (as the reference does).
    """
    bw = jnp.asarray(binary) > 0
    h, w = bw.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    thetas = jnp.linspace(0.0, np.pi, n_theta, endpoint=False)
    max_r = float(np.hypot(max(cy, h - 1 - cy), max(cx, w - 1 - cx)))
    # rho index for every (pixel, theta)
    x0 = (xs - cx).ravel()
    y0 = (ys - cy).ravel()
    mask = bw.ravel()
    rho = (x0[:, None] * jnp.cos(thetas)[None, :]
           + y0[:, None] * jnp.sin(thetas)[None, :])     # [P, T]
    ri = jnp.clip(jnp.round((rho / max_r + 1.0) * 0.5 * (n_rho - 1)),
                  0, n_rho - 1).astype(jnp.int32)
    t_idx = jnp.broadcast_to(jnp.arange(n_theta)[None, :], ri.shape)
    flat = t_idx * n_rho + ri
    votes = jnp.broadcast_to(mask[:, None], ri.shape).astype(jnp.float32)
    acc = jnp.zeros((n_theta * n_rho,), jnp.float32).at[flat.ravel()].add(
        votes.ravel()).reshape(n_theta, n_rho)
    return _extract_lines(acc, thetas, max_r, n_rho, max_lines,
                          peak_radius, threshold_frac)


def hough_gradient(image, n_theta: int = 180, n_rho: int = 181,
                   max_lines: int = 10, peak_radius: int = 2,
                   edge_threshold: float = 20.0,
                   threshold_frac: float = 0.3) -> HoughLines:
    """Gradient-direction Hough (HoughTransformGradient): each edge pixel
    votes once, at the angle of its gradient."""
    img = jnp.asarray(image, jnp.float32)
    dx, dy = derivative.sobel(img)
    mag = jnp.hypot(dx, dy)
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    theta = jnp.arctan2(dy, dx) % np.pi                      # normal angle
    max_r = float(np.hypot(max(cy, h - 1 - cy), max(cx, w - 1 - cx)))
    rho = (xs - cx) * jnp.cos(theta) + (ys - cy) * jnp.sin(theta)
    ti = jnp.clip((theta / np.pi * n_theta).astype(jnp.int32), 0, n_theta - 1)
    ri = jnp.clip(jnp.round((rho / max_r + 1.0) * 0.5 * (n_rho - 1)),
                  0, n_rho - 1).astype(jnp.int32)
    votes = (mag > edge_threshold).astype(jnp.float32)
    acc = jnp.zeros((n_theta * n_rho,), jnp.float32).at[
        (ti * n_rho + ri).ravel()].add(votes.ravel()).reshape(n_theta, n_rho)
    thetas = jnp.linspace(0.0, np.pi, n_theta, endpoint=False)
    return _extract_lines(acc, thetas, max_r, n_rho, max_lines,
                          peak_radius, threshold_frac)


def _extract_lines(acc, thetas, max_r, n_rho, max_lines, peak_radius,
                   threshold_frac):
    thr = threshold_frac * jnp.max(acc)
    det = extract.detect(acc, max_features=max_lines, radius=peak_radius,
                         threshold=thr)
    t = thetas[jnp.clip(det.ys, 0, thetas.shape[0] - 1)]
    r = (det.xs.astype(jnp.float32) / (n_rho - 1) * 2.0 - 1.0) * max_r
    return HoughLines(r, t, det.scores, det.valid)


def line_pixels(rho, theta, shape_hw, thickness: float = 1.0):
    """Boolean mask of the line for visualization/tests."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = np.abs((xs - cx) * np.cos(theta) + (ys - cy) * np.sin(theta) - rho)
    return d <= thickness


class GridLineSegments(NamedTuple):
    """Fixed-capacity per-region line segments (MatrixOfList analog)."""
    x0: jnp.ndarray      # [R, L]
    y0: jnp.ndarray
    x1: jnp.ndarray
    y1: jnp.ndarray
    inliers: jnp.ndarray  # [R, L] inlier counts
    valid: jnp.ndarray    # [R, L] bool


def grid_ransac_lines(image, region_size: int = 32,
                      edge_threshold: float = 30.0,
                      max_lines_per_region: int = 2,
                      edgels_per_region: int = 48,
                      hypotheses: int = 64,
                      inlier_tol: float = 1.0,
                      min_inliers: int = 6,
                      angle_tol: float = 0.35,
                      key=None) -> GridLineSegments:
    """Grid-RANSAC line-segment detector (GridRansacLineDetector.java:
    Clarke-Carlsson-Zisserman edgel grouping).

    The image is tiled into ``region_size`` squares; each region's top-K
    gradient edgels feed a RANSAC 2-point line search whose inlier test
    combines point-line distance with gradient-orthogonality (the
    reference's Edgel pruning).  The find-remove-repeat loop runs
    ``max_lines_per_region`` rounds.  ALL regions run as one vmapped
    batch — there is no per-region host loop.
    """
    import jax
    from jax import lax

    if key is None:
        key = jax.random.PRNGKey(0)
    img = jnp.asarray(image, jnp.float32)
    from boofcv_tpu.ip.derivative import sobel
    dx, dy = sobel(img)
    mag = jnp.abs(dx) + jnp.abs(dy)
    h, w = img.shape
    rs = region_size
    nry, nrx = h // rs, w // rs
    nreg = nry * nrx
    K = edgels_per_region

    def crop(a):
        return (a[: nry * rs, : nrx * rs]
                .reshape(nry, rs, nrx, rs).transpose(0, 2, 1, 3)
                .reshape(nreg, rs * rs))

    mag_r = crop(mag)
    dx_r = crop(dx)
    dy_r = crop(dy)
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    ys_r = crop(yy)
    xs_r = crop(xx)

    # top-K edgels per region
    score = jnp.where(mag_r > edge_threshold, mag_r, -1.0)
    top, idx = lax.top_k(score, K)                       # [R, K]
    emask = top > 0
    take = lambda a: jnp.take_along_axis(a, idx, axis=1)
    ex = take(xs_r)
    ey = take(ys_r)
    gx = take(dx_r)
    gy = take(dy_r)
    gn = jnp.sqrt(gx * gx + gy * gy)
    gn = jnp.where(gn < 1e-9, 1.0, gn)
    gx = gx / gn
    gy = gy / gn

    pair_idx = jax.random.randint(key, (nreg, hypotheses, 2), 0, K)

    def region_lines(ex, ey, gx, gy, emask, pairs):
        def find_one(carry, _):
            active = carry
            xa = ex[pairs[:, 0]]
            ya = ey[pairs[:, 0]]
            xb = ex[pairs[:, 1]]
            yb = ey[pairs[:, 1]]
            dxl = xb - xa
            dyl = yb - ya
            ln = jnp.sqrt(dxl * dxl + dyl * dyl)
            ok_h = (ln > 1.0) & active[pairs[:, 0]] & active[pairs[:, 1]]
            ln = jnp.where(ln < 1e-9, 1.0, ln)
            ux = dxl / ln
            uy = dyl / ln
            # distance of every edgel to every hypothesis line [H, K]
            relx = ex[None, :] - xa[:, None]
            rely = ey[None, :] - ya[:, None]
            dist = jnp.abs(relx * uy[:, None] - rely * ux[:, None])
            # gradient must be orthogonal to the line direction
            gdot = jnp.abs(gx[None, :] * ux[:, None]
                           + gy[None, :] * uy[:, None])
            is_in = ((dist <= inlier_tol) & (gdot <= angle_tol)
                     & active[None, :] & ok_h[:, None])
            counts = jnp.sum(is_in, axis=1)
            best = jnp.argmax(counts)
            inl = is_in[best]
            n_in = counts[best]
            # total-least-squares refit on inliers (centroid + PCA dir)
            wgt = inl.astype(jnp.float32)
            s = jnp.maximum(jnp.sum(wgt), 1.0)
            mx = jnp.sum(ex * wgt) / s
            my = jnp.sum(ey * wgt) / s
            cxx = jnp.sum(wgt * (ex - mx) ** 2)
            cxy = jnp.sum(wgt * (ex - mx) * (ey - my))
            cyy = jnp.sum(wgt * (ey - my) ** 2)
            ang = 0.5 * jnp.arctan2(2 * cxy, cxx - cyy)
            ux_b = jnp.cos(ang)
            uy_b = jnp.sin(ang)
            # segment endpoints: extremes of inlier projections
            proj = (ex - mx) * ux_b + (ey - my) * uy_b
            pmin = jnp.min(jnp.where(inl, proj, jnp.inf))
            pmax = jnp.max(jnp.where(inl, proj, -jnp.inf))
            good = n_in >= min_inliers
            pmin = jnp.where(good, pmin, 0.0)
            pmax = jnp.where(good, pmax, 0.0)
            seg = (mx + pmin * ux_b, my + pmin * uy_b,
                   mx + pmax * ux_b, my + pmax * uy_b,
                   n_in, good)
            active = active & ~(inl & good)
            return active, seg

        active0 = emask
        _, segs = lax.scan(find_one, active0, None,
                           length=max_lines_per_region)
        return segs

    segs = jax.vmap(region_lines)(ex, ey, gx, gy, emask, pair_idx)
    return GridLineSegments(*segs)


class FootLines(NamedTuple):
    """Foot-of-norm parameterized lines: the closest point of each line
    to the image center IS the parameter (LineParametric via foot)."""
    fx: jnp.ndarray      # [K] foot x (absolute pixels)
    fy: jnp.ndarray      # [K]
    score: jnp.ndarray
    valid: jnp.ndarray


def hough_foot(image, max_lines: int = 10, min_distance: int = 5,
               edge_threshold: float = 30.0, peak_radius: int = 2,
               threshold_frac: float = 0.3) -> FootLines:
    """Gradient Hough with the foot-of-norm parameterization
    (HoughTransformGradient + HoughParametersFootOfNorm): every edge
    pixel votes for the foot of the perpendicular dropped from the image
    center onto the line through that pixel with normal = gradient.

    The accumulator is image-shaped; votes are one scatter-add.
    """
    from boofcv_tpu.ip.derivative import sobel
    img = jnp.asarray(image, jnp.float32)
    h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dx, dy = sobel(img)
    mag = jnp.abs(dx) + jnp.abs(dy)
    sel = mag > edge_threshold
    gn = jnp.sqrt(dx * dx + dy * dy)
    gn = jnp.where(gn < 1e-9, 1.0, gn)
    ux = dx / gn
    uy = dy / gn
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    d = (xs - cx) * ux + (ys - cy) * uy          # signed normal distance
    fx = cx + d * ux
    fy = cy + d * uy
    # reject feet too close to the center (direction is ill-defined there,
    # as the reference's minDistanceFromOrigin does)
    sel &= d * d > float(min_distance) ** 2
    fxi = jnp.clip(jnp.round(fx), 0, w - 1).astype(jnp.int32)
    fyi = jnp.clip(jnp.round(fy), 0, h - 1).astype(jnp.int32)
    flat = jnp.where(sel, fyi * w + fxi, 0)
    votes = jnp.zeros((h * w,), jnp.float32).at[flat.ravel()].add(
        sel.ravel().astype(jnp.float32))
    votes = votes.at[0].set(0.0)
    acc = votes.reshape(h, w)
    det = extract.detect(acc, max_features=max_lines, radius=peak_radius,
                         threshold=threshold_frac * float(jnp.max(acc)),
                         border=0)
    return FootLines(det.xs.astype(jnp.float32), det.ys.astype(jnp.float32),
                     det.scores, det.valid)


def foot_to_polar(foot: FootLines, shape_hw):
    """Foot point -> (rho, theta) about the image center (interop with
    the polar representation used by hough_binary/hough_gradient)."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dx = foot.fx - cx
    dy = foot.fy - cy
    rho = jnp.sqrt(dx * dx + dy * dy)
    theta = jnp.arctan2(dy, dx)
    return rho, theta


class LineSegments(NamedTuple):
    """Flat (region-free) line segments."""
    x0: np.ndarray
    y0: np.ndarray
    x1: np.ndarray
    y1: np.ndarray
    inliers: np.ndarray


def connect_segments(segs: GridLineSegments,
                     angle_tol: float = 0.12,
                     dist_tol: float = 2.0,
                     gap_tol: float = 8.0) -> LineSegments:
    """Merge collinear segment fragments across grid regions
    (ConnectLinesGrid.java:59 — the reference walks neighboring grid
    cells connecting segments whose angle/endpoint distances are within
    tolerance; ``grid_ransac_lines`` returns per-region fragments, so a
    long line crossing 5 regions comes back as 5 pieces).

    Host-side finisher on the tiny segment list (<= R*L entries):
    pairwise compatibility is one vectorized [M, M] test — angle within
    ``angle_tol`` (mod pi), each midpoint within ``dist_tol`` of the
    other's infinite line, and projection intervals separated by less
    than ``gap_tol`` — followed by union-find over compatible pairs and
    one total-least-squares refit per group (endpoints weighted by
    inlier counts), spanning the group's extreme projections.
    """
    v = np.asarray(segs.valid).ravel()
    x0 = np.asarray(segs.x0).ravel()[v]
    y0 = np.asarray(segs.y0).ravel()[v]
    x1 = np.asarray(segs.x1).ravel()[v]
    y1 = np.asarray(segs.y1).ravel()[v]
    w = np.asarray(segs.inliers).ravel()[v].astype(np.float64)
    M = len(x0)
    if M == 0:
        return LineSegments(*[np.zeros(0)] * 4, np.zeros(0, np.int32))
    ang = np.arctan2(y1 - y0, x1 - x0) % np.pi
    mx = 0.5 * (x0 + x1)
    my = 0.5 * (y0 + y1)
    ux = np.cos(ang)
    uy = np.sin(ang)
    dang = np.abs(ang[:, None] - ang[None, :])
    dang = np.minimum(dang, np.pi - dang)
    # midpoint j to infinite line i (and symmetrically)
    relx = mx[None, :] - mx[:, None]
    rely = my[None, :] - my[:, None]
    perp = np.abs(relx * uy[:, None] - rely * ux[:, None])
    perp = np.maximum(perp, perp.T)
    # gap along line i between the two projection intervals
    def proj(i_ux, i_uy, ox, oy):
        return ox * i_ux + oy * i_uy
    p0 = proj(ux[:, None], uy[:, None], x0[None, :] - mx[:, None],
              y0[None, :] - my[:, None])
    p1 = proj(ux[:, None], uy[:, None], x1[None, :] - mx[:, None],
              y1[None, :] - my[:, None])
    lo = np.minimum(p0, p1)
    hi = np.maximum(p0, p1)
    own_lo = np.diag(lo).copy()
    own_hi = np.diag(hi).copy()
    gap = np.maximum(lo - own_hi[:, None], own_lo[:, None] - hi)
    compat = (dang <= angle_tol) & (perp <= dist_tol) & (gap <= gap_tol)
    from boofcv_tpu.utils.unionfind import UnionFind
    uf = UnionFind(M)
    for i, j in zip(*np.nonzero(np.triu(compat, 1))):
        uf.union(i, j)
    root = uf.roots()
    out = []
    for r in np.unique(root):
        sel = root == r
        px = np.concatenate([x0[sel], x1[sel]])
        py = np.concatenate([y0[sel], y1[sel]])
        pw = np.concatenate([w[sel], w[sel]])
        s = pw.sum()
        cx_, cy_ = (px * pw).sum() / s, (py * pw).sum() / s
        cxx = (pw * (px - cx_) ** 2).sum()
        cxy = (pw * (px - cx_) * (py - cy_)).sum()
        cyy = (pw * (py - cy_) ** 2).sum()
        a = 0.5 * np.arctan2(2 * cxy, cxx - cyy)
        dx_, dy_ = np.cos(a), np.sin(a)
        t = (px - cx_) * dx_ + (py - cy_) * dy_
        out.append((cx_ + t.min() * dx_, cy_ + t.min() * dy_,
                    cx_ + t.max() * dx_, cy_ + t.max() * dy_,
                    int(w[sel].sum())))
    ox0, oy0, ox1, oy1, oin = map(np.asarray, zip(*out))
    return LineSegments(ox0, oy0, ox1, oy1, oin.astype(np.int32))


def prune_merge_similar(lines: HoughLines, rho_tol: float = 6.0,
                        theta_tol: float = 0.12,
                        merge: bool = True) -> HoughLines:
    """Prune/merge near-duplicate polar Hough lines
    (ImageLinePruneMerge.java:35's pruneSimilar): sort by score, keep
    each line unless a stronger kept line lies within (rho_tol,
    theta_tol) — with theta wrapped mod pi and rho's sign flipped across
    the wrap.  ``merge=True`` replaces each kept line with the
    score-weighted mean of its absorbed duplicates.

    Host-side finisher on the tiny line list; returns a HoughLines of
    the same capacity with pruned slots masked out of ``valid``.
    """
    rho = np.array(lines.rho, np.float64)
    theta = np.array(lines.theta, np.float64)
    score = np.array(lines.score, np.float64)
    valid = np.array(lines.valid)
    idx = np.argsort(-np.where(valid, score, -np.inf))
    kept = []          # indices of keepers
    absorbed = {}
    for i in idx:
        if not valid[i]:
            continue
        matched = None
        for k in kept:
            dth = abs(theta[i] - theta[k])
            wrap = dth > np.pi / 2
            dth = min(dth, np.pi - dth)
            drho = abs((-rho[i] if wrap else rho[i]) - rho[k])
            if dth <= theta_tol and drho <= rho_tol:
                matched = k
                break
        if matched is None:
            kept.append(i)
            absorbed[i] = [i]
        else:
            absorbed[matched].append(i)
            valid[i] = False
    if merge:
        for k in kept:
            grp = absorbed[k]
            wgt = score[grp]
            th_k = theta[k]
            # average in a frame where duplicates across the pi wrap
            # align with the keeper
            ths, rhs = [], []
            for g in grp:
                dth = theta[g] - th_k
                if dth > np.pi / 2:
                    ths.append(theta[g] - np.pi)
                    rhs.append(-rho[g])
                elif dth < -np.pi / 2:
                    ths.append(theta[g] + np.pi)
                    rhs.append(-rho[g])
                else:
                    ths.append(theta[g])
                    rhs.append(rho[g])
            s = wgt.sum()
            th_w = float(np.dot(ths, wgt) / s)
            rho_k = float(np.dot(rhs, wgt) / s)
            # fold the weighted mean back into [0, pi) — a +-pi shift of
            # theta flips the signed distance's sign
            if th_w < 0.0:
                th_w += np.pi
                rho_k = -rho_k
            elif th_w >= np.pi:
                th_w -= np.pi
                rho_k = -rho_k
            theta[k] = th_w
            rho[k] = rho_k
            score[k] = s
    return HoughLines(jnp.asarray(rho), jnp.asarray(theta),
                      jnp.asarray(score), jnp.asarray(valid))
