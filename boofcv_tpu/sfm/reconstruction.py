"""Multi-view metric reconstruction (SfM).

Reference analog: boofcv-sfm alg/sfm/structure/ —
PairwiseImageMatching.java:49,169 (all-pairs detect/describe/associate +
robust F/E -> graph), PairwiseImageGraph.java,
EstimateSceneCalibrated.java:65,111 (seed selection, essential decompose
:175, incremental growth with PnP + triangulate-as-you-grow :296-580),
ThreeViewEstimateMetricScene.java.

Device/host split (SURVEY §3.5): detect/describe/associate/RANSAC/triangulation/BA
run batched on device; graph bookkeeping (track tables, which image joins
next) is host-side Python exactly like the reference's graph logic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.ip import integral as ii_ops
from boofcv_tpu.feature import fasthessian, describe, associate
from boofcv_tpu.geo import robust, epipolar, triangulate, pnp, se3, ba


@dataclass
class ImageFeatures:
    ys: np.ndarray
    xs: np.ndarray
    scales: np.ndarray
    desc: np.ndarray      # [N, 64]
    valid: np.ndarray


def detect_describe(image, max_features: int = 300) -> ImageFeatures:
    """SURF detect+describe (WrapDetectDescribeSurf analog)."""
    img = jnp.asarray(image, jnp.float32)
    ii = ii_ops.transform(img)
    det = fasthessian.detect_multi_octave(ii, max_features_per_octave=max_features // 2)
    angles = describe.orientation_average_haar(ii, det.ys, det.xs, det.scales)
    desc = describe.surf(ii, det.ys, det.xs, det.scales, angles)
    return ImageFeatures(np.asarray(det.ys), np.asarray(det.xs),
                         np.asarray(det.scales), np.asarray(desc),
                         np.asarray(det.valid))


def match_features(fa: ImageFeatures, fb: ImageFeatures,
                   max_error: float = 0.35):
    """Mutual-NN association on the [N, M] score matrix (one matmul)."""
    scores = associate.score_euclidean_sq(jnp.asarray(fa.desc),
                                          jnp.asarray(fb.desc))
    big = 1e12
    scores = jnp.where(jnp.asarray(fa.valid)[:, None], scores, big)
    scores = jnp.where(jnp.asarray(fb.valid)[None, :], scores, big)
    m = associate.associate_mutual(scores, max_error=max_error ** 2)
    src = np.asarray(m.src)
    dst = np.asarray(m.dst)
    ok = np.asarray(m.valid)
    return src[ok], dst[ok]


@dataclass
class PairwiseEdge:
    view_a: int
    view_b: int
    matches_a: np.ndarray     # feature indices in view a
    matches_b: np.ndarray
    inliers: np.ndarray       # bool over matches
    R: np.ndarray             # relative pose: x_b = R x_a + t (unit t)
    t: np.ndarray
    score: int


@dataclass
class PairwiseGraph:
    features: List[ImageFeatures]
    edges: Dict[Tuple[int, int], PairwiseEdge] = field(default_factory=dict)


def build_pairwise_graph(images, K, max_features: int = 300,
                         min_inliers: int = 20, seed: int = 0,
                         detect=None) -> PairwiseGraph:
    """All-pairs matching + robust essential (PairwiseImageMatching.process).

    ``detect``: optional override returning ImageFeatures (for tests)."""
    detect = detect or (lambda im: detect_describe(im, max_features))
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    feats = [detect(im) for im in images]
    graph = PairwiseGraph(feats)
    key = jax.random.PRNGKey(seed)
    n = len(images)
    for a in range(n):
        for b in range(a + 1, n):
            src, dst = match_features(feats[a], feats[b])
            if src.size < 16:
                continue
            pa = np.stack([feats[a].xs[src], feats[a].ys[src]], 1)
            pb = np.stack([feats[b].xs[dst], feats[b].ys[dst]], 1)
            na = (np.concatenate([pa, np.ones((len(pa), 1))], 1) @ Kinv.T)[:, :2]
            nb = (np.concatenate([pb, np.ones((len(pb), 1))], 1) @ Kinv.T)[:, :2]
            key, sub = jax.random.split(key)
            res = robust.ransac_essential(sub, jnp.asarray(na), jnp.asarray(nb),
                                          num_hypotheses=256,
                                          inlier_threshold=2e-5)
            inl = np.asarray(res.inliers)
            if inl.sum() < min_inliers:
                continue
            E = np.asarray(res.model)
            R4, t4 = epipolar.decompose_essential(jnp.asarray(E))
            R, t, _ = epipolar.select_pose_cheirality(
                R4, t4, jnp.asarray(na[inl]), jnp.asarray(nb[inl]))
            graph.edges[(a, b)] = PairwiseEdge(
                a, b, src, dst, inl, np.asarray(R), np.asarray(t),
                int(inl.sum()))
    return graph


@jax.jit
def _tri2_jit(na, nb, R, t):
    return triangulate.triangulate_two_view_linear(na, nb, R, t)


def _tri2_padded(na, nb, R, t):
    """Two-view triangulation through a jitted kernel with power-of-two
    padding: O(log N) distinct compiles instead of one eager op chain
    per call (the growth loop triangulates per edge per step)."""
    n = len(na)
    cap = 1 << int(np.ceil(np.log2(max(n, 8))))
    na_p = np.zeros((cap, 2))
    nb_p = np.zeros((cap, 2))
    na_p[:n] = na
    nb_p[:n] = nb
    na_p[n:] = [0.1, 0.1]        # benign dummies (any finite rays)
    nb_p[n:] = [0.12, 0.1]
    X = _tri2_jit(jnp.asarray(na_p), jnp.asarray(nb_p), jnp.asarray(R),
                  jnp.asarray(t))
    return np.asarray(X)[:n]


def reconstruct_incremental(graph: PairwiseGraph, K, ba_iterations: int = 15,
                            seed: int = 1):
    """Incremental metric growth + final BA (EstimateSceneCalibrated).

    Returns dict with per-view (R, t), world points, and the BAProblem.
    """
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    if not graph.edges:
        raise ValueError("empty pairwise graph")

    def norm_coords(view, idxs):
        f = graph.features[view]
        p = np.stack([f.xs[idxs], f.ys[idxs], np.ones(len(idxs))], 1)
        return (p @ Kinv.T)[:, :2]

    # --- seed: best edge (defineCoordinateSystem :671)
    seed_edge = max(graph.edges.values(), key=lambda e: e.score)
    a, b = seed_edge.view_a, seed_edge.view_b
    poses = {a: (np.eye(3), np.zeros(3)),
             b: (seed_edge.R, seed_edge.t)}  # world = camera a

    # track table: (view, feature_idx) -> point id
    obs_of_point: List[List[Tuple[int, int, np.ndarray]]] = []
    point_xyz: List[np.ndarray] = []
    feat_to_point: Dict[Tuple[int, int], int] = {}

    ia = seed_edge.matches_a[seed_edge.inliers]
    ib = seed_edge.matches_b[seed_edge.inliers]
    na = norm_coords(a, ia)
    nb = norm_coords(b, ib)
    X = _tri2_padded(na, nb, seed_edge.R, seed_edge.t)
    good = X[:, 2] > 0
    for i in range(len(X)):
        if not good[i]:
            continue
        pid = len(point_xyz)
        point_xyz.append(X[i])
        obs_of_point.append([(a, ia[i], na[i]), (b, ib[i], nb[i])])
        feat_to_point[(a, ia[i])] = pid
        feat_to_point[(b, ib[i])] = pid

    # --- grow (estimateAllFeatures :402)
    # Bookkeeping is ARRAY-based so 50+ view graphs stay fast: per-view
    # int arrays feature -> point id (-1 = unmapped) replace the former
    # per-observation dict scans (which were O(views x edges x matches)
    # Python work per growth step), and the 2D-3D RANSAC pads its inputs
    # to power-of-two buckets so XLA compiles O(log N) programs, not one
    # per view.
    point_of_feat = [np.full(len(f.xs), -1, np.int64)
                     for f in graph.features]
    for (v, fi), pid in feat_to_point.items():
        point_of_feat[v][fi] = pid
    edges_by_view: Dict[int, list] = {}
    for (x, y), e in graph.edges.items():
        edges_by_view.setdefault(x, []).append((x, y, e))
        edges_by_view.setdefault(y, []).append((x, y, e))

    def correspondences(v):
        """All (point id, own feature idx) links from registered views."""
        pid_list, own_list = [], []
        for x, y, e in edges_by_view.get(v, ()):
            if x == v and y in poses:
                known, own = e.matches_b[e.inliers], e.matches_a[e.inliers]
                kv = y
            elif y == v and x in poses:
                known, own = e.matches_a[e.inliers], e.matches_b[e.inliers]
                kv = x
            else:
                continue
            pids = point_of_feat[kv][known]
            has = pids >= 0
            pid_list.append(pids[has])
            own_list.append(own[has])
        if not pid_list:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(pid_list), np.concatenate(own_list)

    key = jax.random.PRNGKey(seed)
    remaining = set(range(len(graph.features))) - set(poses)
    while remaining:
        best_view, best_pairs = None, (np.zeros(0, np.int64),) * 2
        for v in remaining:
            pids, own = correspondences(v)
            if len(pids) > len(best_pairs[0]):
                best_view, best_pairs = v, (pids, own)
        pids, fidx = best_pairs
        if best_view is None or len(pids) < 6:
            break  # disconnected remainder
        world = np.stack([point_xyz[p] for p in pids])
        obs = norm_coords(best_view, fidx)
        key, sub = jax.random.split(key)
        # pad to the next power-of-two bucket (few distinct compiles)
        n_obs = len(pids)
        cap = 1 << int(np.ceil(np.log2(max(n_obs, 8))))
        world_p = np.zeros((cap, 3))
        world_p[:n_obs] = world
        obs_p = np.zeros((cap, 2))
        obs_p[:n_obs] = obs
        mask = np.zeros(cap, bool)
        mask[:n_obs] = True
        res, (R, t) = robust.ransac_pnp(sub, jnp.asarray(world_p),
                                        jnp.asarray(obs_p),
                                        num_hypotheses=256,
                                        inlier_threshold=2e-5,
                                        valid_mask=jnp.asarray(mask))
        R, t = np.asarray(R), np.asarray(t)
        poses[best_view] = (R, t)
        remaining.discard(best_view)
        # register this view's observations of existing points.  The
        # same point id can arrive through several edges (one per
        # already-registered neighbor): keep ONE observation per
        # (point, view), else the final BA double-counts that residual
        seen_pid = set()
        inl = np.asarray(res.inliers)[:n_obs]
        for i in np.nonzero(inl)[0]:
            if pids[i] in seen_pid:
                continue
            seen_pid.add(pids[i])
            obs_of_point[pids[i]].append((best_view, fidx[i], obs[i]))
        point_of_feat[best_view][fidx[inl]] = pids[inl]
        # triangulate brand-new tracks with already-registered views
        for x, y, e in edges_by_view.get(best_view, ()):
            if x in poses and y in poses:
                Rx, tx = poses[x]
                Ry, ty = poses[y]
                # relative pose x->y
                Rrel = Ry @ Rx.T
                trel = ty - Rrel @ tx
                ia_all = e.matches_a[e.inliers]
                ib_all = e.matches_b[e.inliers]
                fresh = (point_of_feat[x][ia_all] < 0) \
                    & (point_of_feat[y][ib_all] < 0)
                if not fresh.any():
                    continue
                ia = ia_all[fresh]
                ib = ib_all[fresh]
                na = norm_coords(x, ia)
                nb = norm_coords(y, ib)
                Xl = _tri2_padded(na, nb, Rrel, trel)
                # to world: X_w = Rx^T (X_x - tx)
                Xw = (Xl - tx) @ Rx
                zok = Xl[:, 2] > 0
                base = len(point_xyz)
                new_ids = np.full(len(ia), -1, np.int64)
                new_ids[zok] = base + np.arange(int(zok.sum()))
                point_xyz.extend(Xw[zok])
                obs_of_point.extend(
                    [(x, iai, nai), (y, ibi, nbi)]
                    for iai, nai, ibi, nbi in zip(
                        ia[zok], na[zok], ib[zok], nb[zok]))
                point_of_feat[x][ia[zok]] = new_ids[zok]
                point_of_feat[y][ib[zok]] = new_ids[zok]

    # --- final BA (convertToOutput :240 + bundleSparseMetric)
    views = sorted(poses)
    vmap_idx = {v: i for i, v in enumerate(views)}
    P = len(point_xyz)
    if P == 0:
        raise ValueError(
            "reconstruction failed: the seed pair triangulated no "
            "cheirality-positive points (degenerate geometry)")
    L = max(len(o) for o in obs_of_point)
    obs_xy = np.zeros((P, L, 2))
    obs_view = np.zeros((P, L), np.int32)
    obs_valid = np.zeros((P, L), bool)
    for p, olist in enumerate(obs_of_point):
        for s, (v, _, xy) in enumerate(olist[:L]):
            obs_xy[p, s] = xy
            obs_view[p, s] = vmap_idx[v]
            obs_valid[p, s] = True
    Rs = np.stack([poses[v][0] for v in views])
    ts = np.stack([poses[v][1] for v in views])
    fixed = np.zeros(len(views), bool)
    fixed[0] = True
    # pin scale: also fix the seed partner's pose
    if len(views) > 1:
        fixed[vmap_idx.get(b, 1 if len(views) > 1 else 0)] = True
    prob = ba.make_problem(Rs, ts, np.stack(point_xyz), obs_xy, obs_view,
                           obs_valid, fixed_views=fixed)
    # prune gross-outlier observations before the final BA
    # (PruneStructureFromSceneMetric analog): feature-conflict
    # mis-associations survive the growth loop with residuals orders of
    # magnitude above the noise floor, and a non-robust BA absorbs them
    # into the poses (and, in the free-focal pipelines, into K —
    # measured: final cost 16-29 in normalized units vs ~1e-3 after the
    # prune, and a 14-16% focal bias).  Gate at max(10 x median, 3e-3
    # normalized units); points left with < 2 observations are fully
    # deactivated (unconstrained in the solve, updates are damped to 0).
    r0 = np.asarray(ba.residuals(prob))
    errs = np.linalg.norm(r0, axis=-1)
    med = float(np.median(errs[np.asarray(prob.obs_valid)])) \
        if bool(np.asarray(prob.obs_valid).any()) else 0.0
    gate = max(10.0 * med, 3e-3)
    keep = np.asarray(prob.obs_valid) & (errs <= gate)
    keep[keep.sum(axis=1) < 2] = False
    prob = prob._replace(obs_valid=jnp.asarray(keep))
    out, info = ba.optimize(prob, iterations=ba_iterations)
    return {
        "views": views,
        "poses": {v: (np.asarray(out.R[vmap_idx[v]]),
                      np.asarray(out.t[vmap_idx[v]])) for v in views},
        "points": np.asarray(out.points),
        "problem": out,
        "view_index": dict(vmap_idx),
        "ba_info": info,
    }
