"""Uncalibrated multi-view reconstruction (structure2).

Reference analog: boofcv-sfm alg/sfm/structure2/ —
GeneratePairwiseImageGraph.java:44 (pairwise graph with per-edge 3D-vs-
homography model scores), ProjectiveInitializeAllCommon (seed selection
from the most three-dimensional connected views), SceneWorkingGraph /
DoStuffFromPairwiseGraph (metric elevation + growth).  The reference
marks this pipeline WIP; here it is composed from the library's proven
pieces:

1. pairwise graph: mutual-NN matches per pair, robust F AND robust H;
   the edge's "3D-ness" score = F-inliers / H-inliers (a mostly-planar
   or pure-rotation pair scores ~1 and is a bad seed — exactly the
   reference's is3D test),
2. shared focal length by Sturm's equal-singular-value sweep over the
   graph's own fundamental matrices, aggregated by inlier-weighted
   median (focal_from_fundamentals),
3. metric elevation + growth: the v1 metric graph is derived straight
   from the already-estimated F's and inlier sets
   (_metric_graph_from_edges — no second matching pass), then the v1
   incremental PnP growth runs with the self-calibrated K,
4. final bundle adjustment over all views/points with the focal as a
   free parameter.

Unlike sfm/reconstruction.py (v1), NO camera intrinsics are supplied —
K comes out of the self-calibration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.feature import associate
from boofcv_tpu.geo import ba, robust, triangulate
from boofcv_tpu.sfm import reconstruction, three_view
from boofcv_tpu.sfm.reconstruction import ImageFeatures


@dataclass
class PairwiseEdge2:
    a: int
    b: int
    src: np.ndarray
    dst: np.ndarray
    f_inliers: np.ndarray      # bool over matches
    score_3d: float            # f_inl / h_inl (GeneratePairwiseImageGraph)
    F: np.ndarray = None       # [3, 3] fundamental matrix (pixels)


@dataclass
class PairwiseGraph2:
    features: list
    edges: dict = field(default_factory=dict)


import functools


@functools.lru_cache(maxsize=8)
def _batched_fh_ransac_fn(num_hypotheses: int, threshold_px: float):
    """Build (once per config) the vmapped F+H RANSAC over a pair batch.

    Cached at module level: jax.jit keys on function identity, so a
    fresh closure per call would re-trace and re-compile the identical
    program for every 64-pair chunk."""

    def one(key, a, b, m):
        k1, k2 = jax.random.split(key)
        rf = robust.ransac_fundamental(k1, a, b,
                                       num_hypotheses=num_hypotheses,
                                       inlier_threshold_px=threshold_px,
                                       valid_mask=m)
        rh = robust.ransac_homography(k2, a, b,
                                      num_hypotheses=num_hypotheses,
                                      inlier_threshold_px=threshold_px,
                                      valid_mask=m)
        return (rf.model[0], rf.inliers, rf.num_inliers, rh.num_inliers)

    return jax.jit(jax.vmap(one))


@functools.lru_cache(maxsize=8)
def _batched_fh_ransac_sharded_fn(mesh, num_hypotheses: int,
                                  threshold_px: float):
    """shard_map wrapper of the vmapped F/H RANSAC: the pair axis shards
    over the mesh, every device runs the identical chunk program on its
    slice, results gather back (dist.matching_sharded's fan-out pattern,
    SURVEY §2.9 batch/data parallel — this makes the multi-device
    matching path part of the real structure2 pipeline, not only the
    standalone dist test)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS

    def one(key, a, b, m):
        k1, k2 = jax.random.split(key)
        rf = robust.ransac_fundamental(k1, a, b,
                                       num_hypotheses=num_hypotheses,
                                       inlier_threshold_px=threshold_px,
                                       valid_mask=m)
        rh = robust.ransac_homography(k2, a, b,
                                      num_hypotheses=num_hypotheses,
                                      inlier_threshold_px=threshold_px,
                                      valid_mask=m)
        return (rf.model[0], rf.inliers, rf.num_inliers, rh.num_inliers)

    axes = tuple(mesh.axis_names)
    spec = PS(axes)
    shard = shard_map(jax.vmap(one), mesh=mesh,
                      in_specs=(spec, spec, spec, spec),
                      out_specs=(spec, spec, spec, spec),
                      check_vma=False)
    return jax.jit(shard)


def _batched_fh_ransac(keys, pa, pb, mask, num_hypotheses: int = 256,
                       threshold_px: float = 2.0, mesh=None):
    """F-RANSAC and H-RANSAC for a BATCH of pairs as one vmapped jitted
    program — the hypothesis-parallel solvers are pure traced jnp, so
    pairs become one more batch axis (the graph generator's former
    2-dispatches-per-pair host loop was the structure2 scaling wall).
    With ``mesh``, the pair axis additionally shards across devices."""
    if mesh is not None:
        return _batched_fh_ransac_sharded_fn(
            mesh, num_hypotheses, threshold_px)(keys, pa, pb, mask)
    return _batched_fh_ransac_fn(num_hypotheses, threshold_px)(
        keys, pa, pb, mask)


def generate_pairwise_graph(images, max_features: int = 300,
                            detect=None, min_matches: int = 20,
                            seed: int = 0,
                            pair_chunk: int = 64,
                            mesh=None) -> PairwiseGraph2:
    """All-pairs matching with F-vs-H model scoring
    (GeneratePairwiseImageGraph.process analog).

    Candidate pairs are padded to a common match count and their robust
    F/H fits run ``pair_chunk`` at a time through one vmapped RANSAC
    program (50 views = 1225 pairs = ~20 dispatches, not 2450).
    ``mesh``: optional jax.sharding.Mesh — each chunk's pair axis then
    shards across the mesh devices (chunk size is rounded up to a mesh
    multiple), turning the all-pairs stage into the SURVEY §2.9
    batch-parallel fan-out."""
    if mesh is not None:
        n_dev = mesh.devices.size
        pair_chunk = ((pair_chunk + n_dev - 1) // n_dev) * n_dev
    detect = detect or (lambda im: reconstruction.detect_describe(
        im, max_features))
    feats = [detect(im) for im in images]
    g = PairwiseGraph2(feats)
    n = len(images)

    cands = []
    for a in range(n):
        for b in range(a + 1, n):
            src, dst = reconstruction.match_features(feats[a], feats[b])
            if len(src) < min_matches:
                continue
            pa = np.stack([feats[a].xs[src], feats[a].ys[src]], 1)
            pb = np.stack([feats[b].xs[dst], feats[b].ys[dst]], 1)
            cands.append((a, b, src, dst, pa, pb))
    if not cands:
        return g

    nmax = max(len(c[4]) for c in cands)
    P = len(cands)
    pa_all = np.zeros((P, nmax, 2))
    pb_all = np.zeros((P, nmax, 2))
    mask_all = np.zeros((P, nmax), bool)
    for i, (_, _, _, _, pa, pb) in enumerate(cands):
        pa_all[i, :len(pa)] = pa
        pb_all[i, :len(pb)] = pb
        mask_all[i, :len(pa)] = True
    keys = jax.random.split(jax.random.PRNGKey(seed), P)

    for lo in range(0, P, pair_chunk):
        hi = min(lo + pair_chunk, P)
        # pad the last chunk to the compiled chunk shape (dummy = slot 0)
        idx = np.arange(lo, hi)
        if hi - lo < pair_chunk and (P > pair_chunk or mesh is not None):
            idx = np.concatenate(
                [idx, np.zeros(pair_chunk - (hi - lo), np.int64)])
        F_b, inl_b, nf_b, nh_b = _batched_fh_ransac(
            keys[idx], jnp.asarray(pa_all[idx]), jnp.asarray(pb_all[idx]),
            jnp.asarray(mask_all[idx]), mesh=mesh)
        F_b = np.asarray(F_b)
        inl_b = np.asarray(inl_b)
        nf_b = np.asarray(nf_b)
        nh_b = np.asarray(nh_b)
        for j, p in enumerate(range(lo, hi)):
            a, b, src, dst, pa, pb = cands[p]
            nf = int(nf_b[j])
            if nf < min_matches:
                continue
            g.edges[(a, b)] = PairwiseEdge2(
                a, b, src, dst, inl_b[j, :len(pa)],
                nf / max(int(nh_b[j]), 1), F_b[j])
    return g


def focal_from_fundamentals(g: PairwiseGraph2, width: int, height: int):
    """Shared-focal self-calibration by Sturm's equal-singular-value
    criterion: for the correct K, E = K^T F K has two equal non-zero
    singular values.  Sweep focal candidates over every 3D edge and take
    the inlier-weighted median of the per-edge minima — far more
    noise-robust than the linear dual-quadratic solve.
    """
    cands = np.geomspace(0.25 * width, 5.0 * width, 120)
    edges3d = [e for e in g.edges.values()
               if e.F is not None and e.score_3d >= 1.5]
    if not edges3d:
        raise ValueError("no 3D edges for focal self-calibration")
    # ONE batched SVD over [edges, candidates] (the former per-edge
    # Python loop ran 120 sequential SVDs per edge — minutes at 50
    # views).  numpy's SVD batches natively over leading axes and the
    # matrices are 3x3, so this stays host-side.
    Fs = np.stack([e.F for e in edges3d])                    # [E, 3, 3]
    Ks = np.zeros((len(cands), 3, 3))
    Ks[:, 0, 0] = Ks[:, 1, 1] = cands
    Ks[:, 0, 2] = (width - 1) / 2
    Ks[:, 1, 2] = (height - 1) / 2
    Ks[:, 2, 2] = 1.0
    E_all = np.einsum("cji,ejk,ckl->ecil", Ks, Fs, Ks)       # [E, C, 3, 3]
    sv = np.linalg.svd(E_all, compute_uv=False)              # [E, C, 3]
    cost = (sv[..., 0] - sv[..., 1]) \
        / np.maximum(sv[..., 0] + sv[..., 1], 1e-12)         # [E, C]
    picks = cands[np.argmin(cost, axis=1)]
    weights = [int(e.f_inliers.sum()) for e in edges3d]
    order = np.argsort(picks)
    cum = np.cumsum(np.asarray(weights)[order])
    med = np.asarray(picks)[order][np.searchsorted(cum, cum[-1] / 2.0)]
    return float(med)


def _poses_from_essentials(E_mats, na, nb, mask):
    """Vmapped essential decomposition + masked cheirality selection for
    a BATCH of edges: E_mats [M, 3, 3], na/nb [M, N, 2] normalized
    coords (padded), mask [M, N].  Returns (R [M, 3, 3], t [M, 3])."""
    from boofcv_tpu.geo import epipolar
    from boofcv_tpu.geo.triangulate import triangulate_two_view_linear

    def one(E, p1, p2, m):
        R4, t4 = epipolar.decompose_essential(E)

        def count(R, t):
            X = triangulate_two_view_linear(p1, p2, R, t)
            z1 = X[..., 2]
            z2 = (X @ R.T + t)[..., 2]
            return jnp.sum((z1 > 0) & (z2 > 0) & m)

        counts = jax.vmap(count)(R4, t4)
        best = jnp.argmax(counts)
        return R4[best], t4[best]

    return jax.vmap(one)(E_mats, na, nb, mask)


def _metric_graph_from_edges(g: PairwiseGraph2, K):
    """Derive the v1 metric pairwise graph (relative poses) from the
    structure2 graph's OWN fundamental matrices: E = K^T F K, decompose,
    cheirality-select on the inlier matches — ONE vmapped program over
    all edges instead of an eager op chain per edge.  Skips the
    former second all-pairs matching + per-pair essential-RANSAC pass
    entirely (the 50-view scaling wall)."""
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    graph = reconstruction.PairwiseGraph(g.features)
    items = [((a, b), e) for (a, b), e in g.edges.items()
             if e.f_inliers.sum() >= 16]
    if not items:
        return graph
    nmax = max(int(e.f_inliers.sum()) for _, e in items)
    M = len(items)
    na_all = np.zeros((M, nmax, 2))
    nb_all = np.zeros((M, nmax, 2))
    mask_all = np.zeros((M, nmax), bool)
    E_all = np.zeros((M, 3, 3))
    for i, ((a, b), e) in enumerate(items):
        inl = e.f_inliers
        fa, fb = g.features[a], g.features[b]
        src, dst = e.src[inl], e.dst[inl]
        pa = np.stack([fa.xs[src], fa.ys[src], np.ones(len(src))], 1)
        pb = np.stack([fb.xs[dst], fb.ys[dst], np.ones(len(dst))], 1)
        k = len(src)
        na_all[i, :k] = (pa @ Kinv.T)[:, :2]
        nb_all[i, :k] = (pb @ Kinv.T)[:, :2]
        mask_all[i, :k] = True
        E_all[i] = K.T @ e.F @ K
    Rb, tb = _poses_from_essentials(jnp.asarray(E_all),
                                    jnp.asarray(na_all),
                                    jnp.asarray(nb_all),
                                    jnp.asarray(mask_all))
    Rb = np.asarray(Rb)
    tb = np.asarray(tb)
    for i, ((a, b), e) in enumerate(items):
        graph.edges[(a, b)] = reconstruction.PairwiseEdge(
            a, b, e.src, e.dst, e.f_inliers, Rb[i], tb[i],
            int(e.f_inliers.sum()))
    return graph


def reconstruct_uncalibrated(images, max_features: int = 300, detect=None,
                             ba_iterations: int = 20, seed: int = 0,
                             mesh=None):
    """Full uncalibrated pipeline: pairwise graph with F/H model scores
    -> shared focal by Sturm's equal-singular-value sweep over the 3D
    edges -> calibrated incremental growth (sfm/reconstruction v1
    machinery with the self-calibrated K) -> global bundle adjustment
    with the focal as a free parameter.

    Returns dict with "K", "poses" {view: (R, t)}, "points" [M, 3],
    "graph", "ba_info".

    Design note: the trifocal + linear dual-quadratic route
    (three_view.estimate_metric_scene) is exact on clean data but
    noise-fragile; the per-edge Sturm sweep scored by E's singular-value
    ratio and aggregated by inlier-weighted median is far more robust
    (matches the reference pairing its linear self-calib with
    guess-and-check estimators), and the final free-focal bundle
    polishes the estimate against every observation.
    """
    g = generate_pairwise_graph(images, max_features, detect, seed=seed,
                                mesh=mesh)
    if not g.edges:
        raise ValueError("no connected 3D view pairs in the graph")
    h, w = images[0].shape[:2]
    f0 = focal_from_fundamentals(g, w, h)
    K = np.array([[f0, 0.0, (w - 1) / 2.0],
                  [0.0, f0, (h - 1) / 2.0], [0.0, 0.0, 1.0]])

    # calibrated incremental growth with the self-calibrated K — the v1
    # metric graph is derived straight from the already-estimated F's
    # and inlier sets (no second matching pass)
    g1 = _metric_graph_from_edges(g, K)
    scene = reconstruction.reconstruct_incremental(
        g1, K, ba_iterations=ba_iterations, seed=seed + 1)

    # global BA with a SHARED free focal, optimized by golden-section
    # search with the pose/point bundle nested inside each evaluation.
    # A fixed shared f is exactly the normalized model with obs/f, so
    # the existing solver nests unchanged; costs compare across f in
    # pixel^2 units (cost_norm * f^2).  The earlier per-view-free-focal
    # polish ("pinhole_f" + mean) was weakly constrained — measured on
    # the 5-view oracle scene: all per-view focals drifted together
    # 289 -> 326 (true 280) at noise-level residuals, because V
    # independent focals + poses + points can trade off along a
    # near-ambiguity that one shared parameter cannot.
    prob = scene["problem"]          # normalized model, converged
    obs_px = np.asarray(prob.obs_xy) * f0       # centered pixels
    vlist = sorted(scene["poses"])
    R0 = np.asarray(prob.R)
    t0 = np.asarray(prob.t)
    X0 = np.asarray(prob.points)
    ov = np.asarray(prob.obs_view)
    oval = np.asarray(prob.obs_valid)
    # gauge: fix ONE view (6 DoF; the scale null-direction is handled by
    # LM damping).  Freezing the full seed PAIR — 12 DoF estimated under
    # the initial focal guess — over-constrains the gauge and biases the
    # recovered focal (measured on the 5-view oracle: the cost landscape
    # bottoms at f=333 with the pair frozen vs f=280, the truth, with
    # one view frozen).
    fixed = np.zeros(R0.shape[0], bool)
    fixed[0] = True

    def solve_at(f):
        pf = ba.make_problem(R0, t0, X0, obs_px / f, ov, oval,
                             fixed_views=fixed)
        out, info = ba.optimize(pf, iterations=max(ba_iterations // 2, 8))
        return float(info["final_cost"]) * f * f, out

    gr = (np.sqrt(5.0) - 1.0) / 2.0
    lo, hi = 0.6 * f0, 1.7 * f0
    x1 = hi - gr * (hi - lo)
    x2 = lo + gr * (hi - lo)
    c1, o1 = solve_at(x1)
    c2, o2 = solve_at(x2)
    for _ in range(10):
        if c1 < c2:
            hi, x2, c2, o2 = x2, x1, c1, o1
            x1 = hi - gr * (hi - lo)
            c1, o1 = solve_at(x1)
        else:
            lo, x1, c1, o1 = x1, x2, c2, o2
            x2 = lo + gr * (hi - lo)
            c2, o2 = solve_at(x2)
    f_ref, out, info = (x1, o1, {"final_cost": c1}) if c1 < c2 \
        else (x2, o2, {"final_cost": c2})
    K = np.array([[f_ref, 0.0, (w - 1) / 2.0],
                  [0.0, f_ref, (h - 1) / 2.0], [0.0, 0.0, 1.0]])
    vmap_idx = scene["view_index"]
    return {
        "K": K,
        "poses": {v: (np.asarray(out.R[vmap_idx[v]]),
                      np.asarray(out.t[vmap_idx[v]])) for v in vlist},
        "points": np.asarray(out.points),
        "graph": g,
        "ba_info": info,
    }
