"""Bundle-adjustment oracle tests: synthetic scenes with perturbed initial
states must converge back to ground truth (SURVEY §4.4 strategy applied to
the flagship LM-Schur solver)."""

import numpy as np
import jax
import jax.numpy as jnp

from boofcv_tpu.geo import ba, se3


def build_scene(rng, n_views=6, n_points=60, max_obs=None, model="normalized",
                noise=0.0):
    max_obs = max_obs or n_views
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-2, 2, n_points),
                    rng.uniform(4, 8, n_points)], axis=1)
    Rs, ts = [], []
    for v in range(n_views):
        w = rng.normal(0, 0.03, 3)
        Rs.append(np.asarray(se3.exp_so3(jnp.asarray(w))))
        ts.append(np.array([0.4 * v - 1.0, 0.05 * v, 0.02 * v]))
    Rs = np.stack(Rs)
    ts = np.stack(ts)
    if model == "snavely":
        intr = np.stack([np.full(n_views, 500.0),
                         np.full(n_views, -1e-7 * 0),
                         np.full(n_views, 0.0)], axis=1)
        # snavely looks down -z; flip points to negative z
        pts = pts * np.array([1.0, 1.0, -1.0])
    else:
        intr = np.zeros((n_views, 0))

    obs_xy = np.zeros((n_points, max_obs, 2))
    obs_view = np.zeros((n_points, max_obs), np.int32)
    obs_valid = np.zeros((n_points, max_obs), bool)
    for p in range(n_points):
        views = rng.permutation(n_views)[: rng.integers(3, max_obs + 1)]
        for s, v in enumerate(sorted(views)):
            Xc = Rs[v] @ pts[p] + ts[v]
            proj = np.asarray(ba._project(model, jnp.asarray(Xc), jnp.asarray(intr[v])))
            obs_xy[p, s] = proj + rng.normal(0, noise, 2)
            obs_view[p, s] = v
            obs_valid[p, s] = True
    return pts, Rs, ts, intr, obs_xy, obs_view, obs_valid


def test_ba_converges_from_perturbation():
    rng = np.random.default_rng(0)
    pts, Rs, ts, intr, oxy, ov, oval = build_scene(rng)
    # perturb all views except 0 and 1 (both gauge-fixed: fixing two views
    # pins the 7th — scale — gauge DOF of monocular BA)
    Rp = Rs.copy()
    tp = ts.copy()
    for v in range(2, len(Rs)):
        Rp[v] = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(0, 0.01, 3)))) @ Rs[v]
        tp[v] = ts[v] + rng.normal(0, 0.02, 3)
    ptsp = pts + rng.normal(0, 0.05, pts.shape)
    fixed = np.zeros(len(Rs), bool)
    fixed[:2] = True
    prob = ba.make_problem(Rp, tp, ptsp, oxy, ov, oval, fixed_views=fixed)
    out, info = ba.optimize(prob, iterations=15)
    assert float(info["final_cost"]) < 1e-12 * max(1.0, float(info["initial_cost"]))
    # gauge fully pinned by two fixed views -> exact GT recovery
    np.testing.assert_allclose(np.asarray(out.R[2]), Rs[2], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.t[-1]), ts[-1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.points), pts, atol=1e-5)


def test_ba_noisy_reaches_noise_floor():
    rng = np.random.default_rng(1)
    noise = 5e-4
    pts, Rs, ts, intr, oxy, ov, oval = build_scene(rng, noise=noise)
    Rp = Rs.copy(); tp = ts.copy()
    for v in range(1, len(Rs)):
        Rp[v] = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(0, 0.005, 3)))) @ Rs[v]
        tp[v] = ts[v] + rng.normal(0, 0.01, 3)
    prob = ba.make_problem(Rp, tp, pts + rng.normal(0, 0.02, pts.shape), oxy, ov, oval)
    out, info = ba.optimize(prob, iterations=15)
    n_obs = oval.sum()
    rms = np.sqrt(2 * float(info["final_cost"]) / (2 * n_obs))
    assert rms < 2.0 * noise  # at/near the injected noise floor


def test_ba_snavely_model():
    rng = np.random.default_rng(2)
    pts, Rs, ts, intr, oxy, ov, oval = build_scene(rng, model="snavely")
    Rp = Rs.copy(); tp = ts.copy()
    for v in range(2, len(Rs)):
        Rp[v] = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(0, 0.003, 3)))) @ Rs[v]
        tp[v] = ts[v] + rng.normal(0, 0.01, 3)
    intr_p = intr + np.array([5.0, 0.0, 0.0])  # perturb focal (every view —
    # intrinsics of gauge-fixed views must still be optimized)
    fixed = np.zeros(len(Rs), bool); fixed[:2] = True
    prob = ba.make_problem(Rp, tp, pts + rng.normal(0, 0.02, pts.shape),
                           oxy, ov, oval, intr=intr_p, model="snavely",
                           fixed_views=fixed)
    out, info = ba.optimize(prob, iterations=20)
    assert float(info["final_cost"]) < 1e-6
    np.testing.assert_allclose(np.asarray(out.intr[:, 0]), intr[:, 0], atol=0.5)


def _jacobians_ad(prob):
    """Autodiff oracle for the analytic jacobians (the round-2 impl)."""
    k = ba.n_intr(prob.model)
    model = prob.model

    def one(R, t, intr, X, xy):
        def f(xi, dX, dintr):
            dR, dt = se3.exp_se3(xi)
            Rc, tc = se3.compose(dR, dt, R, t)
            Xc = Rc @ (X + dX) + tc
            return ba._project(model, Xc, intr + dintr) - xy
        xi0 = jnp.zeros((6,), jnp.float64)
        dX0 = jnp.zeros((3,), jnp.float64)
        di0 = jnp.zeros((k,), jnp.float64)
        Jxi, JX, Ji = jax.jacfwd(f, argnums=(0, 1, 2))(xi0, dX0, di0)
        Jv = jnp.concatenate([Jxi, Ji], axis=-1) if k else Jxi
        return Jv, JX

    R_o = prob.R[prob.obs_view]
    t_o = prob.t[prob.obs_view]
    intr_o = prob.intr[prob.obs_view]
    Xb = jnp.broadcast_to(prob.points[:, None, :],
                          prob.obs_xy.shape[:2] + (3,))
    Jv, Jp = jax.vmap(jax.vmap(one))(R_o, t_o, intr_o, Xb, prob.obs_xy)
    valid = prob.obs_valid[..., None, None]
    return jnp.where(valid, Jv, 0.0), jnp.where(valid, Jp, 0.0)


def test_analytic_jacobians_match_autodiff():
    for model in ("normalized", "snavely", "pinhole_f"):
        rng = np.random.default_rng(11)
        pts, Rs, ts, intr, oxy, ov, oval = build_scene(
            rng, n_views=4, n_points=15,
            model="snavely" if model == "snavely" else "normalized")
        if model == "snavely":
            intr = intr + np.array([0.0, 0.02, 0.004])  # nonzero distortion
        if model == "pinhole_f":
            intr = np.full((len(Rs), 1), 450.0)
            oxy = oxy * 450.0      # normalized obs -> pinhole_f pixels
        prob = ba.make_problem(Rs, ts, pts, oxy, ov, oval, intr=intr,
                               model=model)
        Jv, Jp, r = ba._jacobians(prob)
        Jv_ad, Jp_ad = _jacobians_ad(prob)
        np.testing.assert_allclose(np.asarray(Jv), np.asarray(Jv_ad),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(Jp), np.asarray(Jp_ad),
                                   rtol=1e-9, atol=1e-9)


def test_ba_f32_fast_path_converges():
    """The f32 fast path must reach the (injected) noise floor."""
    rng = np.random.default_rng(5)
    noise = 5e-4
    pts, Rs, ts, intr, oxy, ov, oval = build_scene(rng, noise=noise)
    Rp = Rs.copy(); tp = ts.copy()
    for v in range(2, len(Rs)):
        Rp[v] = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(0, 0.005, 3)))) @ Rs[v]
        tp[v] = ts[v] + rng.normal(0, 0.01, 3)
    fixed = np.zeros(len(Rs), bool); fixed[:2] = True
    prob = ba.make_problem(Rp, tp, pts + rng.normal(0, 0.02, pts.shape),
                           oxy, ov, oval, fixed_views=fixed,
                           dtype=jnp.float32)
    assert prob.points.dtype == jnp.float32
    out, info = ba.optimize(prob, iterations=15)
    assert out.points.dtype == jnp.float32
    n_obs = oval.sum()
    rms = np.sqrt(2 * float(info["final_cost"]) / (2 * n_obs))
    assert rms < 2.5 * noise


def test_ba_cost_monotone_nonincreasing():
    rng = np.random.default_rng(3)
    pts, Rs, ts, intr, oxy, ov, oval = build_scene(rng, noise=1e-3)
    prob = ba.make_problem(Rs, ts, pts + rng.normal(0, 0.1, pts.shape), oxy, ov, oval)
    out, info = ba.optimize(prob, iterations=10)
    costs = np.asarray(info["costs"])
    assert np.all(np.diff(costs) <= 1e-9)
    assert float(info["final_cost"]) <= float(info["initial_cost"])
