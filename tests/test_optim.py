import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import ba, lie, pose_opt, triangulation

K_CAM = jnp.asarray([458.0, 458.0, 376.0, 240.0], jnp.float32)


def make_world(n_pts=200, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([
        rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 15, n_pts)
    ], -1).astype(np.float32)
    return rng, pts


def project_np(R, t, pts):
    pc = pts @ R.T + t
    return np.stack([458.0 * pc[:, 0] / pc[:, 2] + 376.0,
                     458.0 * pc[:, 1] / pc[:, 2] + 240.0], -1), pc[:, 2]


def test_pose_optimize_converges_from_perturbed_pose():
    rng, pts = make_world()
    R_gt = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t_gt = np.array([0.3, -0.2, 0.5], np.float32)
    uv, z = project_np(R_gt, t_gt, pts)
    uv += rng.normal(0, 0.5, uv.shape)  # 0.5 px noise

    # add 10% outliers
    n_out = len(pts) // 10
    uv[:n_out] += rng.uniform(20, 60, (n_out, 2))

    R0 = np.asarray(lie.so3_exp(jnp.asarray([0.03, -0.12, 0.05], jnp.float32)))
    t0 = t_gt + np.array([0.1, -0.08, 0.12], np.float32)

    res = pose_opt.pose_optimize(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts), jnp.asarray(uv, jnp.float32),
        jnp.ones(len(pts), jnp.float32), jnp.ones(len(pts), bool), K_CAM,
    )
    assert np.abs(np.asarray(res.R) - R_gt).max() < 2e-3
    assert np.abs(np.asarray(res.t) - t_gt).max() < 2e-2
    n_in = int(res.n_inliers)
    assert n_in > 0.85 * (len(pts) - n_out), n_in
    # outliers detected
    assert np.asarray(res.inlier)[:n_out].sum() < 3


def test_pose_optimize_jits():
    _, pts = make_world(64, seed=1)
    uv, _ = project_np(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), pts)
    f = jax.jit(lambda R, t: pose_opt.pose_optimize(
        R, t, jnp.asarray(pts), jnp.asarray(uv, jnp.float32),
        jnp.ones(len(pts), jnp.float32), jnp.ones(len(pts), bool), K_CAM))
    res = f(jnp.eye(3), jnp.zeros(3))
    assert int(res.n_inliers) == 64


def make_ba_problem(n_kf=6, n_pts=150, noise_px=0.7, pose_noise=0.05, pt_noise=0.08, seed=3):
    rng, pts = make_world(n_pts, seed)
    Rs, ts, obs_kf, obs_mp, obs_uv = [], [], [], [], []
    for k in range(n_kf):
        w = rng.normal(0, 0.03, 3).astype(np.float32)
        R = np.asarray(lie.so3_exp(jnp.asarray(w)))
        t = np.array([0.4 * k, 0.02 * k, 0.0], np.float32)
        Rs.append(R); ts.append(t)
        uv, z = project_np(R, t, pts)
        uv = uv + rng.normal(0, noise_px, uv.shape)
        vis = (z > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 752) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        for j in np.nonzero(vis)[0]:
            obs_kf.append(k); obs_mp.append(j); obs_uv.append(uv[j])
    O = len(obs_kf)
    R_gt = np.stack(Rs); t_gt = np.stack(ts)
    # perturb non-fixed poses and all points
    R0 = R_gt.copy(); t0 = t_gt.copy()
    for k in range(2, n_kf):
        dR = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, pose_noise, 3).astype(np.float32))))
        R0[k] = dR @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, pose_noise, 3)
    pts0 = pts + rng.normal(0, pt_noise, pts.shape).astype(np.float32)
    fixed = np.zeros(n_kf, bool); fixed[:2] = True
    prob = ba.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), pts=jnp.asarray(pts0),
        obs_kf=jnp.asarray(obs_kf, jnp.int32), obs_mp=jnp.asarray(obs_mp, jnp.int32),
        obs_uv=jnp.asarray(np.stack(obs_uv), jnp.float32),
        obs_inv_sigma2=jnp.ones(O, jnp.float32), obs_valid=jnp.ones(O, bool),
        fixed_pose=jnp.asarray(fixed),
    )
    return prob, R_gt, t_gt, pts


def test_local_ba_converges():
    prob, R_gt, t_gt, pts_gt = make_ba_problem()
    res = ba.local_ba(prob, K_CAM)
    # fixed poses untouched
    assert np.array_equal(np.asarray(res.R)[:2], np.asarray(prob.R)[:2])
    # free poses recovered
    r_err = np.abs(np.asarray(res.R)[2:] - R_gt[2:]).max()
    t_err = np.abs(np.asarray(res.t)[2:] - t_gt[2:]).max()
    assert r_err < 5e-3, r_err
    assert t_err < 3e-2, t_err
    # points recovered down to the triangulation noise floor
    # (0.7 px noise, f=458, ~2 m total baseline, z≈10 m → σ_z ≈ 0.08 m)
    pt_err = np.linalg.norm(np.asarray(res.pts) - pts_gt, axis=-1)
    init_err = np.linalg.norm(np.asarray(prob.pts) - pts_gt, axis=-1)
    assert np.median(pt_err) < 0.1, np.median(pt_err)
    assert np.median(pt_err) < 0.75 * np.median(init_err)
    assert int(res.n_inlier) > 0.95 * prob.obs_kf.shape[0]


def test_local_ba_with_outliers():
    prob, R_gt, t_gt, pts_gt = make_ba_problem(seed=5)
    rng = np.random.default_rng(9)
    uv = np.asarray(prob.obs_uv).copy()
    n_out = len(uv) // 10
    out_idx = rng.choice(len(uv), n_out, replace=False)
    uv[out_idx] += rng.uniform(15, 50, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    prob = prob._replace(obs_uv=jnp.asarray(uv))
    res = ba.local_ba(prob, K_CAM)
    t_err = np.abs(np.asarray(res.t)[2:] - t_gt[2:]).max()
    assert t_err < 5e-2, t_err
    # most injected outliers classified out
    assert np.asarray(res.obs_inlier)[out_idx].mean() < 0.25


def test_triangulate_dlt_exact():
    _, pts = make_world(100, seed=7)
    R1 = np.eye(3, dtype=np.float32); t1 = np.zeros(3, np.float32)
    R2 = np.asarray(lie.so3_exp(jnp.asarray([0.0, -0.05, 0.0], jnp.float32)))
    t2 = np.array([-0.5, 0.0, 0.0], np.float32)
    pc1 = pts @ R1.T + t1
    pc2 = pts @ R2.T + t2
    rays1 = pc1 / pc1[:, 2:3]
    rays2 = pc2 / pc2[:, 2:3]
    xw = triangulation.triangulate_dlt(
        jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(rays1),
        jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(rays2))
    assert np.abs(np.asarray(xw) - pts).max() < 1e-2
    ok, depths = triangulation.check_triangulation(
        xw, jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(rays1),
        jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(rays2),
        jnp.full(100, 1e-6), jnp.full(100, 1e-6))
    assert np.asarray(ok).mean() > 0.9
