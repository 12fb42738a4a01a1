"""Visual-inertial window optimization: recover perturbed poses/velocities/bias."""
import numpy as np
import jax.numpy as jnp

import sys
sys.path.insert(0, "/root/repo")
from tests.test_imu_init import simulate  # noqa: E402
from orbslam3_jax.ops import lie, vi_ba  # noqa: E402

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)


def test_vi_window_recovers_perturbed_states():
    # metric-scale simulated trajectory with gravity + biases (scale=1)
    R_map, p_map, preints, Rwg_gt, scale, bg_gt, ba_gt, v_gt = simulate(
        n_kf=8, scale=1.0, g_tilt=(0.0, 0.0), seed=3)
    Kn = len(R_map)
    # world → camera poses (body == camera)
    R_cw_gt = np.stack([R.T for R in R_map])
    t_cw_gt = np.stack([-R.T @ p for R, p in zip(R_map, p_map)])

    # landmarks + visual observations
    rng = np.random.default_rng(0)
    n_pts = 150
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(5, 15, n_pts)], -1).astype(np.float32)
    obs_kf, obs_uv, obs_pts = [], [], []
    for k in range(Kn):
        pc = pts @ R_cw_gt[k].T + t_cw_gt[k]
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376,
                       458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uv += rng.normal(0, 0.5, uv.shape)
        for j in range(n_pts):
            obs_kf.append(k)
            obs_uv.append(uv[j])
            obs_pts.append(pts[j])
    O = len(obs_kf)

    # perturb all but the first pose + velocities + bias guess
    R0 = R_cw_gt.copy()
    t0 = t_cw_gt.copy()
    for k in range(1, Kn):
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32))))
        R0[k] = dR @ R_cw_gt[k]
        t0[k] = t_cw_gt[k] + rng.normal(0, 0.03, 3)
    vels0 = v_gt + rng.normal(0, 0.1, v_gt.shape)
    fixed = np.zeros(Kn, bool)
    fixed[0] = True

    stack = lambda attr: jnp.asarray(
        np.stack([np.asarray(getattr(s, attr)) for s in preints]))
    cov = jnp.asarray(np.stack([np.asarray(s.C)[:9, :9] for s in preints]))

    res = vi_ba.vi_window_optimize(
        jnp.asarray(R0.astype(np.float32)), jnp.asarray(t0.astype(np.float32)),
        jnp.asarray(vels0.astype(np.float32)), jnp.zeros(3), jnp.zeros(3),
        jnp.asarray(np.stack(obs_pts).astype(np.float32)),
        jnp.asarray(obs_kf, jnp.int32),
        jnp.asarray(np.stack(obs_uv).astype(np.float32)),
        jnp.ones(O, jnp.float32), jnp.ones(O, bool),
        stack("dT"), stack("dR"), stack("dV"), stack("dP"),
        stack("JRg"), stack("JVg"), stack("JVa"), stack("JPg"), stack("JPa"),
        cov, jnp.ones(Kn - 1, bool),
        jnp.asarray(K_CAM), jnp.asarray(fixed), iters=10)

    t_err0 = np.abs(t0[1:] - t_cw_gt[1:]).max()
    t_err = np.abs(np.asarray(res.t)[1:] - t_cw_gt[1:]).max()
    assert t_err < 0.3 * t_err0, (t_err, t_err0)
    v_err = np.abs(np.asarray(res.vels) - v_gt).max()
    assert v_err < 0.06, v_err
    # gyro bias observable through the rotation chain
    assert np.abs(np.asarray(res.bg) - bg_gt).max() < 2e-3, res.bg


def test_vi_joint_ba_recovers_states_and_landmarks():
    """Joint landmark+pose/vel/bias Schur solve (reference LocalInertialBA /
    FullInertialBA, src/Optimizer.cc:4314/:495): perturbing poses, velocities
    AND landmarks must all converge back — the alternating round-1 scheme
    could not move landmarks and inertial states consistently."""
    R_map, p_map, preints, Rwg_gt, scale, bg_gt, ba_gt, v_gt = simulate(
        n_kf=8, scale=1.0, g_tilt=(0.0, 0.0), seed=5)
    Kn = len(R_map)
    R_cw_gt = np.stack([R.T for R in R_map])
    t_cw_gt = np.stack([-R.T @ p for R, p in zip(R_map, p_map)])

    rng = np.random.default_rng(1)
    n_pts = 120
    pts_gt = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                       rng.uniform(5, 15, n_pts)], -1).astype(np.float32)
    obs_kf, obs_mp, obs_uv = [], [], []
    for k in range(Kn):
        pc = pts_gt @ R_cw_gt[k].T + t_cw_gt[k]
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376,
                       458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uv += rng.normal(0, 0.4, uv.shape)
        for j in range(n_pts):
            obs_kf.append(k)
            obs_mp.append(j)
            obs_uv.append(uv[j])
    O = len(obs_kf)

    R0 = R_cw_gt.copy()
    t0 = t_cw_gt.copy()
    for k in range(1, Kn):
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32))))
        R0[k] = dR @ R_cw_gt[k]
        t0[k] = t_cw_gt[k] + rng.normal(0, 0.03, 3)
    vels0 = v_gt + rng.normal(0, 0.1, v_gt.shape)
    pts0 = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    fixed = np.zeros(Kn, bool)
    fixed[0] = True

    stack = lambda attr: jnp.asarray(
        np.stack([np.asarray(getattr(s, attr)) for s in preints]))
    cov = jnp.asarray(np.stack([np.asarray(s.C)[:9, :9] for s in preints]))

    res = vi_ba.vi_joint_ba(
        jnp.asarray(R0.astype(np.float32)), jnp.asarray(t0.astype(np.float32)),
        jnp.asarray(vels0.astype(np.float32)),
        jnp.zeros((Kn, 3), jnp.float32), jnp.zeros((Kn, 3), jnp.float32),
        jnp.asarray(fixed),
        jnp.asarray(pts0), jnp.asarray(obs_kf, jnp.int32),
        jnp.asarray(obs_mp, jnp.int32),
        jnp.asarray(np.stack(obs_uv).astype(np.float32)),
        jnp.full(O, -1.0, jnp.float32),       # mono rows
        jnp.ones(O, jnp.float32), jnp.ones(O, bool),
        jnp.asarray(0.0, jnp.float32),
        stack("dT"), stack("dR"), stack("dV"), stack("dP"),
        stack("JRg"), stack("JVg"), stack("JVa"), stack("JPg"), stack("JPa"),
        cov, jnp.ones(Kn - 1, bool),
        jnp.asarray(K_CAM), iters=16,
        # FullInertialBA-at-init configuration: first pose fixed, boundary
        # velocity/biases free, bias priors (reference :495 bInit path)
        prior_g=1e2, prior_a=1e3, fix_vel_bias_of_fixed=False)

    t_err0 = np.abs(t0[1:] - t_cw_gt[1:]).max()
    t_err = np.abs(np.asarray(res.t)[1:] - t_cw_gt[1:]).max()
    assert t_err < 0.3 * t_err0, (t_err, t_err0)
    v_err = np.abs(np.asarray(res.vels) - v_gt).max()
    assert v_err < 0.03, v_err
    # landmarks converge to their MAP optimum: median error at the visual
    # noise floor (far points keep depth uncertainty — 0.4 px at z=15 with a
    # sub-meter baseline is ~0.5 units of depth sigma; measured sub-pixel
    # reprojections at the optimum)
    pe = np.linalg.norm(np.asarray(res.pts) - pts_gt, axis=1)
    assert np.median(pe) < 0.15, np.median(pe)
    # per-KF biases near the simulated truth
    assert np.abs(np.asarray(res.bg) - bg_gt).max() < 3e-3, res.bg
    assert np.abs(np.asarray(res.ba) - ba_gt).max() < 0.03, res.ba
    assert int(res.obs_inlier.sum()) > 0.95 * O


def test_pose_inertial_15dim_marginal_prior_tracks_bias():
    """Frame-rate VI optimization with the 15-dim ConstraintPoseImu chain
    (reference include/G2oTypes.h:711, Optimizer.cc:4956-5070): pose+vel+
    biases are jointly marginalized frame to frame with bias random-walk
    edges. Driving several frames with a WRONG initial bias must recover
    toward the true bias through the chain — the r3 9-dim prior had no bias
    linkage at frame rate, so the error could never shrink."""
    from orbslam3_jax.ops import imu as imu_ops

    bg_true = (0.02, -0.015, 0.01)
    ba_true = (0.12, -0.08, 0.1)
    R_map, p_map, preints, Rwg_gt, scale, bg_gt, ba_gt, v_gt = simulate(
        n_kf=8, kf_dt=0.05, scale=1.0, g_tilt=(0.0, 0.0), seed=11,
        bg=bg_true, ba=ba_true)
    Kn = len(R_map)
    R_cw = np.stack([R.T for R in R_map]).astype(np.float32)
    t_cw = np.stack([-R.T @ p for R, p in zip(R_map, p_map)]).astype(np.float32)

    rng = np.random.default_rng(2)
    n_pts = 200
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(5, 15, n_pts)], -1).astype(np.float32)

    # start with a WRONG bias estimate (zero); the truth is bg_true/ba_true
    bg_est = np.zeros(3, np.float32)
    ba_est = np.zeros(3, np.float32)
    prior_H = None
    e_bg0 = np.linalg.norm(bg_est - bg_gt)
    e_ba0 = np.linalg.norm(ba_est - ba_gt)

    v_est = v_gt[0].astype(np.float32)
    R_prev, p_prev = R_map[0].astype(np.float32), p_map[0].astype(np.float32)
    for k in range(1, Kn):
        pre = preints[k - 1]
        dR_c, dV_c, dP_c = imu_ops.corrected_delta(
            pre, jnp.asarray(bg_est), jnp.asarray(ba_est))
        pc = pts @ R_cw[k].T + t_cw[k]
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376,
                       458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uv += rng.normal(0, 0.4, uv.shape)
        # seed the current pose from a perturbed GT (motion-model-quality)
        dRp = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.005, 3).astype(np.float32))))
        R0 = (dRp @ R_cw[k]).astype(np.float32)
        t0 = t_cw[k] + rng.normal(0, 0.01, 3).astype(np.float32)
        res = vi_ba.pose_inertial_optimize(
            jnp.asarray(R0), jnp.asarray(t0),
            jnp.asarray(v_est + rng.normal(0, 0.05, 3).astype(np.float32)),
            jnp.asarray(R_prev), jnp.asarray(p_prev), jnp.asarray(v_est),
            jnp.asarray(bg_est), jnp.asarray(ba_est),
            pre.dT, dR_c, dV_c, dP_c,
            pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa,
            jnp.asarray(np.asarray(pre.C)[:9, :9]),
            jnp.asarray(pts), jnp.asarray(uv.astype(np.float32)),
            jnp.ones(n_pts, jnp.float32), jnp.ones(n_pts, bool),
            jnp.asarray(K_CAM),
            # loose random-walk sigmas so the bias correction is visible
            # within an 8-frame test window: at the real EuRoC walk sigmas
            # (1e-5/sqrt(s)) the RW information is ~2e12 and frame-rate bias
            # motion is ~1e-8/frame BY DESIGN (the reference behaves the
            # same; biases converge through keyframe-rate inertial BA).
            sigma_gw=3e-2, sigma_aw=0.3,
            prior_H=None if prior_H is None else jnp.asarray(prior_H))
        assert np.asarray(res.H_marg).shape == (15, 15)
        Rn = np.asarray(res.R)
        bg_est = np.asarray(res.bg).astype(np.float32)
        ba_est = np.asarray(res.ba).astype(np.float32)
        v_est = np.asarray(res.v).astype(np.float32)
        prior_H = np.asarray(res.H_marg)
        R_prev = Rn.T.astype(np.float32)
        p_prev = (-Rn.T @ np.asarray(res.t)).astype(np.float32)
        # pose stays locked through the chain
        assert np.abs(np.asarray(res.t) - t_cw[k]).max() < 0.05

    # gyro bias is strongly observable through the rotation chain; accel
    # through gravity/velocity coupling (weaker over this short window)
    e_bg = np.linalg.norm(bg_est - bg_gt)
    e_ba = np.linalg.norm(ba_est - ba_gt)
    assert e_bg < 0.35 * e_bg0, (e_bg, e_bg0)
    assert e_ba < 1.05 * e_ba0, (e_ba, e_ba0)   # accel: weakly observable
    # over this short window — must not diverge
