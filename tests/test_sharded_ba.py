"""Multi-device sharded BA on the 8-virtual-CPU mesh: must match single-device BA."""
import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import lie
from orbslam3_jax.parallel import sharded_ba

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)


def make_problem(n_kf=4, n_pts=64, seed=0, loop=False):
    """loop=False: short line of cameras (t_x = 0.5k — fine for small n_kf).
    loop=True: cameras on a bounded loop INSIDE the scene, the realistic
    large-K geometry — a 256-camera straight line spreads 127 m from the
    cloud, blowing the rotational Jacobian entries (|xc| ~ 100) up to
    Hessian scale ~1e12 / cond ~3e12, where f32 ASSEMBLY noise alone
    destroys the weak modes; no f32 solver (sharded or not) can reach the
    accuracy bound on that fixture."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(5, 15, n_pts)], -1).astype(np.float32)
    Rs, ts = [], []
    obs_kf, obs_mp, obs_uv = [], [], []
    for k in range(n_kf):
        R = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.02, 3).astype(np.float32))))
        if loop:
            ph = 2 * np.pi * k / n_kf
            t = np.array([2.0 * np.sin(ph), 1.0 * np.cos(ph), 0.3 * np.sin(2 * ph)],
                         np.float32)
        else:
            t = np.array([0.5 * k, 0, 0], np.float32)
        Rs.append(R); ts.append(t)
        pc = pts @ R.T + t
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376, 458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uv += rng.normal(0, 0.5, uv.shape)
        for j in range(n_pts):
            obs_kf.append(k); obs_mp.append(j); obs_uv.append(uv[j])
    return (np.stack(Rs), np.stack(ts), pts,
            np.asarray(obs_kf, np.int32), np.asarray(obs_mp, np.int32),
            np.stack(obs_uv).astype(np.float32))


def test_sharded_ba_runs_and_reduces_error():
    n_dev = len(jax.devices())
    assert n_dev == 8, n_dev
    R_gt, t_gt, pts_gt, obs_kf, obs_mp, obs_uv = make_problem()
    rng = np.random.default_rng(1)
    n_kf = len(R_gt)
    # perturb
    R0 = R_gt.copy(); t0 = t_gt.copy()
    for k in range(2, n_kf):
        dR = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3).astype(np.float32))))
        R0[k] = dR @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.05, 3)
    pts0 = (pts_gt + rng.normal(0, 0.05, pts_gt.shape)).astype(np.float32)
    fixed = np.zeros(n_kf, bool); fixed[:2] = True

    mesh = sharded_ba.make_mesh()
    n_pts_pad, o_per, local_mp, obs_valid, outs = sharded_ba.partition_by_landmark(
        obs_mp, len(pts_gt), n_dev,
        {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[: len(pts0)] = pts0
    w = obs_valid.astype(np.float32)

    step = sharded_ba.make_sharded_ba_step(mesh, n_kf)
    R, t, pts = jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts_pad)
    for _ in range(8):
        R, t, pts = step(R, t, jnp.asarray(fixed), pts,
                         jnp.asarray(outs["kf"]), jnp.asarray(local_mp),
                         jnp.asarray(outs["uv"]), jnp.asarray(w),
                         jnp.asarray(K_CAM), jnp.asarray(1e-4, jnp.float32))
    Rn = np.asarray(R); tn = np.asarray(t)
    assert np.array_equal(Rn[:2], R0[:2])
    # unscramble the landmark permutation for comparison
    per = n_pts_pad // n_dev
    assert np.abs(Rn[2:] - R_gt[2:]).max() < 5e-3
    assert np.abs(tn[2:] - t_gt[2:]).max() < 3e-2
    # landmark improvement (shard s, local j) = global s*per + j... identity here
    # landmark error stays at/below the triangulation noise floor
    # (σ_z ≈ z²·σ_px/(f·b) ≈ 0.16 here — the perturbation 0.087 is *below* it,
    # so BA legitimately moves points toward the measurement-optimal solution)
    ptsn = np.asarray(pts)[: len(pts_gt)]
    err = np.linalg.norm(ptsn - pts_gt, axis=1)
    assert np.median(err) < 0.2, np.median(err)
    # and the reprojection residuals must have dropped substantially
    def total_reproj(Rm, tm, pm):
        e = 0.0
        for k in range(len(Rm)):
            pc = pm @ Rm[k].T + tm[k]
            uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376,
                           458 * pc[:, 1] / pc[:, 2] + 240], -1)
            sel = obs_kf == k
            e += np.sum((uv[obs_mp[sel]] - obs_uv[sel]) ** 2)
        return e
    assert total_reproj(Rn, tn, ptsn) < 0.2 * total_reproj(R0, t0, pts0)


def test_sharded_full_lm_matches_single_device_256kf():
    """The full distributed LM schedule (damping accept/reject + two-phase
    outlier gate) at reference problem scale (256 KFs) must match the
    single-device ops/ba.local_ba solve (VERDICT r1 #9)."""
    import functools
    from orbslam3_jax.ops import ba as ba_ops

    n_dev = len(jax.devices())
    n_kf, n_pts = 256, 1024
    R_gt, t_gt, pts_gt, obs_kf, obs_mp, obs_uv = make_problem(
        n_kf=n_kf, n_pts=n_pts, seed=3, loop=True)
    rng = np.random.default_rng(4)
    R0 = R_gt.copy(); t0 = t_gt.copy()
    for k in range(2, n_kf):
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32))))
        R0[k] = dR @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.03, 3)
    pts0 = (pts_gt + rng.normal(0, 0.03, pts_gt.shape)).astype(np.float32)
    fixed = np.zeros(n_kf, bool); fixed[:2] = True
    O = len(obs_kf)
    it1, it2 = 4, 4

    # single-device reference solve
    prob = ba_ops.BAProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), pts=jnp.asarray(pts0),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool), fixed_pose=jnp.asarray(fixed),
        obs_ur=jnp.full(O, -1.0, jnp.float32), bf=jnp.asarray(0.0, jnp.float32))
    ref = ba_ops.local_ba(prob, jnp.asarray(K_CAM), iters1=it1, iters2=it2)

    # sharded solve
    mesh = sharded_ba.make_mesh()
    n_pts_pad, o_per, local_mp, obs_valid_sh, outs = \
        sharded_ba.partition_by_landmark(obs_mp, n_pts, n_dev,
                                         {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[: n_pts] = pts0
    solver = sharded_ba.make_sharded_ba_solver(mesh, n_kf,
                                               iters1=it1, iters2=it2)
    R, t, pts, inl = solver(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(fixed),
        jnp.asarray(pts_pad), jnp.asarray(outs["kf"]), jnp.asarray(local_mp),
        jnp.asarray(outs["uv"]), jnp.asarray(obs_valid_sh.astype(np.float32)),
        jnp.asarray(K_CAM))

    # both reach the ground-truth basin; solutions agree closely (identical
    # schedules; tiny drift from summation order / damping tie-breaks)
    err_ref = np.abs(np.asarray(ref.t) - t_gt).max()
    err_sh = np.abs(np.asarray(t) - t_gt).max()
    assert err_sh < 0.02, err_sh
    assert abs(err_sh - err_ref) < 5e-3, (err_sh, err_ref)
    assert np.abs(np.asarray(t) - np.asarray(ref.t)).max() < 1e-2
    assert int(np.asarray(inl).sum()) > 0.9 * O
