"""Visual-inertial windowed optimization (sliding-window smoother).

Covers the pose/velocity/bias side of the reference's ``LocalInertialBA``
(reference src/Optimizer.cc:4314: temporal window of keyframes linked by
mPrevKF preintegration edges + visual reprojection edges, Huber kernels,
fixed boundary) and its frame-rate cousins ``PoseInertialOptimizationLast*``
(:7207/:7785): a GN smoother over K body poses, K velocities and a shared
gyro/acc bias, with

- visual residuals against *fixed* map landmarks (the landmark refinement
  itself is handled by the visual Schur BA in ops/ba.py — a joint
  landmark+inertial Schur solve is the round-2 extension),
- 9-dim preintegration residuals between consecutive keyframes, whitened by
  the preintegration covariance,
- bias priors (the reference's EdgePriorAcc/Gyro).

Jacobians come from autodiff of the packed parameter vector; the dense system
is ~(9K+6)² — tiny. Everything jits with static shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera as cam_ops
from . import imu as imu_ops
from . import lie


class VIBAResult(NamedTuple):
    R: jax.Array       # (K,3,3) world→cam
    t: jax.Array       # (K,3)
    vels: jax.Array    # (K,3)
    bg: jax.Array
    ba: jax.Array
    cost: jax.Array


def vi_window_optimize(
    R0, t0, vels0, bg0, ba0,
    pts_w, obs_kf, obs_uv, obs_inv_sigma2, obs_valid,
    dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pre_cov, pair_valid,
    cam_params, fixed_pose, cam_type: int = 0, iters: int = 8,
    huber_chi2: float = 5.991, prior_g: float = 1e2, prior_a: float = 1e5,
) -> VIBAResult:
    """Optimize K poses + velocities + shared bias.

    Shapes: poses (K,...); visual obs (O,) indexing pts_w (O,3) gathered per
    observation (landmarks fixed); inertial terms (K-1,...). fixed_pose: (K,)
    bool — fixed nodes contribute residuals but don't move (reference fixes
    the window boundary keyframe, src/Optimizer.cc:4375).
    """
    K = R0.shape[0]
    dtype = t0.dtype
    huber = jnp.sqrt(jnp.asarray(huber_chi2, dtype))

    C = pre_cov + 1e-10 * jnp.eye(9, dtype=dtype)
    L = jnp.linalg.cholesky(C)
    Linv = jax.vmap(lambda Lk: jax.scipy.linalg.solve_triangular(
        Lk, jnp.eye(9, dtype=dtype), lower=True))(L)

    n_pose = 6 * K
    n_vel = 3 * K

    def unpack(p):
        xi = p[:n_pose].reshape(K, 6)
        dRp, dtp = lie.se3_exp(xi)
        Rn, tn = lie.se3_compose(dRp, dtp, R0, t0)
        Rn = jnp.where(fixed_pose[:, None, None], R0, Rn)
        tn = jnp.where(fixed_pose[:, None], t0, tn)
        vels = p[n_pose:n_pose + n_vel].reshape(K, 3)
        bg = p[n_pose + n_vel: n_pose + n_vel + 3]
        ba = p[n_pose + n_vel + 3:]
        return Rn, tn, vels, bg, ba

    def residuals(p):
        Rn, tn, vels, bg, ba = unpack(p)
        # visual
        Rk = Rn[obs_kf]
        tk = tn[obs_kf]
        xc = jnp.einsum("oij,oj->oi", Rk, pts_w) + tk
        pos = xc[..., 2] > 1e-3
        xc = jnp.concatenate([xc[..., :2], jnp.maximum(xc[..., 2:3], 1e-2)], axis=-1)
        pred = cam_ops.project(cam_type, cam_params, xc)
        rv = (obs_uv - pred) * jnp.sqrt(obs_inv_sigma2)[:, None]
        chi = jnp.sum(rv * rv, axis=-1)
        w_h = jnp.sqrt(jnp.where(chi > huber * huber,
                                 huber / jnp.sqrt(chi + 1e-12), 1.0))
        rv = rv * (w_h * obs_valid.astype(dtype) * pos.astype(dtype))[:, None]

        # inertial: body = camera here (Tbc = I), body pose = inverse cam pose
        R_wb = jnp.swapaxes(Rn, -1, -2)
        p_wb = -jnp.einsum("kij,kj->ki", R_wb, tn)
        dbg = bg - bg0
        dba = ba - ba0
        dR_c = jnp.einsum("kij,kjl->kil", dR,
                          lie.so3_exp(jnp.einsum("kij,j->ki", JRg, dbg)))
        dV_c = dV + jnp.einsum("kij,j->ki", JVg, dbg) + jnp.einsum("kij,j->ki", JVa, dba)
        dP_c = dP + jnp.einsum("kij,j->ki", JPg, dbg) + jnp.einsum("kij,j->ki", JPa, dba)
        g = jnp.asarray([0.0, 0.0, -imu_ops.GRAVITY], dtype)
        R1 = R_wb[:-1]
        R2 = R_wb[1:]
        p1 = p_wb[:-1]
        p2 = p_wb[1:]
        v1 = vels[:-1]
        v2 = vels[1:]
        tt = dT[:, None]
        er = lie.so3_log(jnp.einsum("kij,kli,klm->kjm", dR_c, R1, R2))
        ev = jnp.einsum("kji,kj->ki", R1, v2 - v1 - g[None] * tt) - dV_c
        ep = jnp.einsum("kji,kj->ki", R1, p2 - p1 - v1 * tt - 0.5 * g[None] * tt * tt) - dP_c
        ri = jnp.concatenate([er, ev, ep], axis=-1)
        ri = jnp.einsum("kij,kj->ki", Linv, ri) * pair_valid[:, None].astype(dtype)

        # bias priors
        rb = jnp.concatenate([jnp.sqrt(jnp.asarray(prior_g, dtype)) * dbg,
                              jnp.sqrt(jnp.asarray(prior_a, dtype)) * dba])
        return jnp.concatenate([rv.reshape(-1), ri.reshape(-1), rb])

    n = n_pose + n_vel + 6
    p = jnp.concatenate([jnp.zeros(n_pose + 0, dtype),
                         vels0.reshape(-1), bg0, ba0])
    # parameters are DELTAS for poses but absolutes for vels/bias; rebuild the
    # packing so GN updates everything uniformly
    p = jnp.concatenate([jnp.zeros(n_pose, dtype), vels0.reshape(-1), bg0, ba0])

    def gn(carry, _):
        p, lam = carry
        r = residuals(p)
        J = jax.jacfwd(residuals)(p)
        H = J.T @ J + lam * jnp.eye(n, dtype=dtype)
        b = -J.T @ r
        dp = jnp.linalg.solve(H, b)
        p_new = p + dp
        good = jnp.sum(residuals(p_new) ** 2) < jnp.sum(r ** 2)
        p = jnp.where(good, p_new, p)
        lam = jnp.where(good, lam * 0.5, lam * 5.0)
        return (p, lam), jnp.sum(r ** 2)

    (p, _), costs = jax.lax.scan(gn, (p, jnp.asarray(1e-4, dtype)), None,
                                 length=iters)
    Rn, tn, vels, bg, ba = unpack(p)
    return VIBAResult(R=Rn, t=tn, vels=vels, bg=bg, ba=ba,
                      cost=jnp.sum(residuals(p) ** 2))


class PoseInertialResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    v: jax.Array
    inlier: jax.Array
    n_inliers: jax.Array
    H_marg: jax.Array = None      # (15,15) marginal info on (pose,vel,bias)
    prev_moved: jax.Array = None  # (15,) increment applied to the prev state
    bg: jax.Array = None          # (3,) current gyro bias
    ba: jax.Array = None          # (3,) current accel bias


def pose_inertial_optimize(
    R0, t0, v0, R1_wb, p1_wb, v1,
    bg, ba, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pre_cov,
    pts_w, obs_uv, obs_inv_sigma2, obs_valid, cam_params,
    cam_type: int = 0, iters: int = 12, chi2_th: float = 5.991,
    prior_H=None, sigma_gw: float = 1e-5, sigma_aw: float = 1e-4,
) -> PoseInertialResult:
    """Frame-rate visual-inertial pose optimization (reference
    PoseInertialOptimizationLastFrame src/Optimizer.cc:7785: current frame
    pose+velocity+BIASES against the previous 15-dim state through a
    preintegration edge + bias random-walk edges + visual mono edges; 4×10
    schedule with annealed chi2 gates {12, 7.5, 5.991, 5.991}).

    The previous body state (R1_wb (3,3), p1_wb, v1, biases at the passed
    bg/ba) enters as a VARIABLE held by the marginal prior ``prior_H``
    ((15,15) information on its [δθ, δp, δv, δbg, δba]) — the reference's
    ConstraintPoseImu carried between frames (src/Optimizer.cc:4956-5070
    Marginalize, include/G2oTypes.h:711: a 15-dim block, not 9). The
    preintegration edge is evaluated at the PREVIOUS frame's bias (its
    integration reference, reference EdgeInertial uses frame-1 bias
    vertices) via the first-order bias Jacobians; EdgeGyroRW/EdgeAccRW tie
    the two frames' biases with information 1/(dT·σ_walk²)
    (src/Optimizer.cc:7900-7928). With prior_H=None the previous state is
    fixed. The returned ``H_marg`` is the CURRENT state's 15×15 marginal
    information after Schur-eliminating the previous state — the next
    frame's prior.
    """
    dtype = t0.dtype
    huber = jnp.sqrt(jnp.asarray(chi2_th, dtype))
    C = pre_cov + jnp.diag(jnp.asarray([1e-8] * 3 + [1e-6] * 3 + [1e-7] * 3,
                                       dtype))
    L = jnp.linalg.cholesky(C)
    Linv = jax.scipy.linalg.solve_triangular(L, jnp.eye(9, dtype=dtype),
                                             lower=True)
    g = jnp.asarray([0.0, 0.0, -imu_ops.GRAVITY], dtype)

    use_prior = prior_H is not None
    # current [δpose(6), v(3), bg(3), ba(3)] (+ prev [δθ,δp,δv,δbg,δba])
    n_state = 30 if use_prior else 15
    # bias deltas are parametrized in units of the per-frame walk std
    # (sb = σ_walk·sqrt(dT)): the whitened RW residual becomes an O(1)
    # difference of parameters, and the marginal Hessian stays within f32
    # range — physical-unit bias columns carry ~1/(dT σ_w²) ≈ 1e12
    # information at EuRoC walk sigmas, which poisons the f32 prior
    # Cholesky. H_marg is carried between frames in these scaled
    # coordinates (frame dT is the steady camera period).
    sb_g = sigma_gw * jnp.sqrt(jnp.maximum(dT, 1e-3))
    sb_a = sigma_aw * jnp.sqrt(jnp.maximum(dT, 1e-3))

    def unpack(p):
        dRp, dtp = lie.se3_exp(p[:6])
        R, t = lie.se3_compose(dRp, dtp, R0, t0)
        bg2 = bg + sb_g * p[9:12]
        ba2 = ba + sb_a * p[12:15]
        if use_prior:
            # previous BODY state perturbed on its tangent: R1' = R1 Exp(δθ)
            R1n = R1_wb @ lie.so3_exp(p[15:18])
            p1n = p1_wb + p[18:21]
            v1n = v1 + p[21:24]
            bg1 = bg + sb_g * p[24:27]
            ba1 = ba + sb_a * p[27:30]
        else:
            R1n, p1n, v1n, bg1, ba1 = R1_wb, p1_wb, v1, bg, ba
        return R, t, p[6:9], bg2, ba2, R1n, p1n, v1n, bg1, ba1

    def residuals(p, w_in):
        R, t, v, bg2, ba2, R1n, p1n, v1n, bg1, ba1 = unpack(p)
        xc = jnp.einsum("ij,oj->oi", R, pts_w) + t
        pos = xc[..., 2] > 1e-3
        xc = jnp.concatenate([xc[..., :2],
                              jnp.maximum(xc[..., 2:3], 1e-2)], axis=-1)
        pred = cam_ops.project(cam_type, cam_params, xc)
        rv = (obs_uv - pred) * jnp.sqrt(obs_inv_sigma2)[:, None]
        chi = jnp.sum(rv * rv, axis=-1)
        w_h = jnp.sqrt(jnp.where(chi > huber * huber,
                                 huber / jnp.sqrt(chi + 1e-12), 1.0))
        rv = rv * (w_h * w_in * obs_valid.astype(dtype)
                   * pos.astype(dtype))[:, None]
        # inertial edge to the previous state, at the PREVIOUS frame's bias
        # (first-order corrected deltas; the passed dR/dV/dP are referenced
        # at the input bg/ba)
        dbg1 = bg1 - bg
        dba1 = ba1 - ba
        dR_c = dR @ lie.so3_exp(JRg @ dbg1)
        dV_c = dV + JVg @ dbg1 + JVa @ dba1
        dP_c = dP + JPg @ dbg1 + JPa @ dba1
        R_wb = R.T
        p_wb = -R.T @ t
        tt = dT
        er = lie.so3_log(dR_c.T @ (R1n.T @ R_wb))
        ev = R1n.T @ (v - v1n - g * tt) - dV_c
        ep = R1n.T @ (p_wb - p1n - v1n * tt - 0.5 * g * tt * tt) - dP_c
        ri = Linv @ jnp.concatenate([er, ev, ep])
        # bias random walk between the two frames (EdgeGyroRW/EdgeAccRW);
        # exactly whitened in the scaled parametrization
        if use_prior:
            r_rw = jnp.concatenate([p[9:12] - p[24:27], p[12:15] - p[27:30]])
        else:
            r_rw = jnp.concatenate([p[9:12], p[12:15]])
        out = [rv.reshape(-1), ri, r_rw]
        if use_prior:
            # ConstraintPoseImu: whitened prior residual on the previous
            # state's deviation from its marginal estimate
            Lp = jnp.linalg.cholesky(
                prior_H + 1e-6 * jnp.eye(15, dtype=dtype))
            out.append(Lp.T @ p[15:30])
        return jnp.concatenate(out)

    def chi2_of(p):
        R, t = unpack(p)[:2]
        xc = jnp.einsum("ij,oj->oi", R, pts_w) + t
        pos = xc[..., 2] > 1e-3
        xc = jnp.concatenate([xc[..., :2],
                              jnp.maximum(xc[..., 2:3], 1e-2)], axis=-1)
        pred = cam_ops.project(cam_type, cam_params, xc)
        rv = (obs_uv - pred)
        chi = jnp.sum(rv * rv, axis=-1) * obs_inv_sigma2
        return jnp.where(pos, chi, 1e9)

    schedule = jnp.asarray([12.0, 7.5, chi2_th, chi2_th], dtype)
    p = jnp.concatenate([jnp.zeros(6, dtype), v0,
                         jnp.zeros(n_state - 9, dtype)])
    inlier = jnp.ones(pts_w.shape[0], bool)

    def round_body(i, carry):
        p, inlier = carry
        w_in = inlier.astype(dtype)

        def gn(carry2, _):
            pp, lam = carry2
            r = residuals(pp, w_in)
            J = jax.jacfwd(lambda q: residuals(q, w_in))(pp)
            H = J.T @ J + lam * jnp.eye(n_state, dtype=dtype)
            b = -J.T @ r
            dp = jnp.linalg.solve(H, b)
            p_new = pp + dp
            good = jnp.sum(residuals(p_new, w_in) ** 2) < jnp.sum(r ** 2)
            pp = jnp.where(good, p_new, pp)
            lam = jnp.where(good, lam * 0.5, lam * 5.0)
            return (pp, lam), None

        (p, _), _ = jax.lax.scan(gn, (p, jnp.asarray(1e-4, dtype)), None,
                                 length=iters // 3)
        inlier = chi2_of(p) < schedule[i]
        return p, inlier

    p, inlier = jax.lax.fori_loop(0, 4, round_body, (p, inlier))
    inlier = inlier & obs_valid
    R, t, v, bg2, ba2 = unpack(p)[:5]
    # marginal information of the CURRENT 15-dim state: Schur-eliminate the
    # previous state from the final Hessian (reference Marginalize,
    # src/Optimizer.cc:4956-5070; the block is 15×15, include/G2oTypes.h:711)
    w_fin = (inlier & obs_valid).astype(dtype)
    Jf = jax.jacfwd(lambda q: residuals(q, w_fin))(p)
    Hf = Jf.T @ Jf
    if use_prior:
        Hcc = Hf[:15, :15]
        Hcp = Hf[:15, 15:]
        Hpp = Hf[15:, 15:] + 1e-6 * jnp.eye(15, dtype=dtype)
        H_marg = Hcc - Hcp @ jnp.linalg.solve(Hpp, Hcp.T)
        prev_moved = p[15:30]
    else:
        H_marg = Hf[:15, :15]
        prev_moved = jnp.zeros(15, dtype)
    return PoseInertialResult(
        R=R, t=t, v=v, inlier=inlier,
        n_inliers=jnp.sum(inlier.astype(jnp.int32)),
        H_marg=H_marg, prev_moved=prev_moved, bg=bg2, ba=ba2)


class VIJointResult(NamedTuple):
    R: jax.Array        # (K,3,3) world→cam
    t: jax.Array        # (K,3)
    vels: jax.Array     # (K,3)
    bg: jax.Array       # (K,3)
    ba: jax.Array       # (K,3)
    pts: jax.Array      # (P,3)
    obs_inlier: jax.Array
    cost: jax.Array


def vi_joint_ba(
    R0, t0, vels0, bg0, ba0, fixed_pose,
    pts0, obs_kf, obs_mp, obs_uv, obs_ur, obs_inv_sigma2, obs_valid, bf,
    dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pre_cov, pair_valid,
    cam_params, cam_type: int = 0, iters: int = 10,
    prior_g: float = 0.0, prior_a: float = 0.0,
    rw_gyro: float = 1e4, rw_acc: float = 1e3,
    fix_landmarks: bool = False, fix_vel_bias_of_fixed: bool = True,
) -> VIJointResult:
    """Joint landmark + pose/velocity/bias bundle adjustment.

    The reference's LocalInertialBA (src/Optimizer.cc:4314) and FullInertialBA
    (:495) as ONE Schur solve: landmarks (P,3) are eliminated against a dense
    per-keyframe state [δpose(6), vel(3), bg(3), ba(3)] (15K total — the
    reduced system is one dense Cholesky). Residuals:

    - visual mono/stereo rows (reference EdgeMono/EdgeStereo, G2oTypes.h:346)
      with Huber √5.991/√7.815 weights;
    - 9-dim preintegration rows between consecutive keyframes whitened by the
      preintegration covariance (EdgeInertial, :500), bias-corrected to first
      order via the stored Jacobians;
    - bias random-walk rows between consecutive keyframes (EdgeGyroRW/
      EdgeAccRW, :640) with information rw_*/dT;
    - optional bias priors on the FIRST keyframe (EdgePriorAcc/Gyro — the
      reference's bInit path at IMU initialization, :646-715).

    Pair i connects keyframe i → i+1 (pair_valid masks broken chains).
    fixed_pose keyframes keep their pose; with ``fix_vel_bias_of_fixed`` they
    also keep velocity+biases (the reference's LocalInertialBA window
    boundary fixes all four vertices, src/Optimizer.cc:4375), while the
    FullInertialBA-at-init use fixes only the pose and estimates the rest
    (:495 — biases held by priors instead; freezing a zero bias would pin
    the whole random-walk chain to the wrong value).
    """
    K = R0.shape[0]
    P = pts0.shape[0]
    dtype = t0.dtype
    hub_m = jnp.sqrt(jnp.asarray(5.991, dtype))
    hub_s = jnp.sqrt(jnp.asarray(7.815, dtype))
    hub_i = jnp.sqrt(jnp.asarray(16.92, dtype))   # 9-dof inertial (A.3)
    g_w = jnp.asarray([0.0, 0.0, -imu_ops.GRAVITY], dtype)
    NS = 15                                        # per-KF state width

    C = pre_cov + jnp.diag(jnp.asarray(
        [1e-8] * 3 + [1e-6] * 3 + [1e-7] * 3, dtype))
    L = jnp.linalg.cholesky(C)
    Linv = jax.vmap(lambda Lk: jax.scipy.linalg.solve_triangular(
        Lk, jnp.eye(9, dtype=dtype), lower=True))(L)

    has_ur = obs_ur >= 0
    w_stereo_row = jnp.concatenate(
        [jnp.ones((obs_uv.shape[0], 2), dtype), has_ur[:, None].astype(dtype)],
        axis=-1)

    def visual_linearize(R, t, pts, w_mask):
        Rk = R[obs_kf]
        tk = t[obs_kf]
        xw = pts[obs_mp]
        xc = jnp.einsum("oij,oj->oi", Rk, xw) + tk
        pos = xc[..., 2] > 1e-3
        xc = jnp.concatenate([xc[..., :2],
                              jnp.maximum(xc[..., 2:3], 1e-2)], axis=-1)
        pred = cam_ops.project(cam_type, cam_params, xc)
        Jproj = cam_ops.project_jac(cam_type, cam_params, xc)       # (O,2,3)
        # left-increment se3: d xc/d xi = [ -[xc]x | I ]
        Jse3 = jnp.concatenate([-lie.hat(xc), jnp.broadcast_to(
            jnp.eye(3, dtype=dtype), xc.shape[:-1] + (3, 3))], axis=-1)
        r_uv = obs_uv - pred
        z = xc[..., 2]
        bf_ = jnp.asarray(bf, dtype)
        ur_pred = pred[..., 0] - bf_ / z
        r_ur = jnp.where(has_ur, obs_ur - ur_pred, 0.0)
        Jur = Jproj[:, 0, :] + jnp.stack(
            [jnp.zeros_like(z), jnp.zeros_like(z), bf_ / (z * z)], axis=-1)
        r = jnp.concatenate([r_uv, r_ur[:, None]], axis=-1)          # (O,3)
        Jxc = jnp.concatenate([Jproj, Jur[:, None, :]], axis=1)      # (O,3,3)
        Jpose = jnp.einsum("oij,ojk->oik", Jxc, Jse3)                # (O,3,6)
        Jpt = jnp.einsum("oij,ojk->oik", Jxc, Rk)
        chi2 = jnp.sum(r * r * w_stereo_row, axis=-1) * obs_inv_sigma2
        chi2 = jnp.where(pos, chi2, 1e9)
        hub = jnp.where(has_ur, hub_s, hub_m)
        rn = jnp.sqrt(chi2 + 1e-12)
        w_h = jnp.where(rn <= hub, 1.0, hub / rn)
        w = w_mask * pos.astype(dtype) * obs_inv_sigma2 * w_h
        w_row = w[:, None] * w_stereo_row
        return chi2, w_row, Jpose, Jpt, r

    i1 = jnp.arange(K - 1)
    i2 = i1 + 1
    rw_w = jnp.concatenate([
        jnp.full((K - 1, 3), rw_gyro, dtype) / jnp.maximum(dT, 1e-3)[:, None],
        jnp.full((K - 1, 3), rw_acc, dtype) / jnp.maximum(dT, 1e-3)[:, None],
    ], axis=-1)

    def inertial_residual_pair(k, d30):
        """Whitened 9-dim preintegration residual for pair k with a 30-dim
        perturbation (state1 | state2) around the current linearization."""
        def split(d15, R, t, v, bg, ba):
            dRp, dtp = lie.se3_exp(d15[:6])
            Rn, tn = lie.se3_compose(dRp, dtp, R, t)
            return Rn, tn, v + d15[6:9], bg + d15[9:12], ba + d15[12:15]
        R1, t1, v1, bg1, ba1 = split(d30[:15], cur_R[i1[k]], cur_t[i1[k]],
                                     cur_v[i1[k]], cur_bg[i1[k]], cur_ba[i1[k]])
        R2, t2, v2, bg2, ba2 = split(d30[15:], cur_R[i2[k]], cur_t[i2[k]],
                                     cur_v[i2[k]], cur_bg[i2[k]], cur_ba[i2[k]])
        R1b = R1.T
        p1 = -R1.T @ t1
        R2b = R2.T
        p2 = -R2.T @ t2
        dbg = bg1 - bg0[i1[k]]
        dba = ba1 - ba0[i1[k]]
        dR_c = dR[k] @ lie.so3_exp(JRg[k] @ dbg)
        dV_c = dV[k] + JVg[k] @ dbg + JVa[k] @ dba
        dP_c = dP[k] + JPg[k] @ dbg + JPa[k] @ dba
        tt = dT[k]
        er = lie.so3_log(dR_c.T @ (R1b.T @ R2b))
        ev = R1b.T @ (v2 - v1 - g_w * tt) - dV_c
        ep = R1b.T @ (p2 - p1 - v1 * tt - 0.5 * g_w * tt * tt) - dP_c
        ri = Linv[k] @ jnp.concatenate([er, ev, ep])
        # bias random walk (6)
        rw = (jnp.concatenate([bg2 - bg1, ba2 - ba1])
              * jnp.sqrt(rw_w[k]))
        return jnp.concatenate([ri, rw]) * pair_valid[k].astype(dtype)

    def build_inertial(w_scale):
        z30 = jnp.zeros(30, dtype)
        res = jax.vmap(lambda k: inertial_residual_pair(k, z30))(i1)   # (K-1,15)
        Jp = jax.vmap(lambda k: jax.jacfwd(
            lambda d: inertial_residual_pair(k, d))(z30))(i1)          # (K-1,15,30)
        # robust (Huber) on the 9-dim preintegration part
        chi_i = jnp.sum(res[:, :9] ** 2, axis=-1)
        rn = jnp.sqrt(chi_i + 1e-12)
        w_h = jnp.where(rn <= hub_i, 1.0, hub_i / rn)
        w_rows = jnp.concatenate([
            jnp.broadcast_to(w_h[:, None], (K - 1, 9)),
            jnp.ones((K - 1, 6), dtype)], axis=-1) * w_scale
        return res, Jp, w_rows

    def assemble_and_solve(R, t, v, bg, ba, pts, w_mask, lam):
        chi2, w_row, Jpose, Jpt, r = visual_linearize(R, t, pts, w_mask)
        # landmark blocks
        All = jnp.einsum("oik,oi,oil->okl", Jpt, w_row, Jpt)
        Hll = jnp.zeros((P, 3, 3), dtype).at[obs_mp].add(All)
        bl = jnp.zeros((P, 3), dtype).at[obs_mp].add(
            jnp.einsum("oik,oi,oi->ok", Jpt, w_row, r))
        Bo = jnp.einsum("oik,oi,oil->okl", Jpose, w_row, Jpt)
        B = jnp.zeros((P, K, 6, 3), dtype).at[obs_mp, obs_kf].add(Bo)
        diagl = jnp.einsum("pii->pi", Hll)
        Hll_d = Hll + jax.vmap(jnp.diag)(lam * diagl + 1e-6)
        Hll_inv = jnp.linalg.inv(Hll_d)
        # visual pose blocks + Schur reduction onto poses
        App = jnp.einsum("oik,oi,oil->okl", Jpose, w_row, Jpose)
        Hpp = jnp.zeros((K, 6, 6), dtype).at[obs_kf].add(App)
        bp = jnp.zeros((K, 6), dtype).at[obs_kf].add(
            jnp.einsum("oik,oi,oi->ok", Jpose, w_row, r))
        Cm = jnp.einsum("pkil,plm->pkim", B, Hll_inv)
        S2 = jnp.einsum("pkim,pqjm->kiqj", Cm, B)
        bs = bp - jnp.einsum("pkim,pm->ki", Cm, bl)

        # dense joint system over (K*15)
        N = K * NS
        A = jnp.zeros((N, N), dtype)
        b = jnp.zeros(N, dtype)
        pose_idx = (jnp.arange(K)[:, None] * NS + jnp.arange(6)[None, :])
        Svis = -S2
        Svis = Svis.at[jnp.arange(K), :, jnp.arange(K), :].add(Hpp)
        A = A.at[pose_idx.reshape(-1)[:, None],
                 pose_idx.reshape(-1)[None, :]].add(
            Svis.transpose(0, 1, 2, 3).reshape(K * 6, K * 6))
        b = b.at[pose_idx.reshape(-1)].add(bs.reshape(-1))

        # inertial rows
        nonlocal cur_R, cur_t, cur_v, cur_bg, cur_ba
        cur_R, cur_t, cur_v, cur_bg, cur_ba = R, t, v, bg, ba
        res_i, Jp, w_rows = build_inertial(1.0)
        rows_idx = jnp.concatenate(
            [i1[:, None] * NS + jnp.arange(NS)[None, :],
             i2[:, None] * NS + jnp.arange(NS)[None, :]], axis=-1)  # (K-1,30)
        JtWJ = jnp.einsum("kri,kr,krj->kij", Jp, w_rows, Jp)        # (K-1,30,30)
        JtWr = jnp.einsum("kri,kr,kr->ki", Jp, w_rows, res_i)
        A = A.at[rows_idx[:, :, None], rows_idx[:, None, :]].add(JtWJ)
        b = b.at[rows_idx].add(-JtWr)

        # bias priors on the first keyframe (reference bInit)
        if prior_g > 0.0 or prior_a > 0.0:
            pg = jnp.asarray(prior_g, dtype)
            pa = jnp.asarray(prior_a, dtype)
            bidx = jnp.arange(9, 15)
            pw = jnp.concatenate([jnp.full(3, pg, dtype),
                                  jnp.full(3, pa, dtype)])
            A = A.at[bidx, bidx].add(pw)
            b = b.at[bidx].add(-pw * jnp.concatenate(
                [bg[0] - bg0[0], ba[0] - ba0[0]]))

        # damping + fixed-state gauge
        dA = jnp.diag(A)
        A = A + jnp.diag(lam * dA + 1e-6)
        if fix_vel_bias_of_fixed:
            free = jnp.repeat(~fixed_pose, NS)
        else:
            per = jnp.concatenate([jnp.zeros(6, bool), jnp.ones(9, bool)])
            free = (jnp.repeat(~fixed_pose, NS)
                    | jnp.tile(per, K))
        A = jnp.where(free[:, None] & free[None, :], A, 0.0)
        A = A + jnp.diag(jnp.where(free, 0.0, 1.0))
        bfree = jnp.where(free, b, 0.0)
        dx = jnp.linalg.solve(A, bfree).reshape(K, NS)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)

        dRp, dtp = lie.se3_exp(dx[:, :6])
        Rn, tn = lie.se3_compose(dRp, dtp, R, t)
        vn = v + dx[:, 6:9]
        bgn = bg + dx[:, 9:12]
        ban = ba + dx[:, 12:15]
        # landmark back-substitution
        dxp = dx[:, :6]
        if fix_landmarks:
            ptsn = pts
        else:
            dl = jnp.einsum("pij,pj->pi", Hll_inv,
                            bl - jnp.einsum("pkim,ki->pm", B, dxp))
            has_obs = jnp.zeros((P,), dtype).at[obs_mp].add(w_mask) > 0
            ptsn = jnp.where(has_obs[:, None], pts + dl, pts)
        return Rn, tn, vn, bgn, ban, ptsn

    def total_cost(R, t, v, bg, ba, pts, w_mask):
        chi2, w_row, _, _, _ = visual_linearize(R, t, pts, w_mask)
        d2 = 5.991
        cv = jnp.where(chi2 <= d2, chi2,
                       2.0 * jnp.sqrt(d2) * jnp.sqrt(chi2 + 1e-12) - d2)
        cv = jnp.sum(cv * w_mask)
        nonlocal cur_R, cur_t, cur_v, cur_bg, cur_ba
        cur_R, cur_t, cur_v, cur_bg, cur_ba = R, t, v, bg, ba
        res_i, _, w_rows = build_inertial(1.0)
        ci = jnp.sum(res_i * res_i * w_rows)
        return cv + ci

    cur_R, cur_t, cur_v, cur_bg, cur_ba = R0, t0, vels0, bg0, ba0
    w_mask = obs_valid.astype(dtype)

    def body(_, carry):
        R, t, v, bg, ba, pts, lam = carry
        out = assemble_and_solve(R, t, v, bg, ba, pts, w_mask, lam)
        Rn, tn, vn, bgn, ban, ptsn = out
        Rn = jnp.where(fixed_pose[:, None, None], R, Rn)
        tn = jnp.where(fixed_pose[:, None], t, tn)
        old = total_cost(R, t, v, bg, ba, pts, w_mask)
        new = total_cost(Rn, tn, vn, bgn, ban, ptsn, w_mask)
        good = new < old
        R = jnp.where(good, Rn, R)
        t = jnp.where(good, tn, t)
        v = jnp.where(good, vn, v)
        bg = jnp.where(good, bgn, bg)
        ba = jnp.where(good, ban, ba)
        pts = jnp.where(good, ptsn, pts)
        lam = jnp.where(good, lam * 0.5, lam * 4.0)
        return R, t, v, bg, ba, pts, lam

    R, t, v, bg, ba, pts, _ = jax.lax.fori_loop(
        0, iters, body,
        (R0, t0, vels0, bg0, ba0, pts0, jnp.asarray(1e-4, dtype)))
    chi2, _, _, _, _ = visual_linearize(R, t, pts, w_mask)
    inlier = (chi2 < jnp.where(has_ur, 7.815, 5.991)) & obs_valid
    cur_R, cur_t, cur_v, cur_bg, cur_ba = R, t, v, bg, ba
    return VIJointResult(R=R, t=t, vels=v, bg=bg, ba=ba, pts=pts,
                         obs_inlier=inlier,
                         cost=total_cost(R, t, v, bg, ba, pts, w_mask))
