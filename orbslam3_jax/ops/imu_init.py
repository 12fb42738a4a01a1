"""Inertial-only MAP optimization: gravity direction, scale, biases, velocities.

Rebuilds the reference ``Optimizer::InertialOptimization`` (reference
src/Optimizer.cc:5072: fixes all keyframe poses, optimizes VertexGDir (2-DoF
gravity rotation), VertexScale, shared gyro/acc biases and per-KF velocities
over ``EdgeInertialGS`` preintegration edges, 200 iterations) and the scale/
gravity application ``Map::ApplyScaledRotation`` used by the reference's
three-stage IMU initialization (src/LocalMapping.cc:1559 InitializeIMU).

Batched form: the residual is the 9-dim preintegration error (ops/imu) with
gravity rotated by Exp([a,b,0]) and positions scaled by exp(sigma); Jacobians
come from autodiff of the whole batched residual; a few dense GN steps on the
(4 + 6 + 3K)-dim parameter vector (tiny) run under jit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import imu as imu_ops
from . import lie


class InertialInitResult(NamedTuple):
    Rwg: jax.Array     # (3,3) gravity-alignment rotation (world' ← world)
    scale: jax.Array   # () map scale correction
    bg: jax.Array      # (3,)
    ba: jax.Array      # (3,)
    vels: jax.Array    # (K,3) body velocities in (unscaled) world frame
    cost: jax.Array


def _residuals(params, R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
               pair_valid, opt_scale, Rwg0):
    """params = [gx, gy, sigma, bg(3), ba(3), vels(K*3)]; Rwg = Rwg0·Exp([gx,gy,0])."""
    K = R_wb.shape[0]
    gx, gy, sigma = params[0], params[1], params[2]
    bg = params[3:6]
    ba = params[6:9]
    vels = params[9:].reshape(K, 3)
    s = jnp.exp(sigma) if opt_scale else jnp.asarray(1.0, params.dtype)
    Rwg = Rwg0 @ lie.so3_exp(jnp.stack([gx, gy, jnp.zeros_like(gx)]))
    g = Rwg @ jnp.asarray([0.0, 0.0, -imu_ops.GRAVITY], params.dtype)

    # bias-corrected deltas (first-order, reference EdgeInertialGS)
    dR_c = jnp.einsum("kij,kjl->kil", dR, lie.so3_exp(jnp.einsum("kij,j->ki", JRg, bg)))
    dV_c = dV + jnp.einsum("kij,j->ki", JVg, bg) + jnp.einsum("kij,j->ki", JVa, ba)
    dP_c = dP + jnp.einsum("kij,j->ki", JPg, bg) + jnp.einsum("kij,j->ki", JPa, ba)

    R1 = R_wb[:-1]
    R2 = R_wb[1:]
    p1 = p_wb[:-1] * s
    p2 = p_wb[1:] * s
    v1 = vels[:-1]
    v2 = vels[1:]
    t = dT[:, None]
    # er = Log(ΔR_cᵀ · R1ᵀ · R2)
    er = lie.so3_log(jnp.einsum("kij,kli,klm->kjm", dR_c, R1, R2))
    ev = jnp.einsum("kji,kj->ki", R1, v2 - v1 - g[None] * t) - dV_c
    ep = jnp.einsum("kji,kj->ki", R1, p2 - p1 - v1 * t - 0.5 * g[None] * t * t) - dP_c
    r = jnp.concatenate([er, ev, ep], axis=-1)   # (K-1, 9)
    return r


def _whiten(r, Linv):
    """Whiten 9-dim residuals with the Cholesky inverse of the preintegration
    covariance (reference edges use information = C⁻¹)."""
    return jnp.einsum("kij,kj->ki", Linv, r)


def inertial_init(
    R_wb: jax.Array, p_wb: jax.Array, dT: jax.Array, dR: jax.Array,
    dV: jax.Array, dP: jax.Array, JRg: jax.Array, JVg: jax.Array,
    JVa: jax.Array, JPg: jax.Array, JPa: jax.Array, pair_valid: jax.Array,
    cov: jax.Array | None = None,
    opt_scale: bool = True, iters: int = 30,
    prior_g: float = 1e2, prior_a: float = 1e6,
) -> InertialInitResult:
    """Solve for gravity/scale/biases/velocities given fixed KF body poses.

    Inputs: (K,...) keyframe body poses; (K-1,...) preintegration terms between
    consecutive keyframes; cov: optional (K-1,9,9) preintegration covariances
    used to whiten residuals (information = C⁻¹). prior_g/prior_a: bias priors
    (reference InitializeIMU priorG=1e2, priorA=1e10 mono / 1e5 stereo).
    """
    K = R_wb.shape[0]
    dtype = p_wb.dtype
    if cov is None:
        Linv = jnp.broadcast_to(jnp.eye(9, dtype=dtype), (K - 1, 9, 9))
    else:
        # visual-noise floor: the keyframe poses entering this solve carry
        # visual error far above the raw preintegration covariance; without a
        # floor the whitened objective is dominated by that noise and develops
        # a degenerate s→0 attractor (position terms vanish)
        floor = jnp.asarray([1e-4] * 3 + [2.5e-3] * 3 + [4e-4] * 3, dtype)
        C = cov + jnp.diag(floor)
        L = jnp.linalg.cholesky(C)
        Linv = jax.vmap(lambda Lk: jax.scipy.linalg.solve_triangular(
            Lk, jnp.eye(9, dtype=dtype), lower=True))(L)

    # ---- closed-form linear seed (gyro bias → scale/gravity/velocities) ----
    # The MAP objective has a degenerate s→0 attractor; the linear VI
    # initialization (Martinelli-style) finds the global optimum of the
    # linearized problem, from which GN converges to the right basin.
    pv = pair_valid.astype(dtype)
    R1 = R_wb[:-1]
    R2 = R_wb[1:]
    # 1) gyro bias from rotation alignment: er(bg) ≈ er0 − JRg·bg
    er0 = lie.so3_log(jnp.einsum("kij,kli,klm->kjm", dR, R1, R2))
    Ag = jnp.einsum("kij,kil,k->jl", JRg, JRg, pv) + 1e-6 * jnp.eye(3, dtype=dtype)
    bgv = jnp.einsum("kij,ki,k->j", JRg, er0, pv)
    bg_seed = jnp.linalg.solve(Ag, bgv)
    # 2) bias-corrected deltas at bg_seed (ba = 0)
    dV_c = dV + jnp.einsum("kij,j->ki", JVg, bg_seed)
    dP_c = dP + jnp.einsum("kij,j->ki", JPg, bg_seed)
    # 3) linear system in x = [s, g(3), v_0..v_{K-1}]:
    #    ev_i: R1ᵀ v_{i+1} − R1ᵀ v_i − t R1ᵀ g             = dV_c
    #    ep_i: s·R1ᵀ(p2−p1) − t R1ᵀ v_i − ½t² R1ᵀ g        = dP_c
    n_lin = 4 + 3 * K
    t_ = dT[:, None, None]
    R1T = jnp.swapaxes(R1, -1, -2)
    # whiten [ev; ep] rows with the lower-right 6×6 of Linv (block approx)
    W = Linv[:, 3:9, 3:9]
    Km1 = K - 1
    A = jnp.zeros((Km1, 6, n_lin), dtype)
    s_col = jnp.einsum("kij,kj->ki", R1T, p_wb[1:] - p_wb[:-1])
    if opt_scale:
        A = A.at[:, 3:6, 0].set(s_col)
    A = A.at[:, 0:3, 1:4].set(-t_ * R1T)
    A = A.at[:, 3:6, 1:4].set(-0.5 * t_ * t_ * R1T)
    idx = jnp.arange(Km1)
    # velocity block columns: v_i at 4+3i, v_{i+1} at 4+3(i+1)
    for r in range(3):
        for c in range(3):
            A = A.at[idx, r, 4 + 3 * idx + c].add(-R1T[:, r, c])
            A = A.at[idx, r, 4 + 3 * (idx + 1) + c].add(R1T[:, r, c])
            A = A.at[idx, 3 + r, 4 + 3 * idx + c].add(-dT * R1T[:, r, c])
    b_lin = jnp.concatenate([dV_c, dP_c], axis=-1)                 # (K-1,6)
    if not opt_scale:
        # s fixed at 1: move its column to the rhs
        b_lin = b_lin.at[:, 3:6].add(-s_col)
    Aw = jnp.einsum("kij,kjn->kin", W, A) * pv[:, None, None]
    bw = jnp.einsum("kij,kj->ki", W, b_lin) * pv[:, None]
    Am = Aw.reshape(-1, n_lin)
    bm = bw.reshape(-1)
    H = Am.T @ Am + 1e-8 * jnp.eye(n_lin, dtype=dtype)
    x = jnp.linalg.solve(H, Am.T @ bm)
    s_lin = jnp.where(opt_scale, x[0], 1.0)
    g_lin = x[1:4]
    v_lin = x[4:].reshape(K, 3)
    # gravity-alignment rotation from the linear g estimate
    dirG = g_lin / jnp.maximum(jnp.linalg.norm(g_lin), 1e-9)
    gI = jnp.asarray([0.0, 0.0, -1.0], dtype)
    axis = jnp.cross(gI, dirG)
    sin_n = jnp.linalg.norm(axis)
    ang = jnp.arctan2(sin_n, jnp.dot(gI, dirG))
    axis = jnp.where(sin_n > 1e-6, axis / jnp.maximum(sin_n, 1e-9),
                     jnp.asarray([1.0, 0.0, 0.0], dtype))
    Rwg0 = lie.so3_exp(axis * ang)

    def res_flat(p):
        r = _residuals(p, R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa,
                       JPg, JPa, pair_valid, opt_scale, Rwg0)
        return (_whiten(r, Linv) * pair_valid[:, None]).reshape(-1)

    sigma0 = jnp.where(opt_scale,
                       jnp.log(jnp.clip(s_lin, 1e-3, 1e3)),
                       jnp.zeros((), dtype))
    params0 = jnp.concatenate([
        jnp.zeros(2, dtype), sigma0[None], bg_seed,
        jnp.zeros(3, dtype), v_lin.reshape(-1)])

    n = params0.shape[0]
    prior = jnp.concatenate([
        jnp.zeros(2, dtype),
        jnp.zeros(1, dtype),
        jnp.full(3, prior_g, dtype),
        jnp.full(3, prior_a, dtype),
        jnp.zeros(3 * K, dtype)])

    def gn(carry, _):
        p, lam = carry
        r = res_flat(p)
        J = jax.jacfwd(res_flat)(p)
        H = J.T @ J + jnp.diag(prior) + lam * jnp.eye(n, dtype=dtype)
        b = -J.T @ r - prior * p
        dp = jnp.linalg.solve(H, b)
        p_new = p + dp
        good = jnp.sum(res_flat(p_new) ** 2) < jnp.sum(r ** 2)
        p = jnp.where(good, p_new, p)
        lam = jnp.where(good, lam * 0.5, lam * 5.0)
        return (p, lam), jnp.sum(r ** 2)

    (p, _), costs = jax.lax.scan(gn, (params0, jnp.asarray(1e-3, dtype)),
                                 None, length=iters)

    # one robust reweighting round: drop pairs whose whitened residual² is an
    # outlier (visual scale drift corrupts individual segments; the reference
    # gets the same effect from its Huber kernels on EdgeInertialGS)
    def pair_costs(p):
        r = _residuals(p, R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa,
                       JPg, JPa, pair_valid, opt_scale, Rwg0)
        return jnp.sum(_whiten(r, Linv) ** 2, axis=-1)

    pc = pair_costs(p)
    med = jnp.median(jnp.where(pair_valid, pc, jnp.nan))
    med = jnp.nan_to_num(med, nan=1e12)
    keep = pair_valid & (pc <= 5.0 * med)

    def res_flat2(p):
        r = _residuals(p, R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa,
                       JPg, JPa, pair_valid, opt_scale, Rwg0)
        return (_whiten(r, Linv) * keep[:, None]).reshape(-1)

    def gn2(carry, _):
        pp, lam = carry
        r = res_flat2(pp)
        J = jax.jacfwd(res_flat2)(pp)
        H = J.T @ J + jnp.diag(prior) + lam * jnp.eye(n, dtype=dtype)
        b = -J.T @ r - prior * pp
        dp = jnp.linalg.solve(H, b)
        p_new = pp + dp
        good = jnp.sum(res_flat2(p_new) ** 2) < jnp.sum(r ** 2)
        pp = jnp.where(good, p_new, pp)
        lam = jnp.where(good, lam * 0.5, lam * 5.0)
        return (pp, lam), jnp.sum(r ** 2)

    (p, _), costs2 = jax.lax.scan(gn2, (p, jnp.asarray(1e-3, dtype)),
                                  None, length=iters // 2)
    costs = jnp.concatenate([costs, costs2])
    Rwg = Rwg0 @ lie.so3_exp(jnp.stack([p[0], p[1], jnp.zeros_like(p[0])]))
    return InertialInitResult(
        Rwg=Rwg,
        scale=jnp.exp(p[2]) if opt_scale else jnp.asarray(1.0, dtype),
        bg=p[3:6], ba=p[6:9], vels=p[9:].reshape(K, 3),
        cost=jnp.sum(res_flat(p) ** 2),
    )


def apply_scaled_rotation(R_cw, t_cw, mp_xyz, Rgw: jax.Array, s: jax.Array):
    """Gravity-align + rescale the whole map in place (reference
    Map::ApplyScaledRotation src/Map.cc): world' = s · Rgw · world.

    R_cw/t_cw: (K,3,3),(K,3) camera poses; mp_xyz: (P,3).
    Returns transformed (R_cw', t_cw', mp_xyz').
    """
    R_new = jnp.einsum("kij,jl->kil", R_cw, jnp.swapaxes(Rgw, -1, -2))
    t_new = t_cw * s
    mp_new = s * jnp.einsum("ij,pj->pi", Rgw, mp_xyz)
    return R_new, t_new, mp_new
