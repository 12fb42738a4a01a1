"""Pose-only optimization (motion-only bundle adjustment).

Replaces the reference's g2o ``Optimizer::PoseOptimization`` (reference
src/Optimizer.cc:943: BlockSolver_6_3 + LinearSolverDense + Levenberg, 4
rounds x 10 iterations, chi2 outlier reclassification at 5.991 mono / 7.815
stereo between rounds, Huber delta sqrt(5.991)/sqrt(7.815)) with a
fixed-shape batched Levenberg-Marquardt on SE(3):

- mono residual r_i = uv_i − project(R x_i + t) (EdgeSE3ProjectXYZOnlyPose,
  reference include/OptimizableTypes.h:59);
- stereo residual adds the right-image column u_R = u − bf/z
  (EdgeStereoSE3ProjectXYZOnlyPose, reference include/G2oTypes.h EdgeStereo
  semantics) — observations with obs_ur < 0 are treated as monocular;
- information = invSigma2 of the keypoint octave; Huber IRLS; outliers
  toggled by chi2 between rounds branchlessly (the reference's setLevel(0|1)).

Everything is jit-compatible: `lax.fori_loop` outer rounds, fixed iteration
counts, no data-dependent shapes. Depths are sanitized so masked/behind-camera
entries cannot emit NaNs into the masked sums.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera as cam_ops
from . import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def solve6(H: jax.Array, b: jax.Array) -> jax.Array:
    """Unrolled 6x6 Cholesky solve (H SPD after LM damping).

    ``jnp.linalg.solve`` lowers a 6x6 system to XLA LU + two triangular
    solves — sequential mini-loops that cannot fuse with neighbors and
    dominate the per-iteration cost of the pose LM (the whole
    linearization is ~1k residual rows). This scalar-unrolled Cholesky is a
    pure elementwise graph (~130 flops) that XLA fuses into the surrounding
    iteration body.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


class PoseOptResult(NamedTuple):
    R: jax.Array          # (3,3)
    t: jax.Array          # (3,)
    inlier: jax.Array     # (N,) bool — final chi2 classification
    n_inliers: jax.Array  # () int32
    chi2: jax.Array       # () float32 total inlier chi2


def _build_normal_eq(R, t, pts_w, uv, obs_ur, bf, inv_sigma2, w_mask,
                     cam_type, cam_params, huber_mono, huber_stereo):
    """One linearization with mono+stereo rows: H (6,6), b (6,), chi2 (N,)."""
    xc = lie.se3_apply(R, t, pts_w)
    pos = xc[..., 2] > 1e-3
    # sanitize depth: masked-out / behind-camera entries would otherwise emit
    # inf/NaN Jacobians, and 0-weight × NaN = NaN still poisons the sums
    xc = jnp.concatenate([xc[..., :2], jnp.maximum(xc[..., 2:3], 1e-2)], axis=-1)
    pred = cam_ops.project(cam_type, cam_params, xc)
    r_uv = uv - pred                                                 # (N,2)
    Jproj = cam_ops.project_jac(cam_type, cam_params, xc)            # (N,2,3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xc.dtype), xc.shape[:-1] + (3, 3))
    Jse3 = jnp.concatenate([-lie.hat(xc), eye], axis=-1)             # (N,3,6)

    has_ur = obs_ur >= 0
    z = xc[..., 2]
    ur_pred = pred[..., 0] - bf / z
    r_ur = jnp.where(has_ur, obs_ur - ur_pred, 0.0)                  # (N,)
    # d ur_pred / d xc = Jproj[0] + [0, 0, bf/z²]
    Jur_xc = Jproj[:, 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), bf / (z * z)], axis=-1)
    r = jnp.concatenate([r_uv, r_ur[..., None]], axis=-1)            # (N,3)
    Jxc = jnp.concatenate([Jproj, Jur_xc[:, None, :]], axis=1)       # (N,3,3)
    J = jnp.einsum("nij,njk->nik", Jxc, Jse3)                        # (N,3,6)
    # zero the stereo row for mono observations
    row_w = jnp.concatenate(
        [jnp.ones_like(r_uv), has_ur[..., None].astype(r.dtype)], axis=-1)

    chi2 = jnp.sum(r * r * row_w, axis=-1) * inv_sigma2
    chi2 = jnp.where(pos, chi2, 1e9)  # behind-camera ⇒ never an inlier
    huber = jnp.where(has_ur, huber_stereo, huber_mono)
    rn = jnp.sqrt(chi2 + 1e-12)
    w_huber = jnp.where(rn <= huber, 1.0, huber / rn)
    w = w_mask * pos.astype(r.dtype) * inv_sigma2 * w_huber          # (N,)
    wr = w[:, None] * row_w
    H = jnp.einsum("nik,ni,nil->kl", J, wr, J)
    b = jnp.einsum("nik,ni,ni->k", J, wr, r)
    return H, b, chi2


def pose_optimize(
    R0: jax.Array, t0: jax.Array,
    pts_w: jax.Array, uv: jax.Array, inv_sigma2: jax.Array, valid: jax.Array,
    cam_params: jax.Array, cam_type: int = cam_ops.PINHOLE,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
    chi2_schedule: jax.Array | None = None,
    obs_ur: jax.Array | None = None, bf: jax.Array | float = 0.0,
    prior_R: jax.Array | None = None, prior_t: jax.Array | None = None,
    prior_eps: jax.Array | float = 0.0,
) -> PoseOptResult:
    """4x10 LM with between-round chi2 reclassification.

    pts_w: (N,3) world points; uv: (N,2) observations; valid: (N,) mask;
    obs_ur: optional (N,) right-image u (−1 ⇒ mono observation);
    chi2_schedule: optional (rounds,) per-round outlier gates (the inertial
    variants use annealed gates {12, 7.5, 5.991, 5.991}, reference
    src/Optimizer.cc:7493-7530); default = constant chi2_th. Stereo rows use
    gates scaled by CHI2_STEREO/CHI2_MONO.

    prior_R/prior_t/prior_eps: optional weak SE(3) prior anchored at a
    reference pose (typically the LAST FRAME's optimized pose, NOT the
    motion-model seed). The prior's information is scale-free: per-block
    Λ = prior_eps · tr(H_block at the seed)/3, so it is negligible along
    directions the observations constrain and becomes the curvature floor
    along near-null directions (frontal-plane scenes leave a lateral-
    translation+yaw valley; an extrapolated seed otherwise random-walks
    down it — the observed mono scale-drift runaway, scripts/diag_*.py).
    No reference counterpart (g2o PoseOptimization has no prior; the
    reference relies on real scenes' depth diversity).
    """
    dtype = pts_w.dtype
    if obs_ur is None:
        obs_ur = jnp.full(pts_w.shape[:1], -1.0, dtype)
    bf = jnp.asarray(bf, dtype)
    huber_m = jnp.sqrt(jnp.asarray(CHI2_MONO, dtype))
    huber_s = jnp.sqrt(jnp.asarray(CHI2_STEREO, dtype))
    if chi2_schedule is None:
        schedule = jnp.full((rounds,), chi2_th, dtype)
    else:
        schedule = jnp.asarray(chi2_schedule, dtype)
    has_ur = obs_ur >= 0
    gate_scale = jnp.where(has_ur, CHI2_STEREO / CHI2_MONO, 1.0)

    def nq(R, t, w_mask):
        return _build_normal_eq(R, t, pts_w, uv, obs_ur, bf, inv_sigma2,
                                w_mask, cam_type, cam_params, huber_m, huber_s)

    # --- weak anchored prior (see docstring) ---
    if prior_R is None:
        prior_R, prior_t = R0, t0
    prior_eps = jnp.asarray(prior_eps, dtype)
    H_seed, _, _ = nq(R0, t0, valid.astype(dtype))
    lam_rot = prior_eps * jnp.trace(H_seed[:3, :3]) / 3.0
    lam_t = prior_eps * jnp.trace(H_seed[3:, 3:]) / 3.0
    lam_diag = jnp.concatenate([jnp.full((3,), lam_rot, dtype),
                                jnp.full((3,), lam_t, dtype)])
    pRi, pti = lie.se3_inverse(prior_R, prior_t)

    def prior_err(R, t):
        # e0 = log(T ∘ T_prior⁻¹) in the left-increment tangent (update is
        # T ← Exp(δ)∘T, so de/dδ ≈ I for small e0)
        dRr, dtr = lie.se3_compose(R, t, pRi, pti)
        return lie.se3_log(dRr, dtr)

    def huber_cost(chi2, w_mask):
        # UNBOUNDED robust cost for the LM accept test — a capped cost
        # saturates when the initial pose is poor, blinding LM to real
        # improvements and locking the pose to the motion prediction
        d = jnp.where(has_ur, huber_s, huber_m)
        d2 = d * d
        rho = jnp.where(chi2 <= d2, chi2, 2.0 * d * jnp.sqrt(chi2 + 1e-12) - d2)
        # behind-camera sentinels (1e9) would dominate: cap only those
        rho = jnp.minimum(rho, 1e6)
        return jnp.sum(rho * w_mask)

    def nq_prior(R, t, w_mask):
        """Normal equations + robust cost with the prior folded in — computed
        ONCE per LM iteration (the accepted candidate's system is reused as
        the next iteration's linearization; the rejected one is discarded)."""
        H, b, chi2 = nq(R, t, w_mask)
        e0 = prior_err(R, t)
        Hp = H + jnp.diag(lam_diag)
        bp = b - lam_diag * e0
        cost = huber_cost(chi2, w_mask) + jnp.sum(lam_diag * e0 * e0)
        return Hp, bp, cost

    def lm_iters(R, t, w_mask):
        # early-exit LM: stop once the proposed step is numerically
        # immaterial (‖dx‖ < 1e-8 — far below any pose tolerance). The
        # reference runs all 10 g2o iterations; on device each iteration is a
        # sequential while-loop step of tiny kernels, so exiting at
        # convergence (typically 3-5 iterations from a motion-model seed)
        # directly cuts the frame-critical path.
        def cond(carry):
            i, R, t, lam, H, b, c, done = carry
            return (i < iters) & jnp.logical_not(done)

        def body(carry):
            i, R, t, lam, H, b, c, _ = carry
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6, dtype=dtype)
            dx = solve6(Hd, b)
            Rn_, tn_ = lie.se3_exp(dx)
            Rn, tn = lie.se3_compose(Rn_, tn_, R, t)
            Hn, bn, cn = nq_prior(Rn, tn, w_mask)
            good = cn < c
            R = jnp.where(good, Rn, R)
            t = jnp.where(good, tn, t)
            H = jnp.where(good, Hn, H)
            b = jnp.where(good, bn, b)
            c = jnp.where(good, cn, c)
            lam = jnp.where(good, lam * 0.5, lam * 4.0)
            done = jnp.sum(dx * dx) < 1e-16
            return i + 1, R, t, lam, H, b, c, done

        H0, b0, c0 = nq_prior(R, t, w_mask)
        _, R, t, _, _, _, _, _ = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(0, jnp.int32), R, t, jnp.asarray(1e-3, dtype),
             H0, b0, c0, jnp.asarray(False)))
        return R, t

    def round_body(i, carry):
        R, t, inlier = carry
        w_mask = (valid & inlier).astype(dtype)
        R, t = lm_iters(R, t, w_mask)
        _, _, chi2 = nq(R, t, jnp.ones_like(w_mask))
        inlier = chi2 < schedule[i] * gate_scale
        return R, t, inlier

    R, t, inlier = jax.lax.fori_loop(
        0, rounds, round_body, (R0, t0, jnp.ones(pts_w.shape[0], bool))
    )
    inlier = inlier & valid
    _, _, chi2 = nq(R, t, inlier.astype(dtype))
    return PoseOptResult(
        R=R, t=t, inlier=inlier,
        n_inliers=jnp.sum(inlier.astype(jnp.int32)),
        chi2=jnp.sum(jnp.where(inlier, chi2, 0.0)),
    )


def pose_optimize_multistart(
    R0: jax.Array, t0: jax.Array,
    pts_w: jax.Array, uv: jax.Array, inv_sigma2: jax.Array, valid: jax.Array,
    cam_params: jax.Array, cam_type: int = cam_ops.PINHOLE,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
    obs_ur: jax.Array | None = None, bf: jax.Array | float = 0.0,
    n_starts: int = 7, spread: float = 0.015,
) -> PoseOptResult:
    """Multi-start pose LM: vmapped optimization from the prior pose plus
    camera-frame translation perturbations (dominated by the viewing axis —
    the weakly observed direction), winner by robust Huber cost over ALL
    valid observations.

    Rationale (no reference counterpart — a batched robustification): the
    robust pose cost has spurious local minima displaced along the depth
    direction; a motion-model prediction that drifts into one gets locked in
    by the chi2 reclassification (observed drift-runaway on low-parallax
    sequences). Batched restarts run in the same dispatch and pick the
    global basin. The unmasked Huber total is comparable across starts
    (inlier sets differ; a masked total would reward aggressive censoring).
    """
    dtype = pts_w.dtype
    if obs_ur is None:
        obs_ur = jnp.full(pts_w.shape[:1], -1.0, dtype)
    # characteristic depth for perturbation scaling
    xc0 = lie.se3_apply(R0, t0, pts_w)
    z0 = jnp.where(valid & (xc0[..., 2] > 0), xc0[..., 2], jnp.nan)
    med_z = jnp.nan_to_num(jnp.nanmedian(z0), nan=1.0)
    dirs = jnp.asarray(
        [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
         [0.0, 0.0, 2.0], [0.0, 0.0, -2.0], [1.0, 0.0, 0.0],
         [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], dtype)[:n_starts]
    t0s = t0[None, :] + spread * med_z * dirs      # camera-frame shift: t' = t+δ

    def solve(tt):
        return pose_optimize(R0, tt, pts_w, uv, inv_sigma2, valid, cam_params,
                             cam_type=cam_type, rounds=rounds, iters=iters,
                             chi2_th=chi2_th, obs_ur=obs_ur, bf=bf)

    res = jax.vmap(solve)(t0s)

    huber_m = jnp.sqrt(jnp.asarray(CHI2_MONO, dtype))
    huber_s = jnp.sqrt(jnp.asarray(CHI2_STEREO, dtype))
    has_ur = obs_ur >= 0

    def total_cost(R, t):
        _, _, chi2 = _build_normal_eq(
            R, t, pts_w, uv, obs_ur, bf, inv_sigma2, valid.astype(dtype),
            cam_type, cam_params, huber_m, huber_s)
        d = jnp.where(has_ur, huber_s, huber_m)
        d2 = d * d
        rho = jnp.where(chi2 <= d2, chi2,
                        2.0 * d * jnp.sqrt(chi2 + 1e-12) - d2)
        rho = jnp.minimum(rho, 1e6)
        return jnp.sum(rho * valid.astype(dtype))

    costs = jax.vmap(total_cost)(res.R, res.t)
    best = jnp.argmin(costs)
    return PoseOptResult(
        R=res.R[best], t=res.t[best], inlier=res.inlier[best],
        n_inliers=res.n_inliers[best], chi2=res.chi2[best],
    )
