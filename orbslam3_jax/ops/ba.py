"""Bundle adjustment: Levenberg-Marquardt with block-sparse Schur complement.

Replaces g2o's ``BlockSolver_6_3`` + ``OptimizationAlgorithmLevenberg`` pipeline
(reference Thirdparty/g2o/g2o/core/block_solver.h:83-97) and the reference's
graph builders ``BundleAdjustment`` / ``LocalBundleAdjustment`` /
``GlobalBundleAdjustemnt`` (reference src/Optimizer.cc:65,:93,:1858) with a
fixed-shape, fully batched formulation:

- The problem is SoA arrays with static capacities + validity masks: K poses,
  P landmarks, O observations as (kf_idx, mp_idx, uv, invSigma2, valid).
- Each LM step scatters per-observation 6x6 / 3x3 / 6x3 blocks into dense
  tensors: Hpp (K,6,6) pose diagonal, Hll (P,3,3) landmark diagonal, and the
  cross tensor B (P,K,6,3). The reduced camera system
  S = Hpp − Σ_p B_p Hll_p⁻¹ B_pᵀ is one einsum → a (6K,6K) dense solve; the
  landmark back-substitution is a batched 3x3 solve. The sparse pointer-
  chasing Schur loop of g2o becomes dense batched matmul.
- Robustness: Huber IRLS (delta sqrt(5.991) mono / sqrt(7.815) stereo,
  reference src/Optimizer.cc:1978-1984) + the reference's two-phase
  optimize(5) → drop chi2 outliers → optimize(10) schedule
  (src/Optimizer.cc:2205-2270) via `local_ba`.
- Gauge/fixing: boolean `fixed_pose` mask (the reference fixes boundary
  keyframes, min 2, src/Optimizer.cc:1929-1964).

Capacities are compile-time constants; one compilation per (K,P,O) bucket.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera as cam_ops
from . import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

# Precision of the two Schur contractions, the solver's only large matmuls:
# HIGHEST (plain float32, as every other matmul here). On an H100 against the
# CPU backend, on a 256-keyframe loop where every keyframe sees 1024 points,
# HIGHEST moved the poses 6.3e-6 m (summation order alone moves them 7e-6 m)
# and HIGH (TF32) 1.95e-4 m, past a 1e-4 m bound, for 1.13x the iterations/s
# (up to 1.6x at K=256, P=4096). ORBSLAM3_BA_SCHUR_PRECISION
# (default|high|highest) overrides it for scripts/bench_ba_precision.py,
# which repeats that comparison.
SCHUR_PRECISION = jax.lax.Precision[
    os.environ.get("ORBSLAM3_BA_SCHUR_PRECISION", "highest").upper()]


class BAProblem(NamedTuple):
    R: jax.Array            # (K,3,3) world→cam rotations
    t: jax.Array            # (K,3)
    pts: jax.Array          # (P,3) world points
    obs_kf: jax.Array       # (O,) int32
    obs_mp: jax.Array       # (O,) int32
    obs_uv: jax.Array       # (O,2)
    obs_inv_sigma2: jax.Array  # (O,)
    obs_valid: jax.Array    # (O,) bool
    fixed_pose: jax.Array   # (K,) bool
    obs_ur: jax.Array = None   # (O,) right-image u; <0 ⇒ mono observation
    bf: jax.Array = 0.0        # baseline*fx (scalar)
    # two-camera rigs (reference EdgeSE3ProjectXYZToBody,
    # include/OptimizableTypes.h:89): observations with obs_cam=1 are seen by
    # the second camera at T_rl ∘ T_kf with its own intrinsics
    obs_cam: jax.Array = None      # (O,) int32 0=primary, 1=second camera
    cam_params2: jax.Array = None  # second camera intrinsics
    R_rl: jax.Array = None         # (3,3) right←left rig rotation
    t_rl: jax.Array = None         # (3,)


class BAResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    pts: jax.Array
    obs_inlier: jax.Array   # (O,) bool final chi2 classification
    chi2: jax.Array         # () float — robust total on valid+inlier obs
    n_inlier: jax.Array


def inv3(M: jax.Array) -> jax.Array:
    """Batched closed-form (adjugate) 3x3 inverse: a pure elementwise graph
    that XLA fuses, where jnp.linalg.inv lowers each (3,3) landmark block to
    an LU loop."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = jnp.stack([jnp.stack([A, D, G], -1),
                     jnp.stack([B, E, H], -1),
                     jnp.stack([C, F, I], -1)], -2)
    return adj / det[..., None, None]


def _obs_ur(p: BAProblem, dtype):
    if p.obs_ur is None:
        return jnp.full(p.obs_kf.shape, -1.0, dtype)
    return p.obs_ur


def _linearize(p: BAProblem, pts, R, t, w_mask, cam_type, cam_params, huber):
    """Return (chi2 (O,), w_row (O,3), Jpose (O,3,6), Jpt (O,3,3), r (O,3)).

    Row 3 is the stereo right-column residual u_R = u − bf/z (reference
    EdgeStereoSE3ProjectXYZ); zero-weighted for mono observations (obs_ur<0).
    """
    Rk = R[p.obs_kf]
    tk = t[p.obs_kf]
    xw = pts[p.obs_mp]
    xc_l = jnp.einsum("oij,oj->oi", Rk, xw) + tk
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xc_l.dtype),
                           xc_l.shape[:-1] + (3, 3))
    # se3 perturbation acts on the PRIMARY camera frame; chain through the
    # rig transform for second-camera observations (reference
    # EdgeSE3ProjectXYZToBody, include/OptimizableTypes.h:89)
    Jse3_l = jnp.concatenate([-lie.hat(xc_l), eye], axis=-1)            # (O,3,6)
    if p.obs_cam is not None:
        is2 = (p.obs_cam == 1)[:, None]
        xc = jnp.where(is2, jnp.einsum("ij,oj->oi", p.R_rl, xc_l) + p.t_rl,
                       xc_l)
        Jse3 = jnp.where(is2[..., None],
                         jnp.einsum("ij,ojk->oik", p.R_rl, Jse3_l), Jse3_l)
        Rk = jnp.where(is2[..., None], jnp.einsum("ij,ojk->oik", p.R_rl, Rk),
                       Rk)
    else:
        xc = xc_l
        Jse3 = Jse3_l
    # sanitize depth (inf/NaN Jacobians would poison the scatter sums even at
    # zero weight); the pos mask downstream zeroes these residuals
    pos = xc[..., 2] > 1e-3
    xc = jnp.concatenate([xc[..., :2], jnp.maximum(xc[..., 2:3], 1e-2)], axis=-1)
    if p.obs_cam is not None:
        pred1 = cam_ops.project(cam_type, cam_params, xc)
        pred2 = cam_ops.project(cam_type, p.cam_params2, xc)
        pred = jnp.where((p.obs_cam == 1)[:, None], pred2, pred1)
        Jp1 = cam_ops.project_jac(cam_type, cam_params, xc)
        Jp2 = cam_ops.project_jac(cam_type, p.cam_params2, xc)
        Jproj = jnp.where((p.obs_cam == 1)[:, None, None], Jp2, Jp1)
    else:
        pred = cam_ops.project(cam_type, cam_params, xc)
        Jproj = cam_ops.project_jac(cam_type, cam_params, xc)           # (O,2,3)
    r_uv = p.obs_uv - pred

    obs_ur = _obs_ur(p, xc.dtype)
    has_ur = obs_ur >= 0
    z = xc[..., 2]
    bf = jnp.asarray(p.bf, xc.dtype)
    ur_pred = pred[..., 0] - bf / z
    r_ur = jnp.where(has_ur, obs_ur - ur_pred, 0.0)
    Jur_xc = Jproj[:, 0, :] + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), bf / (z * z)], axis=-1)
    r = jnp.concatenate([r_uv, r_ur[..., None]], axis=-1)               # (O,3)
    Jxc = jnp.concatenate([Jproj, Jur_xc[:, None, :]], axis=1)          # (O,3,3)
    # J = +dpred/dx so that JᵀWJ dx = JᵀW r with r = obs − pred (see pose_opt).
    Jpose = jnp.einsum("oij,ojk->oik", Jxc, Jse3)                       # (O,3,6)
    Jpt = jnp.einsum("oij,ojk->oik", Jxc, Rk)                           # (O,3,3)
    row_w = jnp.concatenate(
        [jnp.ones_like(r_uv), has_ur[..., None].astype(r.dtype)], axis=-1)

    chi2 = jnp.sum(r * r * row_w, axis=-1) * p.obs_inv_sigma2
    chi2 = jnp.where(pos, chi2, 1e9)  # behind-camera ⇒ never an inlier
    huber_eff = jnp.where(has_ur, huber * jnp.sqrt(CHI2_STEREO / CHI2_MONO), huber)
    rn = jnp.sqrt(chi2 + 1e-12)
    w_huber = jnp.where(rn <= huber_eff, 1.0, huber_eff / rn)
    w = w_mask * pos.astype(xc.dtype) * p.obs_inv_sigma2 * w_huber
    w_row = w[:, None] * row_w                                          # (O,3)
    return chi2, w_row, Jpose, Jpt, r


def _robust_cost_elems(chi2, w_mask, huber):
    """Per-observation Huber cost (for LM accept/reject)."""
    d2 = huber * huber
    cost = jnp.where(chi2 <= d2, chi2, 2.0 * huber * jnp.sqrt(chi2 + 1e-12) - d2)
    return cost * w_mask


def _robust_cost(chi2, w_mask, huber):
    """Total Huber cost (for LM accept/reject)."""
    return jnp.sum(_robust_cost_elems(chi2, w_mask, huber))


def _gn_step(p: BAProblem, pts, R, t, w_mask, lam, cam_type, cam_params, huber):
    lin = _linearize(p, pts, R, t, w_mask, cam_type, cam_params, huber)
    return _gn_step_from_lin(p, pts, R, t, lin, lam)


def _gn_step_from_lin(p: BAProblem, pts, R, t, lin, lam):
    """One damped Schur step from a PRECOMPUTED linearization (the LM loop
    reuses the accepted candidate's linearization as the next iteration's —
    one `_linearize` per iteration instead of three)."""
    K = p.R.shape[0]
    P = p.pts.shape[0]
    dtype = pts.dtype
    chi2, w, Jpose, Jpt, r = lin

    # block accumulations (scatter-add over observations); w is per-row (O,3)
    App = jnp.einsum("oik,oi,oil->okl", Jpose, w, Jpose)                # (O,6,6)
    Hpp = jnp.zeros((K, 6, 6), dtype).at[p.obs_kf].add(App)
    bp = jnp.zeros((K, 6), dtype).at[p.obs_kf].add(
        jnp.einsum("oik,oi,oi->ok", Jpose, w, r))
    All = jnp.einsum("oik,oi,oil->okl", Jpt, w, Jpt)
    Hll = jnp.zeros((P, 3, 3), dtype).at[p.obs_mp].add(All)
    bl = jnp.zeros((P, 3), dtype).at[p.obs_mp].add(
        jnp.einsum("oik,oi,oi->ok", Jpt, w, r))
    Bo = jnp.einsum("oik,oi,oil->okl", Jpose, w, Jpt)                   # (O,6,3)
    B = jnp.zeros((P, K, 6, 3), dtype).at[p.obs_mp, p.obs_kf].add(Bo)

    # landmark damping + guard for unobserved points
    diagl = jnp.einsum("pii->pi", Hll)
    Hll = Hll + jax.vmap(jnp.diag)(lam * diagl + 1e-6)
    Hll_inv = inv3(Hll)

    # Schur: S = Hpp - sum_p B_p Hll_p^-1 B_p^T  (batched einsum), at
    # SCHUR_PRECISION (see its definition)
    C = jnp.einsum("pkil,plm->pkim", B, Hll_inv,
                   precision=SCHUR_PRECISION)                           # (P,K,6,3)
    S2 = jnp.einsum("pkim,pqjm->kiqj", C, B,
                    precision=SCHUR_PRECISION)                          # (K,6,K,6)
    S = -S2
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hpp)
    bs = bp - jnp.einsum("pkim,pm->ki", C, bl)

    # pose damping + fixed-pose gauge handling
    Sm = S.reshape(K * 6, K * 6)
    dS = jnp.diag(Sm)
    Sm = Sm + jnp.diag(lam * dS + 1e-6)
    free = jnp.repeat(~p.fixed_pose, 6)
    Sm = jnp.where(free[:, None] & free[None, :], Sm, 0.0)
    Sm = Sm + jnp.diag(jnp.where(free, 0.0, 1.0))
    bs_flat = jnp.where(free, bs.reshape(-1), 0.0)

    cho = jax.scipy.linalg.cho_factor(Sm)
    dx0 = jax.scipy.linalg.cho_solve(cho, bs_flat)
    if K >= 64:
        # one iterative-refinement pass: the f32 Cholesky solve carries
        # ~1e-3 relative error at the conditioning of dense-covisibility
        # problems (cond ~1e12 at 256 KFs); the residual re-solve cuts it
        # ~1e3x for one extra matvec + triangular solve. Small local-BA
        # windows don't need it (cond ~1e6) and the extra f32 matvec noise
        # measurably perturbs their steps — large-K only.
        dx0 = dx0 + jax.scipy.linalg.cho_solve(cho, bs_flat - Sm @ dx0)
    dx = dx0.reshape(K, 6)
    # landmark back-substitution
    dl = jnp.einsum("pij,pj->pi", Hll_inv, bl - jnp.einsum("pkim,ki->pm", B, dx))

    dR, dt = lie.se3_exp(dx)
    Rn, tn = lie.se3_compose(dR, dt, R, t)
    Rn = jnp.where(p.fixed_pose[:, None, None], R, Rn)
    tn = jnp.where(p.fixed_pose[:, None], t, tn)
    # only move points that actually have (weighted) observations
    has_obs = jnp.zeros((P,), dtype).at[p.obs_mp].add(jnp.sum(w, -1)) > 0
    ptsn = jnp.where(has_obs[:, None], pts + dl, pts)
    return Rn, tn, ptsn


def ba_iterate(
    p: BAProblem, n_iters: int, inlier: jax.Array,
    cam_params: jax.Array, cam_type: int = cam_ops.PINHOLE,
    huber_chi2: float = CHI2_MONO,
):
    """Run n_iters LM iterations with the given inlier mask. Returns (R, t, pts).

    ONE linearization per iteration: the candidate's linearization doubles as
    its acceptance cost and, when accepted, as the next step's system (g2o
    evaluates the error once per iteration too)."""
    dtype = p.pts.dtype
    huber = jnp.sqrt(jnp.asarray(huber_chi2, dtype))
    w_mask = (p.obs_valid & inlier).astype(dtype)

    def lin_at(pts, R, t):
        return _linearize(p, pts, R, t, w_mask, cam_type, cam_params, huber)

    def body(_, carry):
        R, t, pts, lam, cost_e, lin = carry
        Rn, tn, ptsn = _gn_step_from_lin(p, pts, R, t, lin, lam)
        lin_n = lin_at(ptsn, Rn, tn)
        cost_en = _robust_cost_elems(lin_n[0], w_mask, huber)
        # accept on the SUM OF PER-OBSERVATION DIFFERENCES, not on two
        # near-equal totals: near convergence the improvement is far below
        # the f32 ulp of the total (~0.016 at a 1e5 cost), so total-vs-total
        # comparison becomes a coin flip and the solution random-walks;
        # differencing first cancels the common magnitude exactly. The
        # relative-improvement floor (LM function tolerance) stops noise-
        # level churn: without it the solver keeps accepting ~1e-7-relative
        # "improvements" that overfit visual noise along weak directions.
        good = (jnp.sum(cost_en - cost_e)
                < -1e-6 * jnp.maximum(jnp.sum(cost_e), 1.0))
        sel = lambda a, b: jnp.where(good, a, b)
        R = sel(Rn, R)
        t = sel(tn, t)
        pts = sel(ptsn, pts)
        cost_e = sel(cost_en, cost_e)
        lin = jax.tree_util.tree_map(sel, lin_n, lin)
        lam = jnp.where(good, lam * 0.5, lam * 4.0)
        return R, t, pts, lam, cost_e, lin

    lin0 = lin_at(p.pts, p.R, p.t)
    cost_e0 = _robust_cost_elems(lin0[0], w_mask, huber)
    R, t, pts, _, _, _ = jax.lax.fori_loop(
        0, n_iters, body,
        (p.R, p.t, p.pts, jnp.asarray(1e-4, dtype), cost_e0, lin0)
    )
    return R, t, pts


def classify_inliers(p: BAProblem, cam_params: jax.Array,
                     cam_type: int = cam_ops.PINHOLE,
                     chi2_th: float = CHI2_MONO):
    """Chi2 classification at the problem's current state (the between-phase
    reclassification of reference LocalBundleAdjustment
    src/Optimizer.cc:2205-2270, exposed for the chunked host-driven
    schedule). Returns (inlier (O,), chi2 (O,))."""
    chi2, _, _, _, _ = _linearize(
        p, p.pts, p.R, p.t, p.obs_valid.astype(p.pts.dtype), cam_type,
        cam_params, jnp.sqrt(jnp.asarray(chi2_th, p.pts.dtype)))
    return (chi2 < chi2_th) & p.obs_valid, chi2


def local_ba(
    p: BAProblem, cam_params: jax.Array, cam_type: int = cam_ops.PINHOLE,
    chi2_th: float = CHI2_MONO, iters1: int = 5, iters2: int = 10,
) -> BAResult:
    """Two-phase local BA (reference LocalBundleAdjustment src/Optimizer.cc:2205-2270:
    optimize(5), reclassify chi2 outliers, optimize(10), final classification)."""
    ones = jnp.ones(p.obs_kf.shape[0], bool)
    R, t, pts = ba_iterate(p, iters1, ones, cam_params, cam_type, chi2_th)
    p1 = p._replace(R=R, t=t, pts=pts)
    chi2, _, _, _, _ = _linearize(
        p1, pts, R, t, p.obs_valid.astype(pts.dtype), cam_type, cam_params,
        jnp.sqrt(jnp.asarray(chi2_th, pts.dtype)))
    inlier = chi2 < chi2_th
    R, t, pts = ba_iterate(p1, iters2, inlier, cam_params, cam_type, chi2_th)
    p2 = p1._replace(R=R, t=t, pts=pts)
    chi2, _, _, _, _ = _linearize(
        p2, pts, R, t, p.obs_valid.astype(pts.dtype), cam_type, cam_params,
        jnp.sqrt(jnp.asarray(chi2_th, pts.dtype)))
    inlier = (chi2 < chi2_th) & p.obs_valid
    return BAResult(
        R=R, t=t, pts=pts, obs_inlier=inlier,
        chi2=jnp.sum(jnp.where(inlier, chi2, 0.0)),
        n_inlier=jnp.sum(inlier.astype(jnp.int32)),
    )
