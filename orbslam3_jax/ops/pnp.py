"""Batched PnP RANSAC for relocalization.

Replaces the reference's ``MLPnPsolver`` (reference src/MLPnPsolver.cpp:
maximum-likelihood PnP on bearing vectors + RANSAC, used for relocalization at
src/Tracking.cc:4178-4264 with 6-point models) with a batched
formulation: every RANSAC hypothesis solves a 6-point linear PnP (DLT on the
3x4 projection matrix via a 12x12 eigendecomposition) **in one batch**, is
orthonormalized onto SE(3), and scored by reprojection chi2 against all
matches at once. Bearing-vector (normalized-coordinate) formulation keeps it
camera-model agnostic like MLPnP — fisheye rays work unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class PnPResult(NamedTuple):
    success: jax.Array
    R: jax.Array
    t: jax.Array
    inliers: jax.Array
    n_inliers: jax.Array


def _dlt_pnp(xw: jax.Array, xn: jax.Array):
    """Batched 6-point DLT: xw (B,6,3) world, xn (B,6,2) normalized image.
    Returns (R (B,3,3), t (B,3)) projected onto SE(3)."""
    B, n, _ = xw.shape
    ones = jnp.ones((B, n, 1), xw.dtype)
    Xh = jnp.concatenate([xw, ones], axis=-1)            # (B,6,4)
    zeros = jnp.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    r1 = jnp.concatenate([Xh, zeros, -u * Xh], axis=-1)  # (B,6,12)
    r2 = jnp.concatenate([zeros, Xh, -v * Xh], axis=-1)
    A = jnp.concatenate([r1, r2], axis=1)                # (B,12,12)
    AtA = jnp.einsum("bni,bnj->bij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    P = vecs[..., :, 0].reshape(B, 3, 4)
    M = P[:, :, :3]
    # sign: points should be in front (positive depth for the centroid)
    cen = jnp.mean(Xh, axis=1)
    depth = jnp.einsum("bij,bj->bi", P, cen)[:, 2]
    P = P * jnp.where(depth < 0, -1.0, 1.0)[:, None, None]
    M = P[:, :, :3]
    # orthonormalize M → R via SVD; scale = mean singular value
    uS, sS, vtS = jnp.linalg.svd(M)
    det = jnp.linalg.det(uS @ vtS)
    fix = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = (uS * fix[:, None, :]) @ vtS
    scale = jnp.mean(sS * fix, axis=-1)
    t = P[:, :, 3] / jnp.maximum(scale, 1e-12)[:, None]
    return R, t


def _control_points(xw: jax.Array):
    """EPnP control points via PCA (reference src/PnPsolver.cc
    choose_control_points): centroid + principal axes scaled by the
    per-axis std. xw: (B,n,3) → (B,4,3)."""
    c0 = jnp.mean(xw, axis=1)                              # (B,3)
    d = xw - c0[:, None]
    cov = jnp.einsum("bni,bnj->bij", d, d) / xw.shape[1]
    w, v = jnp.linalg.eigh(cov)                            # ascending
    std = jnp.sqrt(jnp.maximum(w, 1e-12))
    # floor the smallest axes relative to the largest: for (near-)planar point
    # sets the PCA basis is otherwise singular and the barycentric solve
    # returns NaN poses (ADVICE r1; epnp_ransac was safe, direct epnp not)
    std = jnp.maximum(std, 1e-3 * std[..., -1:])
    ax = v.transpose(0, 2, 1) * std[..., None]
    return jnp.concatenate([c0[:, None], c0[:, None] + ax], axis=1)


def _barycentric(xw: jax.Array, C: jax.Array):
    """alphas (B,n,4) s.t. xw = Σ_j a_j C_j, Σ a_j = 1 (compute_barycentric
    coordinates in the reference)."""
    M = (C[:, 1:] - C[:, :1]).transpose(0, 2, 1)           # (B,3,3)
    rhs = (xw - C[:, :1]).transpose(0, 2, 1)               # (B,3,n)
    a123 = jnp.linalg.solve(M, rhs).transpose(0, 2, 1)     # (B,n,3)
    a0 = 1.0 - jnp.sum(a123, axis=-1, keepdims=True)
    return jnp.concatenate([a0, a123], axis=-1)


_CP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def epnp(xw: jax.Array, xn: jax.Array, n_gn: int = 10):
    """Batched EPnP (reference src/PnPsolver.cc compute_pose): xw (B,n,3)
    world points, xn (B,n,2) normalized image coords → (R (B,3,3), t (B,3)).

    Express points barycentrically in 4 control points, solve MᵀM's null
    space, Gauss-Newton the 4 betas on the 6 control-point distance
    constraints (the reference's gauss_newton over its betas_approx seeds),
    then Horn-align world→camera control points."""
    B, n, _ = xw.shape
    C = _control_points(xw)
    alph = _barycentric(xw, C)                             # (B,n,4)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    z3 = jnp.zeros((B, n, 1), xw.dtype)
    one = jnp.ones((B, n, 1), xw.dtype)
    # rows: Σ_j a_j (xc_j - u zc_j) = 0 and Σ_j a_j (yc_j - v zc_j) = 0,
    # unknown X = [c1x c1y c1z ... c4x c4y c4z] (12)
    r1 = jnp.concatenate(
        [alph[..., j:j + 1] * jnp.concatenate([one, z3, -u], -1)
         for j in range(4)], axis=-1)                      # (B,n,12)
    r2 = jnp.concatenate(
        [alph[..., j:j + 1] * jnp.concatenate([z3, one, -v], -1)
         for j in range(4)], axis=-1)
    M = jnp.concatenate([r1, r2], axis=1)                  # (B,2n,12)
    MtM = jnp.einsum("bni,bnj->bij", M, M)
    _, vecs = jnp.linalg.eigh(MtM)
    V = vecs[..., :4].transpose(0, 2, 1).reshape(B, 4, 4, 3)  # 4 null vecs
    ii = jnp.asarray([p[0] for p in _CP_PAIRS])
    jj = jnp.asarray([p[1] for p in _CP_PAIRS])
    dV = V[:, :, ii] - V[:, :, jj]                         # (B,4,6,3)
    dw = C[:, ii] - C[:, jj]                               # (B,6,3)
    d2w = jnp.sum(dw * dw, axis=-1)                        # (B,6)
    # seed: betas_approx_1 — scale of the dominant null vector
    nv0 = jnp.sum(dV[:, 0] * dV[:, 0], axis=-1)            # (B,6)
    b0 = jnp.sum(jnp.sqrt(nv0 * d2w), -1) / jnp.maximum(jnp.sum(nv0, -1), 1e-12)
    betas = jnp.stack([b0, jnp.zeros_like(b0), jnp.zeros_like(b0),
                       jnp.zeros_like(b0)], axis=-1)       # (B,4)

    def gn_step(b, _):
        dc = jnp.einsum("bk,bkps->bps", b, dV)             # (B,6,3)
        f = jnp.sum(dc * dc, -1) - d2w                     # (B,6)
        J = 2.0 * jnp.einsum("bps,bkps->bpk", dc, dV)      # (B,6,4)
        JtJ = jnp.einsum("bpk,bpl->bkl", J, J)
        JtJ = JtJ + 1e-9 * jnp.eye(4, dtype=J.dtype)
        g = jnp.einsum("bpk,bp->bk", J, f)
        db = jnp.linalg.solve(JtJ, g[..., None])[..., 0]
        return b - db, None

    betas, _ = jax.lax.scan(gn_step, betas, None, length=n_gn)
    Cc = jnp.einsum("bk,bkps->bps", betas, V)              # (B,4,3)
    # cheirality: mean point depth must be positive
    pc = jnp.einsum("bnj,bjs->bns", alph, Cc)
    Cc = Cc * jnp.where(jnp.mean(pc[..., 2], -1) < 0, -1.0, 1.0)[:, None, None]
    # Horn (fixed scale) world→camera on the 4 control points
    mu_w = jnp.mean(C, axis=1)
    mu_c = jnp.mean(Cc, axis=1)
    H = jnp.einsum("bns,bnt->bst", Cc - mu_c[:, None], C - mu_w[:, None])
    uS, _, vtS = jnp.linalg.svd(H)
    det = jnp.linalg.det(jnp.einsum("bij,bjk->bik", uS, vtS))
    fix = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = jnp.einsum("bij,bjk->bik", uS * fix[:, None, :], vtS)
    t = mu_c - jnp.einsum("bij,bj->bi", R, mu_w)
    return R, t


def epnp_ransac(
    xw: jax.Array, rays: jax.Array, valid: jax.Array, rand_sets: jax.Array,
    inv_sigma2: jax.Array, chi2_th: float = 5.991, focal: float = 458.0,
    min_inliers: int = 10,
) -> PnPResult:
    """RANSAC-wrapped EPnP (reference src/PnPsolver.cc RANSAC loop,
    include/PnPsolver.h:69-82; superseded by MLPnP for relocalization but
    part of the solver surface). rand_sets: (B,s) with s≥4."""
    xn = rays[..., :2] / rays[..., 2:3]
    R, t = epnp(xw[rand_sets], xn[rand_sets])
    xc = jnp.einsum("bij,nj->bni", R, xw) + t[:, None, :]
    z = jnp.maximum(xc[..., 2], 1e-6)
    pred = xc[..., :2] / z[..., None]
    err2 = jnp.sum((pred - xn[None]) ** 2, axis=-1) * (focal * focal)
    chi2 = err2 * inv_sigma2[None]
    inl = (chi2 < chi2_th) & valid[None] & (xc[..., 2] > 0.05)
    counts = jnp.sum(inl.astype(jnp.int32), axis=-1)
    best = jnp.argmax(counts)
    return PnPResult(
        success=counts[best] >= min_inliers,
        R=R[best], t=t[best], inliers=inl[best], n_inliers=counts[best],
    )


def pnp_ransac(
    xw: jax.Array, rays: jax.Array, valid: jax.Array, rand_sets: jax.Array,
    inv_sigma2: jax.Array, chi2_th: float = 5.991, focal: float = 458.0,
    min_inliers: int = 10,
) -> PnPResult:
    """RANSAC PnP. xw: (N,3) world points; rays: (N,3) unit-z bearing rays;
    rand_sets: (B,6) indices of valid matches; chi2 gated in pixel² via focal.
    (Reference MLPnP RANSAC: 0.99 prob, ≥10 inliers, 6-point model,
    χ²=5.991 — src/Tracking.cc:4216-4221.)"""
    xn = rays[..., :2] / rays[..., 2:3]
    s_w = xw[rand_sets]
    s_n = xn[rand_sets]
    R, t = _dlt_pnp(s_w, s_n)

    xc = jnp.einsum("bij,nj->bni", R, xw) + t[:, None, :]
    z = jnp.maximum(xc[..., 2], 1e-6)
    pred = xc[..., :2] / z[..., None]
    err2 = jnp.sum((pred - xn[None]) ** 2, axis=-1) * (focal * focal)
    chi2 = err2 * inv_sigma2[None]
    inl = (chi2 < chi2_th) & valid[None] & (xc[..., 2] > 0.05)
    counts = jnp.sum(inl.astype(jnp.int32), axis=-1)
    best = jnp.argmax(counts)
    return PnPResult(
        success=counts[best] >= min_inliers,
        R=R[best], t=t[best], inliers=inl[best], n_inliers=counts[best],
    )


def mlpnp_refine(
    xw: jax.Array, rays: jax.Array, weights: jax.Array, valid: jax.Array,
    R0: jax.Array, t0: jax.Array, iters: int = 8,
) -> tuple[jax.Array, jax.Array]:
    """Maximum-likelihood PnP refinement on bearing vectors (the reference
    MLPnPsolver's Gauss-Newton stage, src/MLPnPsolver.cpp — MLPnP, Urban et
    al. 2016): minimize the covariance-weighted residual of the observed
    bearing against the predicted direction, parametrized in each bearing's
    tangent plane (the 2-dof nullspace {r, s} of the observed ray). Being
    projection-model-free it works for any camera whose unprojection produced
    the rays (fisheye included — the reason the reference replaced EPnP with
    MLPnP for relocalization, src/Tracking.cc:4178).

    weights: per-ray scalar information (≈ inv_sigma2 of the pixel scaled by
    focal² — the reference propagates pixel covariance through the
    unprojection Jacobian; a scalar suffices for isotropic pixel noise).
    Returns (R, t) — world→camera.
    """
    dtype = xw.dtype
    v = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)   # (N,3)
    # tangent-plane (nullspace) basis per observed bearing
    tmp = jnp.where(jnp.abs(v[:, 2:3]) < 0.9,
                    jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype), v.shape),
                    jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dtype), v.shape))
    r_b = jnp.cross(v, tmp)
    r_b = r_b / jnp.linalg.norm(r_b, axis=-1, keepdims=True)
    s_b = jnp.cross(v, r_b)
    w = weights * valid.astype(dtype)

    def residuals(p, R, t):
        from . import lie
        dR, dt = lie.se3_exp(p[:6][None])
        Rn, tn = lie.se3_compose(dR[0], dt[0], R, t)
        xc = xw @ Rn.T + tn
        nrm = jnp.linalg.norm(xc, axis=-1, keepdims=True)
        pred = xc / jnp.maximum(nrm, 1e-9)
        rr = jnp.stack([jnp.sum(r_b * pred, -1), jnp.sum(s_b * pred, -1)], -1)
        return rr * jnp.sqrt(w)[:, None]

    def step(carry, _):
        from . import lie
        R, t, lam = carry
        p0 = jnp.zeros(6, dtype)
        r = residuals(p0, R, t).reshape(-1)
        J = jax.jacfwd(lambda p: residuals(p, R, t).reshape(-1))(p0)
        H = J.T @ J
        H = H + lam * jnp.diag(jnp.diagonal(H)) + 1e-9 * jnp.eye(6, dtype=dtype)
        d = -jnp.linalg.solve(H, J.T @ r)
        d = jnp.where(jnp.isfinite(d), d, 0.0)
        dR, dt = lie.se3_exp(d[None])
        Rn, tn = lie.se3_compose(dR[0], dt[0], R, t)
        better = (jnp.sum(residuals(p0, Rn, tn) ** 2)
                  < jnp.sum(r * r))
        R_o = jnp.where(better, Rn, R)
        t_o = jnp.where(better, tn, t)
        lam_o = jnp.where(better, lam * 0.5, lam * 4.0)
        return (R_o, t_o, lam_o), None

    (R, t, _), _ = jax.lax.scan(
        step, (R0.astype(dtype), t0.astype(dtype), jnp.asarray(1e-3, dtype)),
        None, length=iters)
    return R, t
