"""Two-view reconstruction: batched H/F RANSAC for monocular map bootstrap.

Rebuilds the reference ``TwoViewReconstruction`` (reference
src/TwoViewReconstruction.cc: Reconstruct with parallel FindHomography /
FindFundamental, 200 RANSAC iterations over 8-point samples, model selection
by score ratio RH>0.50 :128-143, ReconstructF 4-way decomposition + CheckRT)
Batched: all 200 hypotheses are estimated and scored **in one batch**
(the reference's two threads become one tensorized pass), and the 4 essential-
matrix decompositions are checked with a vmapped triangulation.

Inputs are *normalized camera coordinates* (undistorted pixels through K⁻¹),
so the "fundamental" matrix here is the essential matrix directly. Scores and
gates replicate the reference's: sigma=1 px equivalents must be pre-scaled by
the caller via `sigma_n` (sigma / focal).

The homography *scoring* is implemented for model selection; when H wins,
reconstruction currently still goes through the essential path (planar-scene
Faugeras decomposition is a TODO for a later round — affects purely-planar
monocular bootstrap only).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie, triangulation

CHI2_F = 3.841
CHI2_H = 5.991
SCORE_GAMMA = 5.991


def _eight_point_F(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Batched 8-point algorithm. x1,x2: (B,8,2) → F (B,3,3) rank-2 enforced."""
    ones = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    X1 = jnp.concatenate([x1, ones], axis=-1)
    X2 = jnp.concatenate([x2, ones], axis=-1)
    # row_i = kron(x2_i, x1_i): F s.t. x2^T F x1 = 0
    A = jnp.einsum("bni,bnj->bnij", X2, X1).reshape(x1.shape[0], 8, 9)
    AtA = jnp.einsum("bni,bnj->bij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    F = vecs[..., :, 0].reshape(-1, 3, 3)
    # rank-2 projection
    u, s, vt = jnp.linalg.svd(F)
    s = s.at[..., 2].set(0.0)
    return (u * s[..., None, :]) @ vt


def _four_point_H(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Batched DLT homography from 8 points (reference uses 8 too). x*: (B,8,2)."""
    b, n, _ = x1.shape
    ones = jnp.ones((b, n, 1), x1.dtype)
    X1 = jnp.concatenate([x1, ones], axis=-1)  # (B,8,3)
    zeros = jnp.zeros_like(X1)
    u2 = x2[..., 0:1]
    v2 = x2[..., 1:2]
    r1 = jnp.concatenate([zeros, -X1, v2 * X1], axis=-1)       # (B,8,9)
    r2 = jnp.concatenate([X1, zeros, -u2 * X1], axis=-1)
    A = jnp.concatenate([r1, r2], axis=1)                      # (B,16,9)
    AtA = jnp.einsum("bni,bnj->bij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[..., :, 0].reshape(-1, 3, 3)


def _sym_transfer_chi2_F(F, x1, x2):
    """(B,N) chi2 in both directions for F hypotheses (reference CheckFundamental)."""
    ones = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    X1 = jnp.concatenate([x1, ones], axis=-1)[None]            # (1,N,3)
    X2 = jnp.concatenate([x2, ones], axis=-1)[None]
    l2 = jnp.einsum("bij,bnj->bni", F, X1)                     # line in image 2
    l1 = jnp.einsum("bji,bnj->bni", F, X2)                     # line in image 1
    d2 = jnp.einsum("bni,bni->bn", X2, l2) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-20)
    d1 = jnp.einsum("bni,bni->bn", X1, l1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-20)
    return d1, d2


def _sym_transfer_chi2_H(H, x1, x2):
    ones = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    X1 = jnp.concatenate([x1, ones], axis=-1)[None]
    X2 = jnp.concatenate([x2, ones], axis=-1)[None]
    Hx1 = jnp.einsum("bij,bnj->bni", H, X1)
    Hinv = jnp.linalg.inv(H)
    Hx2 = jnp.einsum("bij,bnj->bni", Hinv, X2)
    p2 = Hx1[..., :2] / jnp.where(jnp.abs(Hx1[..., 2:]) < 1e-12, 1e-12, Hx1[..., 2:])
    p1 = Hx2[..., :2] / jnp.where(jnp.abs(Hx2[..., 2:]) < 1e-12, 1e-12, Hx2[..., 2:])
    d2 = jnp.sum((x2[None] - p2) ** 2, axis=-1)
    d1 = jnp.sum((x1[None] - p1) ** 2, axis=-1)
    return d1, d2


def _score(d1, d2, valid, chi_th, inv_sigma_n2):
    """Reference scoring (src/TwoViewReconstruction.cc CheckHomography/Fundamental):
    per-match contribution (GAMMA - chi) for each direction passing its gate;
    a match is an inlier iff both directions pass."""
    c1 = d1 * inv_sigma_n2
    c2 = d2 * inv_sigma_n2
    ok1 = c1 < chi_th
    ok2 = c2 < chi_th
    sc = jnp.where(ok1, SCORE_GAMMA - c1, 0.0) + jnp.where(ok2, SCORE_GAMMA - c2, 0.0)
    sc = jnp.where(valid[None], sc, 0.0)
    inlier = ok1 & ok2 & valid[None]
    return jnp.sum(sc, axis=-1), inlier


def decompose_homography(H: jax.Array):
    """Faugeras SVD decomposition of a (normalized-coordinate) homography into
    8 motion hypotheses (R, t, n) with H ∝ R + t nᵀ/d (reference ReconstructH,
    src/TwoViewReconstruction.cc; method of Faugeras & Lustman 1988).

    Returns (R (8,3,3), t (8,3) unit, n (8,3)).
    """
    U, D, Vt = jnp.linalg.svd(H)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    # guard the degenerate equal-singular-value cases (pure rotation)
    eps = 1e-9
    x1m = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, eps), 0.0))
    x3m = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, eps), 0.0))
    e1 = jnp.asarray([1.0, 1.0, -1.0, -1.0], H.dtype)
    e3 = jnp.asarray([1.0, -1.0, 1.0, -1.0], H.dtype)
    x1 = e1 * x1m
    x3 = e3 * x3m

    Rs, ts, ns = [], [], []
    # case d' = +d2
    st = (d1 - d3) * x1 * x3 / jnp.maximum(d2, eps)
    ct = (d1 * x3 * x3 + d3 * x1 * x1) / jnp.maximum(d2, eps)
    for i in range(4):
        Rp = jnp.asarray(
            [[ct[i], 0.0, -st[i]], [0.0, 1.0, 0.0], [st[i], 0.0, ct[i]]], H.dtype)
        tp = (d1 - d3) * jnp.stack([x1[i], jnp.zeros((), H.dtype), -x3[i]])
        npl = jnp.stack([x1[i], jnp.zeros((), H.dtype), x3[i]])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
        ns.append(Vt.T @ npl)
    # case d' = −d2
    sp = (d1 + d3) * x1 * x3 / jnp.maximum(d2, eps)
    cp = (d3 * x1 * x1 - d1 * x3 * x3) / jnp.maximum(d2, eps)
    for i in range(4):
        Rp = jnp.asarray(
            [[cp[i], 0.0, sp[i]], [0.0, -1.0, 0.0], [sp[i], 0.0, -cp[i]]], H.dtype)
        tp = (d1 + d3) * jnp.stack([x1[i], jnp.zeros((), H.dtype), x3[i]])
        npl = jnp.stack([x1[i], jnp.zeros((), H.dtype), x3[i]])
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
        ns.append(Vt.T @ npl)
    R8 = jnp.stack(Rs)
    t8 = jnp.stack(ts)
    t8 = t8 / jnp.maximum(jnp.linalg.norm(t8, axis=-1, keepdims=True), 1e-12)
    return R8, t8, jnp.stack(ns)


class TwoViewResult(NamedTuple):
    success: jax.Array    # () bool
    R: jax.Array          # (3,3) cam1→cam2 (world = cam1)
    t: jax.Array          # (3,) unit baseline
    pts: jax.Array        # (N,3) triangulated in cam1 frame
    good: jax.Array       # (N,) bool
    is_homography: jax.Array  # () bool — which model won the score ratio


def reconstruct_two_views(
    x1: jax.Array, x2: jax.Array, valid: jax.Array, rand_sets: jax.Array,
    sigma_n: float, min_parallax_cos: float = 0.99995, min_good: int = 50,
) -> TwoViewResult:
    """Full monocular bootstrap from N matched normalized coords.

    x1, x2: (N,2) normalized camera coords of matches; valid: (N,);
    rand_sets: (iters, 8) int32 indices of pre-sampled valid matches (host RNG,
    mirroring the reference's DUtils::Random seeding);
    sigma_n: pixel sigma / focal (errors gated in normalized units).
    """
    inv_sigma_n2 = 1.0 / (sigma_n * sigma_n)
    s1 = x1[rand_sets]  # (B,8,2)
    s2 = x2[rand_sets]

    F = _eight_point_F(s1, s2)
    H = _four_point_H(s1, s2)
    d1f, d2f = _sym_transfer_chi2_F(F, x1, x2)
    d1h, d2h = _sym_transfer_chi2_H(H, x1, x2)
    sf, inl_f = _score(d1f, d2f, valid, CHI2_F, inv_sigma_n2)
    sh, inl_h = _score(d1h, d2h, valid, CHI2_H, inv_sigma_n2)

    bf = jnp.argmax(sf)
    bh = jnp.argmax(sh)
    SF = sf[bf]
    SH = sh[bh]
    rh = SH / jnp.maximum(SH + SF, 1e-12)
    # ORB-SLAM2's 0.40 rather than the reference V0.4's 0.50
    # (src/TwoViewReconstruction.cc:135 `if(RH>0.50) // if(RH>0.40)`): the
    # F-score is structurally higher on points fitting both models (1-DoF vs
    # 2-DoF error), so on a pure plane RH ties at ~0.5 and 0.50 selects F,
    # which reconstructs a confident-but-wrong motion (test_two_view_planar_
    # scene_is_safe demonstrates it); 0.40 routes planar scenes to Faugeras.
    is_h = rh > 0.40

    Fbest = F[bf]
    Hbest = H[bh]
    inliers = jnp.where(is_h, inl_h[bh], inl_f[bf])

    # ReconstructF: E = F (normalized coords); 4 decompositions
    u, s, vt = jnp.linalg.svd(Fbest)
    # enforce proper rotations
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], x1.dtype)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    tb = u[:, 2]
    tb = tb / (jnp.linalg.norm(tb) + 1e-12)
    f_R = jnp.stack([R1, R1, R2, R2])
    f_t = jnp.stack([tb, -tb, tb, -tb])
    # ReconstructH: Faugeras 8-way decomposition
    h_R, h_t, _ = decompose_homography(Hbest)
    cands_R = jnp.concatenate([f_R, h_R])
    cands_t = jnp.concatenate([f_t, h_t])
    cand_valid = jnp.concatenate([
        jnp.full((4,), ~is_h), jnp.full((8,), is_h)])

    ones1 = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    rays1 = jnp.concatenate([x1, ones1], axis=-1)
    rays2 = jnp.concatenate([x2, ones1], axis=-1)
    eye = jnp.eye(3, dtype=x1.dtype)
    zero = jnp.zeros(3, x1.dtype)
    sig2 = jnp.full(x1.shape[0], sigma_n * sigma_n * 4.0)  # 4σ² gate (reference CheckRT)

    def check(Rc, tc):
        xw = triangulation.triangulate_dlt(eye, zero, rays1, Rc, tc, rays2)
        ok, _ = triangulation.check_triangulation(
            xw, eye, zero, rays1, Rc, tc, rays2, sig2, sig2,
            min_parallax_cos=min_parallax_cos, chi2_th=CHI2_H * inv_sigma_n2 * sig2[0],
        )
        ok = ok & inliers
        return jnp.sum(ok.astype(jnp.int32)), xw, ok

    ngood, xws, oks = jax.vmap(check)(cands_R, cands_t)
    ngood = jnp.where(cand_valid, ngood, -1)
    bi = jnp.argmax(ngood)
    nbest = ngood[bi]
    nsecond = jnp.sort(ngood)[-2]
    n_inl = jnp.sum(inliers.astype(jnp.int32))
    # uniqueness + minimum support (reference: nGood > 0.9*nInliers-ish, ≥50, unique winner)
    success = (
        (nbest >= min_good)
        & (nbest.astype(jnp.float32) > 0.75 * n_inl.astype(jnp.float32))
        & (nsecond.astype(jnp.float32) < 0.75 * nbest.astype(jnp.float32))
    )
    return TwoViewResult(
        success=success, R=cands_R[bi], t=cands_t[bi],
        pts=xws[bi], good=oks[bi], is_homography=is_h,
    )
