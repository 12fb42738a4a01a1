"""Binary descriptor matching kernels.

Rebuilds every ``ORBmatcher`` kernel (reference src/ORBmatcher.cc: SearchByProjection
:45/:549/:681/:2469/:2723, SearchByBoW :314/:955, SearchForInitialization :799,
SearchForTriangulation :1107, SearchBySim3 :2201, Fuse :1823/:2051,
DescriptorDistance :2911) with one dense primitive: a masked all-pairs
Hamming distance matrix + argmin. The reference prunes candidate pairs with
pixel grids and BoW feature-vector nodes because CPUs are slow at the full
N×M popcount; an accelerator is not — for N=M=1024, the full matrix is ~8.4M
XOR+popcounts, and every search variant becomes a
different *mask* on the same matrix (window, epipolar, scale-octave, already-
matched). Rotation-consistency filtering (HISTO_LENGTH=30, keep top-3 bins,
reference :36-38 and ComputeThreeMaxima :2863) is a vectorized histogram.

Thresholds follow reference include/ORBmatcher.h: TH_HIGH=100, TH_LOW=50.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = jnp.int32(10_000)


def hamming_matrix(da: jax.Array, db: jax.Array) -> jax.Array:
    """All-pairs 256-bit Hamming distance. da: (N,8) uint32, db: (M,8) uint32 → (N,M) int32.

    XOR + popcount, fused by XLA into the word reduction. Replaces
    the reference's per-pair DescriptorDistance popcount
    (src/ORBmatcher.cc:2911)."""
    x = jnp.bitwise_xor(da[:, None, :], db[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def masked_top2(
    dist: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Row-wise nearest and second-nearest distance under a mask.

    dist: (N,M) int32; mask: (N,M) bool candidates.
    Returns (idx (N,) int32, best (N,), second (N,)); ``best``/``second`` are
    BIG where a row has fewer candidates, and ties go to the lowest column.

    The row argmin + second-best are one packed-key min-reduction each
    (key = dist·8192 + column: min gives the best distance AND the lowest
    column among ties, the same tie-break as argmin); the second-best pass
    avoids materializing a scattered copy of the matrix. Under jit, a caller
    that never reads ``second`` does not compute it.
    """
    n_col = dist.shape[1]
    d = jnp.where(mask, dist, BIG)
    col = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    if n_col > 8192:  # packed key would overflow; fall back to argmin
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    else:
        kmin = jnp.min(d * 8192 + col, axis=1)
        best = kmin // 8192
        idx = kmin - best * 8192
    second = jnp.min(jnp.where(col == idx[:, None], BIG, d), axis=1)
    return idx, best, second


def masked_match(
    dist: jax.Array,
    mask: jax.Array,
    max_dist: int,
    ratio: float | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Row-wise best match under a mask (``masked_top2``).

    Returns (idx (N,), best_dist (N,), ok (N,)) where ok applies the distance
    threshold and (optionally) Lowe's best/second-best ratio, computed the way
    the reference does (bestDist < ratio * secondBest, e.g. src/Tracking.cc:3002).
    """
    idx, best, second = masked_top2(dist, mask)
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return idx, best, ok


def resolve_duplicates(idx: jax.Array, best: jax.Array, ok: jax.Array, m: int) -> jax.Array:
    """Keep only the lowest-distance row per matched column (the reference erases
    duplicate matches, e.g. SearchForInitialization src/ORBmatcher.cc:869-887).

    Returns updated ok mask.
    """
    # winner per column = argmin over rows of (best where idx==col)
    n = idx.shape[0]
    col_best = jnp.full((m,), BIG, jnp.int32)
    d = jnp.where(ok, best, BIG)
    col_best = col_best.at[idx].min(d)
    winner = col_best[idx] == d
    # among equal distances, keep lowest row index
    row_ids = jnp.arange(n)
    col_row = jnp.full((m,), n, jnp.int32)
    col_row = col_row.at[idx].min(jnp.where(winner & ok, row_ids, n))
    return ok & winner & (col_row[idx] == row_ids)


def rotation_consistency(
    angle_a: jax.Array, angle_b: jax.Array, idx: jax.Array, ok: jax.Array
) -> jax.Array:
    """Keep matches whose angle difference falls in the 3 dominant histogram bins
    (reference HISTO_LENGTH=30, ComputeThreeMaxima src/ORBmatcher.cc:2863-2909,
    including the <10%-of-max bin rejection)."""
    diff = angle_a - angle_b[idx]
    two_pi = 2.0 * np.pi
    rot = jnp.mod(diff, two_pi)
    bins = jnp.clip((rot * (HISTO_LENGTH / two_pi)).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    counts = jnp.zeros((HISTO_LENGTH,), jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top3 = jax.lax.top_k(counts, 3)[0]
    mx = top3[0]
    keep_bin = (counts[None, :] == counts[None, :])  # placeholder shape
    thresh2 = (top3[1].astype(jnp.float32) > 0.1 * mx.astype(jnp.float32))
    thresh3 = (top3[2].astype(jnp.float32) > 0.1 * mx.astype(jnp.float32))
    # a bin is kept if it matches one of the top-3 counts that survive the 10% rule
    c = counts
    is1 = c == top3[0]
    is2 = (c == top3[1]) & thresh2
    is3 = (c == top3[2]) & thresh3
    bin_keep = is1 | is2 | is3
    return ok & bin_keep[bins]


def window_mask(
    pred_xy: jax.Array, feat_xy: jax.Array, radius: jax.Array | float
) -> jax.Array:
    """(N,M) mask: feature j within Chebyshev `radius` of predicted position i
    (the reference's GetFeaturesInArea grid query, src/Frame.cc:784, as a mask)."""
    dx = jnp.abs(pred_xy[:, None, 0] - feat_xy[None, :, 0])
    dy = jnp.abs(pred_xy[:, None, 1] - feat_xy[None, :, 1])
    r = radius if isinstance(radius, (int, float)) else radius[:, None]
    return (dx <= r) & (dy <= r)


def octave_mask(pred_octave: jax.Array, feat_octave: jax.Array, lo: int = 0, hi: int = 1) -> jax.Array:
    """(N,M) mask: feature octave within [pred-lo, pred+hi] (reference scale gating,
    e.g. src/ORBmatcher.cc:2499-2500)."""
    d = feat_octave[None, :] - pred_octave[:, None]
    return (d >= -lo) & (d <= hi)


def match_rows(mp_desc, pred_xy, radius, pred_octave, row_ok,
               feat_desc, feat_xy, feat_octave, feat_valid,
               octave_lo: int = 1, octave_hi: int = 1):
    """Projection-window top-2 search: for each map point (row), the nearest
    and second-nearest descriptor among the features inside its window and
    octave band (reference SearchByProjection src/ORBmatcher.cc:45-140).

    Returns ``masked_top2``'s (idx (M,), best (M,), second (M,)). XLA fuses
    the mask chain into the row reductions, so the (M,N) matrix is the only
    pairwise intermediate.
    """
    mask = (row_ok[:, None] & feat_valid[None, :]
            & window_mask(pred_xy, feat_xy, radius)
            & octave_mask(pred_octave, feat_octave, octave_lo, octave_hi))
    return masked_top2(hamming_matrix(mp_desc, feat_desc), mask)


def search_by_projection(
    desc_a: jax.Array, valid_a: jax.Array, pred_xy: jax.Array, pred_octave: jax.Array,
    desc_b: jax.Array, valid_b: jax.Array, feat_xy: jax.Array, feat_octave: jax.Array,
    radius: jax.Array | float, max_dist: int = TH_HIGH, ratio: float | None = None,
    angle_a: jax.Array | None = None, angle_b: jax.Array | None = None,
    check_rotation: bool = False, octave_lo: int = 1, octave_hi: int = 1,
):
    """Projection-guided matching: map-point descriptors (A) against frame
    features (B) within a search window (reference SearchByProjection family)."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = (
        valid_a[:, None] & valid_b[None, :]
        & window_mask(pred_xy, feat_xy, radius)
        & octave_mask(pred_octave, feat_octave, octave_lo, octave_hi)
    )
    idx, best, ok = masked_match(dist, mask, max_dist, ratio)
    ok = resolve_duplicates(idx, best, ok, desc_b.shape[0])
    if check_rotation and angle_a is not None:
        ok = rotation_consistency(angle_a, angle_b, idx, ok)
    return idx, best, ok


def search_for_initialization(
    desc1, valid1, xy1, angle1, desc2, valid2, xy2, angle2,
    window: float = 100.0, ratio: float = 0.9, max_dist: int = TH_LOW,
):
    """Monocular-init matching (reference SearchForInitialization src/ORBmatcher.cc:799):
    window search around the level-0 keypoint positions, ratio 0.9, rotation check."""
    dist = hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :] & window_mask(xy1, xy2, window)
    idx, best, ok = masked_match(dist, mask, max_dist, ratio)
    ok = resolve_duplicates(idx, best, ok, desc2.shape[0])
    ok = rotation_consistency(angle1, angle2, idx, ok)
    return idx, best, ok


def search_by_descriptor(
    desc_a, valid_a, desc_b, valid_b,
    max_dist: int = TH_LOW, ratio: float = 0.7,
    angle_a=None, angle_b=None, check_rotation: bool = False,
):
    """Unconstrained descriptor matching (the reference's SearchByBoW semantics:
    BoW nodes there only prune candidates for CPU speed; thresholds TH_LOW + ratio)."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    idx, best, ok = masked_match(dist, mask, max_dist, ratio)
    ok = resolve_duplicates(idx, best, ok, desc_b.shape[0])
    if check_rotation and angle_a is not None:
        ok = rotation_consistency(angle_a, angle_b, idx, ok)
    return idx, best, ok


def epipolar_mask(
    rays1: jax.Array, xy2: jax.Array, E: jax.Array, cam_params: jax.Array,
    sigma2_by_octave: jax.Array, octave2: jax.Array, th_chi2: float = 3.84,
) -> jax.Array:
    """(N,M) mask of pairs consistent with the epipolar constraint.

    rays1: (N,3) unit-z rays in camera-1; xy2: (M,2) pixels of camera 2 with a
    pinhole param vector `cam_params` (fx,fy,cx,cy); E: essential matrix c2←c1.
    Distance of x2 to the epipolar line of x1 in pixels, gated by per-octave
    sigma (reference CheckDistEpipolarLine, src/ORBmatcher.cc epipolar search).
    """
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    # line in normalized cam-2 coords: l = E @ ray1
    l = rays1 @ E.T  # (N,3)
    # convert to pixel-space line: a/fx, b/fy, c - a*cx/fx - b*cy/fy
    a = l[:, 0] / fx
    b = l[:, 1] / fy
    c = l[:, 2] - l[:, 0] * cx / fx - l[:, 1] * cy / fy
    num = a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1] + c[:, None]
    den2 = a * a + b * b
    dsq = (num * num) / jnp.maximum(den2[:, None], 1e-12)
    return dsq < th_chi2 * sigma2_by_octave[octave2][None, :]
