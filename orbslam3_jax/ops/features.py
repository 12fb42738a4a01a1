"""ORB feature extraction as fixed-shape batched device kernels.

Rebuilds the reference ``ORBextractor`` (reference src/ORBextractor.cc:
ComputePyramid :1664, ComputeKeyPointsOctTree :1038-1100, DistributeOctTree
:688, IC_Angle :91-130, computeOrbDescriptor :150, operator() :1534) as a
single jitted function over an image:

- 8-level pyramid (scale 1.2) via bilinear resize; all level shapes static.
- FAST-9/16 corner test vectorized over the whole image: the 16 ring
  comparisons are packed into a 32-bit lane per pixel and the
  "9 contiguous" test is 4 AND-shift ops — pure VPU work, no scalar loops.
- Dual-threshold fallback per 35x35 cell (iniThFAST=20 → minThFAST=7):
  cells with no high-threshold corner fall back to the low-threshold mask
  (reference :1038-1100 re-detection loop, here branchless).
- Spatial distribution: 3x3 non-max suppression + per-cell top-k + per-level
  top-k with static capacities following the reference's geometric per-level
  feature allocation (reference :506-511). This replaces the host quadtree
  (DistributeOctTree) with a shape-static, data-parallel equivalent.
- Orientation by intensity centroid over a radius-15 circular patch.
- 256-bit steered BRIEF on the 7x7-Gaussian-blurred level image, sampled via
  batched gathers; descriptors packed to uint32[8].

Parity with the reference/OpenCV (validated in tests/test_orb_cv2.py):
- the descriptor pattern is the PUBLISHED learned ``bit_pattern_31`` table
  (ops/orb_pattern.py — same constant as OpenCV orb.cpp and reference
  src/ORBextractor.cc:206), sampled with OpenCV's exact steering/rounding;
- the orientation circle uses OpenCV's integer ``u_max`` boundary (reference
  IC_Angle :91-130), not a naive disc;
- the FAST response is OpenCV's arc score (max-over-arcs of min-over-arc
  contrast), so keypoint ranking matches;
- spatial selection approximates ``DistributeOctTree`` (:688) with a
  shape-static two-stage scheme: one winner per adaptive-size cell first
  (the quadtree's terminal best-per-node rule), then best-response fill.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

EDGE_THRESHOLD = 19  # reference src/ORBextractor.cc:78
PATCH_HALF = 15      # HALF_PATCH_SIZE, reference :77

# 16-point Bresenham circle of radius 3, in angular order (dx, dy).
_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


from .orb_pattern import BIT_PATTERN_31

BRIEF_PATTERN = BIT_PATTERN_31   # the learned rBRIEF table (see orb_pattern.py)


def scale_factors(n_levels: int, scale: float):
    """Per-level scale factor, sigma2 and inverses (reference ORBextractor ctor)."""
    s = np.array([scale ** i for i in range(n_levels)], dtype=np.float32)
    return s, s * s, 1.0 / s, 1.0 / (s * s)


def per_level_capacities(n_features: int, n_levels: int, scale: float):
    """Geometric feature allocation per level (reference src/ORBextractor.cc:506-511)."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    caps = []
    acc = 0
    for i in range(n_levels - 1):
        c = int(round(n_first * factor ** i))
        caps.append(c)
        acc += c
    caps.append(max(n_features - acc, 0))
    return caps


class OrbFeatures(NamedTuple):
    """SoA feature set for one image; fixed capacity N with validity mask.

    xy is in level-0 (full-resolution, undistorted-later) pixel coordinates.
    """
    xy: jax.Array       # (N, 2) float32
    response: jax.Array # (N,) float32
    angle: jax.Array    # (N,) float32 radians
    octave: jax.Array   # (N,) int32
    desc: jax.Array     # (N, 8) uint32
    valid: jax.Array    # (N,) bool


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    ini_th: int = 20
    min_th: int = 7
    cell: int = 35
    cell_topk: int = 8  # max keypoints surviving per 35x35 cell

    @property
    def capacities(self):
        return per_level_capacities(self.n_features, self.n_levels, self.scale)

    @property
    def total_capacity(self):
        return sum(self.capacities)


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------

def _ring_stack(img: jax.Array) -> jax.Array:
    """(16, H, W) stack of ring-neighbor values via static rolls."""
    outs = []
    for dx, dy in _RING:
        outs.append(jnp.roll(img, shift=(-int(dy), -int(dx)), axis=(0, 1)))
    return jnp.stack(outs, axis=0)


def _contiguous9(bits: jax.Array) -> jax.Array:
    """True where a 16-bit ring mask (in an int32 lane) has >=9 contiguous set bits
    cyclically. bits: any-shape int32 with the mask in the low 16 bits."""
    b = bits | (bits << 16)
    y = b & (b >> 1)
    y = y & (y >> 2)
    y = y & (y >> 4)   # >= 8 contiguous
    y = y & (y >> 1)   # >= 9 contiguous
    return (y & 0xFFFF) != 0


def fast_response(img: jax.Array, th_hi: float, th_lo: float):
    """FAST-9/16 masks at two thresholds + SAD response. img: (H,W) float32.

    Returns (corner_hi, corner_lo, score) each (H, W).
    """
    ring = _ring_stack(img)               # (16,H,W)
    diff = ring - img[None]
    weights = (1 << np.arange(16)).astype(np.int32)
    w = jnp.asarray(weights)[:, None, None]

    def masks(th):
        bright = (diff > th).astype(jnp.int32)
        dark = (diff < -th).astype(jnp.int32)
        bbits = jnp.sum(bright * w, axis=0)
        dbits = jnp.sum(dark * w, axis=0)
        return _contiguous9(bbits) | _contiguous9(dbits)

    corner_hi = masks(float(th_hi))
    corner_lo = masks(float(th_lo))
    # OpenCV arc score (cornerScore<16>): the highest threshold at which the
    # pixel is still a FAST corner = max over the 16 cyclic 9-arcs of the
    # arc's minimum contrast, for bright and dark separately, minus 1.
    def arc9_min(d):
        # cyclic rolling minimum over a 9-window along axis 0 (16 ring pts)
        m1 = jnp.minimum(d, jnp.roll(d, -1, 0))
        m2 = jnp.minimum(m1, jnp.roll(m1, -2, 0))
        m4 = jnp.minimum(m2, jnp.roll(m2, -4, 0))   # window 8
        return jnp.minimum(m4, jnp.roll(d, -8, 0))  # window 9
    bright = jnp.max(arc9_min(diff), axis=0)
    dark = jnp.max(arc9_min(-diff), axis=0)
    score = jnp.maximum(bright, dark) - 1.0
    return corner_hi, corner_lo, score


def _cell_any(mask: jax.Array, cell: int) -> jax.Array:
    """Per-cell 'any' broadcast back to pixel grid. mask: (H,W) bool."""
    h, w = mask.shape
    ph = (-h) % cell
    pw = (-w) % cell
    m = jnp.pad(mask, ((0, ph), (0, pw)))
    hc, wc = m.shape[0] // cell, m.shape[1] // cell
    cells = m.reshape(hc, cell, wc, cell).any(axis=(1, 3))
    up = jnp.repeat(jnp.repeat(cells, cell, axis=0), cell, axis=1)
    return up[:h, :w]


def _nms3(score: jax.Array) -> jax.Array:
    """3x3 non-max suppression mask (ties keep both)."""
    neigh = [jnp.roll(score, (dy, dx), (0, 1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    mx = functools.reduce(jnp.maximum, neigh)
    return score >= mx


def detect_level(img: jax.Array, cfg: OrbConfig, capacity: int):
    """Detect up to `capacity` FAST keypoints on one pyramid level.

    Returns (xy (capacity,2) int32 level coords, score (capacity,), valid).
    """
    h, w = img.shape
    corner_hi, corner_lo, score = fast_response(img, cfg.ini_th, cfg.min_th)
    has_hi = _cell_any(corner_hi, cfg.cell)
    corner = corner_hi | (corner_lo & jnp.logical_not(has_hi))

    # border mask: FAST ring needs 3 px; descriptor/orientation sampling is
    # guaranteed by EDGE_THRESHOLD at level scale (reference uses 19 on every level)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    b = EDGE_THRESHOLD
    inb = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)

    keep = corner & inb & _nms3(score)
    masked = jnp.where(keep, score, -1.0)

    # DistributeOctTree-equivalent selection (reference :688): the quadtree
    # splits until ~capacity nodes then keeps the best-response point per
    # node. Shape-static equivalent: a grid whose occupied-cell count is on
    # the order of the capacity, ONE boosted winner per cell (every occupied
    # region represented first), remaining slots filled by response.
    cell = max(12, min(64, int(round(math.sqrt(h * w / max(capacity, 1))))))
    ph = (-h) % cell
    pw = (-w) % cell
    mp = jnp.pad(masked, ((0, ph), (0, pw)), constant_values=-1.0)
    hp, wp = mp.shape
    hc, wc = hp // cell, wp // cell
    cells = mp.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    k = min(cfg.cell_topk, cell * cell)
    cs, ci = jax.lax.top_k(cells, k)                     # (ncells,k)
    # per-cell winner outranks every runner-up (quadtree terminal rule)
    boost = jnp.where(jnp.arange(k)[None, :] == 0, 1e7, 0.0)
    cs_rank = jnp.where(cs > 0.0, cs + boost, cs)
    # reconstruct global pixel coords of per-cell winners
    cy = (jnp.arange(hc * wc) // wc)[:, None] * cell + ci // cell
    cx = (jnp.arange(hc * wc) % wc)[:, None] * cell + ci % cell
    flat_rank = cs_rank.reshape(-1)
    flat_scores = cs.reshape(-1)
    flat_y = cy.reshape(-1)
    flat_x = cx.reshape(-1)
    kk = min(capacity, flat_rank.shape[0])
    top_r, top_i = jax.lax.top_k(flat_rank, kk)
    top_s = flat_scores[top_i]
    xy = jnp.stack([flat_x[top_i], flat_y[top_i]], axis=-1).astype(jnp.int32)
    valid = top_r > 0.0
    if kk < capacity:  # pad (tiny levels)
        pad = capacity - kk
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        top_s = jnp.pad(top_s, (0, pad), constant_values=-1.0)
        valid = jnp.pad(valid, (0, pad))
    return xy, top_s, valid


# ---------------------------------------------------------------------------
# Orientation + descriptors
# ---------------------------------------------------------------------------

_CIRC_MASK = None


def _umax_table() -> np.ndarray:
    """OpenCV's integer circle boundary for IC_Angle (ORBextractor ctor:
    umax[v] = cvRound(sqrt(HALF² − v²)) for v ≤ vmax, mirrored for symmetry).
    The boundary differs from a naive disc at several rows — required for
    angle parity with cv2."""
    half = PATCH_HALF
    umax = np.zeros(half + 2, np.int32)
    vmax = int(np.floor(half * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half + 1]


def _circ_mask():
    global _CIRC_MASK
    if _CIRC_MASK is None:
        umax = _umax_table()
        d = np.arange(-PATCH_HALF, PATCH_HALF + 1)
        dy, dx = np.meshgrid(d, d, indexing="ij")
        _CIRC_MASK = (np.abs(dx) <= umax[np.abs(dy)]).astype(np.float32)
    return _CIRC_MASK


def ic_angles(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Intensity-centroid orientation (reference IC_Angle src/ORBextractor.cc:91-130).

    img: (H,W) float32; xy: (N,2) int32 level coords (in-border). → (N,) radians.
    """
    h, w = img.shape
    mask = jnp.asarray(_circ_mask())
    d = jnp.arange(-PATCH_HALF, PATCH_HALF + 1, dtype=jnp.float32)
    dxm = d[None, :] * mask
    dym = d[:, None] * mask

    def one(p):
        y0 = jnp.clip(p[1] - PATCH_HALF, 0, h - 2 * PATCH_HALF - 1)
        x0 = jnp.clip(p[0] - PATCH_HALF, 0, w - 2 * PATCH_HALF - 1)
        patch = jax.lax.dynamic_slice(img, (y0, x0), (2 * PATCH_HALF + 1, 2 * PATCH_HALF + 1))
        m10 = jnp.sum(patch * dxm)
        m01 = jnp.sum(patch * dym)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(xy)


def gaussian_blur7(img: jax.Array) -> jax.Array:
    """7x7 Gaussian, sigma=2 (reference GaussianBlur before descriptors, :1611)."""
    x = np.arange(-3, 4)
    k = np.exp(-(x ** 2) / (2 * 2.0 ** 2))
    k = (k / k.sum()).astype(np.float32)
    kj = jnp.asarray(k)
    # separable; numpy "reflect" == cv2 BORDER_REFLECT_101 (the default)
    p = jnp.pad(img, ((3, 3), (0, 0)), mode="reflect")
    v = sum(kj[i] * p[i:i + img.shape[0], :] for i in range(7))
    p = jnp.pad(v, ((0, 0), (3, 3)), mode="reflect")
    return sum(kj[i] * p[:, i:i + img.shape[1]] for i in range(7))


def brief_descriptors(blurred: jax.Array, xy: jax.Array, angle: jax.Array) -> jax.Array:
    """Steered 256-bit BRIEF → (N, 8) uint32 (reference computeOrbDescriptor :150-168)."""
    h, w = blurred.shape
    pat = jnp.asarray(BRIEF_PATTERN.astype(np.float32))  # (256,4)
    ca, sa = jnp.cos(angle), jnp.sin(angle)              # (N,)

    def rot(px, py):
        # (N,256) rotated integer offsets
        rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).astype(jnp.int32)
        ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).astype(jnp.int32)
        return rx, ry

    ax, ay = rot(pat[:, 0], pat[:, 1])
    bx, by = rot(pat[:, 2], pat[:, 3])
    cx = xy[:, 0:1]
    cy = xy[:, 1:2]

    def sample(ox, oy):
        ix = jnp.clip(cx + ox, 0, w - 1)
        iy = jnp.clip(cy + oy, 0, h - 1)
        return blurred.reshape(-1)[(iy * w + ix).reshape(-1)].reshape(ix.shape)

    bits = (sample(ax, ay) < sample(bx, by))             # (N,256)
    shifts = jnp.asarray((np.arange(32, dtype=np.uint32) % 32).astype(np.uint32))
    words = bits.reshape(bits.shape[0], 8, 32).astype(jnp.uint32) << shifts[None, None, :]
    return jnp.sum(words, axis=-1).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _level_shapes(h: int, w: int, cfg: OrbConfig):
    shapes = []
    for i in range(cfg.n_levels):
        s = 1.0 / (cfg.scale ** i)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def extract_orb(img: jax.Array, cfg: OrbConfig) -> OrbFeatures:
    """Full ORB extraction on a (H,W) image (uint8 or float32).

    Jit-safe: everything static except pixel values. Output capacity is
    ``cfg.total_capacity`` with a validity mask.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    shapes = _level_shapes(h, w, cfg)
    caps = cfg.capacities
    sf, _, _, _ = scale_factors(cfg.n_levels, cfg.scale)

    outs = []
    level_img = img
    for lvl in range(cfg.n_levels):
        if lvl > 0:
            level_img = jax.image.resize(level_img, shapes[lvl], method="bilinear")
        cap = max(caps[lvl], 1)
        xy, score, valid = detect_level(level_img, cfg, cap)
        ang = ic_angles(level_img, xy)
        blurred = gaussian_blur7(level_img)
        desc = brief_descriptors(blurred, xy, ang)
        xy0 = xy.astype(jnp.float32) * sf[lvl]
        outs.append(OrbFeatures(
            xy=xy0,
            response=score,
            angle=ang,
            octave=jnp.full((cap,), lvl, jnp.int32),
            desc=desc,
            valid=valid,
        ))

    return OrbFeatures(
        xy=jnp.concatenate([o.xy for o in outs]),
        response=jnp.concatenate([o.response for o in outs]),
        angle=jnp.concatenate([o.angle for o in outs]),
        octave=jnp.concatenate([o.octave for o in outs]),
        desc=jnp.concatenate([o.desc for o in outs]),
        valid=jnp.concatenate([o.valid for o in outs]),
    )


def make_extractor(h: int, w: int, cfg: OrbConfig, K=None, D=None):
    """Returns a jitted extractor for a fixed image size.

    When pinhole intrinsics ``K`` (fx fy cx cy) and distortion ``D`` are
    given, keypoint undistortion (reference Frame::UndistortKeyPoints,
    src/Frame.cc:924) runs inside the same dispatch so the returned ``xy``
    is already undistorted — the host never needs to round-trip keypoints
    through the device for it."""
    from . import camera as cam_ops
    undist = (K is not None and D is not None
              and bool(np.any(np.abs(np.asarray(D)) > 1e-12)))
    Kc = None if K is None else jnp.asarray(np.asarray(K, np.float32)[:4])
    Dc = None if D is None else jnp.asarray(np.asarray(D, np.float32))

    @jax.jit
    def fn(img):
        feats = extract_orb(img, cfg)
        if undist:
            feats = feats._replace(
                xy=cam_ops.pinhole_undistort_pixels(Kc, Dc, feats.xy))
        return feats
    return fn


def pack_features_for_host(feats: OrbFeatures) -> jax.Array:
    """Pack one frame's features into a single uint32 buffer for ONE
    device→host transfer (each transfer has its own latency; see
    models/frame.py lazy materialization).

    Layout per row (13 u32): xy (2, f32 bits), angle (1, f32 bits),
    response (1, f32 bits), octave (1), valid (1), desc (8)."""
    as_u32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint32)
    return jnp.concatenate([
        as_u32(feats.xy),
        as_u32(feats.angle)[:, None],
        as_u32(feats.response)[:, None],
        feats.octave.astype(jnp.uint32)[:, None],
        feats.valid.astype(jnp.uint32)[:, None],
        feats.desc,
    ], axis=1)


@jax.jit
def _pack_features_jit(feats: OrbFeatures) -> jax.Array:
    return pack_features_for_host(feats)


def unpack_features_host(buf: np.ndarray):
    """Host-side inverse of :func:`pack_features_for_host`.

    Returns (xy, angle, response, octave, desc, valid) numpy arrays."""
    buf = np.asarray(buf)
    xy = buf[:, 0:2].copy().view(np.float32)
    angle = buf[:, 2].copy().view(np.float32)
    response = buf[:, 3].copy().view(np.float32)
    octave = buf[:, 4].astype(np.int32)
    valid = buf[:, 5].astype(bool)
    desc = np.ascontiguousarray(buf[:, 6:14]).astype(np.uint32)
    return xy, angle, response, octave, desc, valid
