"""Jit-compiled composite kernels used by the tracking / mapping drivers.

Each factory returns a jitted function with fixed shapes (one XLA compilation
per configuration). These fuse what the reference does in separate CPU passes:
``Frame::isInFrustum`` (reference src/Frame.cc:603) + ``ORBmatcher::
SearchByProjection`` (src/ORBmatcher.cc:45) become one device kernel;
``SearchForTriangulation`` (:1107) + DLT triangulation + the CheckRT gates
(src/LocalMapping.cc:487-497 loop) become another.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops import camera as cam_ops
from ..ops import lie, matching, triangulation


@functools.lru_cache(maxsize=None)
def projection_matcher(cam_type: int, n_levels: int, scale: float,
                       octave_lo: int = 1, octave_hi: int = 1):
    """Fused frustum-check + projection-window matcher.

    Returns fn(mp_xyz (M,3), mp_desc (M,8), mp_normal (M,3), mp_mind (M,),
               mp_maxd (M,), mp_valid (M,), R, t, cam_params,
               feat_xy (N,2), feat_desc (N,8), feat_octave (N,), feat_valid (N,),
               wh (2,), base_radius (), ratio (), max_dist (), view_cos_th ())
        → (idx (M,), ok (M,), pred_uv (M,2), pred_level (M,), frustum_ok (M,))
    """
    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    log_scale = jnp.log(jnp.asarray(scale, jnp.float32))

    @jax.jit
    def fn(mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, R, t,
           cam_params, feat_xy, feat_desc, feat_octave, feat_valid, wh,
           base_radius, ratio, max_dist, view_cos_th):
        xc = lie.se3_apply(R, t, mp_xyz)
        z_ok = xc[..., 2] > 0.05
        uv = cam_ops.project(cam_type, cam_params, xc)
        in_img = (
            (uv[:, 0] >= 0) & (uv[:, 0] < wh[0]) & (uv[:, 1] >= 0) & (uv[:, 1] < wh[1])
        )
        # distance / viewing-angle gates (reference Frame::isInFrustum)
        cam_center = -R.T @ t
        d = mp_xyz - cam_center
        dist = jnp.linalg.norm(d, axis=-1)
        dist_ok = (dist > 0.8 * mp_mind) & (dist < 1.2 * mp_maxd)
        view_cos = jnp.sum(d * mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
        view_ok = view_cos > view_cos_th
        # predicted pyramid level (reference MapPoint::PredictScale)
        lvl = jnp.ceil(jnp.log(jnp.maximum(mp_maxd, 1e-9) / jnp.maximum(dist, 1e-9)) / log_scale)
        lvl = jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)
        frustum_ok = mp_valid & z_ok & in_img & dist_ok & view_ok

        radius = base_radius * sf[lvl]
        idx, best, second = matching.match_rows(
            mp_desc, uv, radius, lvl, frustum_ok,
            feat_desc, feat_xy, feat_octave, feat_valid, octave_lo, octave_hi)
        ok = best <= max_dist
        ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
        ok = matching.resolve_duplicates(idx, best, ok, feat_desc.shape[0])
        return idx, ok, uv, lvl, frustum_ok

    return fn


def matched_points(idx, ok, mp_xyz, n_feat: int):
    """Per-feature matched map point: ((n_feat,3) points, (n_feat,) valid).

    Only matched rows write. They hold distinct features
    (``resolve_duplicates``), so no write races another, whatever order the
    device runs the scatter in."""
    slot = jnp.where(ok, idx, n_feat)
    pts = jnp.zeros((n_feat, 3), mp_xyz.dtype).at[slot].set(mp_xyz, mode="drop")
    valid = jnp.zeros((n_feat,), bool).at[slot].set(True, mode="drop")
    return pts, valid


@functools.lru_cache(maxsize=None)
def frontend_step(cfg):
    """The fused per-frame front end in one jit: ORB extraction → projection
    matching against a map → pose-only LM (reference Tracking::Track's
    SearchLocalPoints + PoseOptimization, src/Tracking.cc).

    Returns fn(img (H,W), R0, t0, mp_xyz (M,3), mp_desc (M,8), mp_normal,
               mp_mind, mp_maxd, mp_valid, cam_params (4,), wh (2,))
        → (R, t, n_inliers)
    """
    from ..ops import features, pose_opt
    proj_match = projection_matcher(0, cfg.n_levels, cfg.scale)

    @jax.jit
    def fn(img, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd,
           mp_valid, cam_params, wh):
        feats = features.extract_orb(img, cfg)
        idx, ok, _, _, _ = proj_match(
            mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, R0, t0,
            cam_params, feats.xy, feats.desc, feats.octave, feats.valid, wh,
            jnp.float32(8.0), jnp.float32(0.9), jnp.int32(matching.TH_HIGH),
            jnp.float32(0.5))
        pts, valid = matched_points(idx, ok, mp_xyz, cfg.total_capacity)
        inv_s2 = 1.0 / (cfg.scale ** (2.0 * feats.octave.astype(jnp.float32)))
        res = pose_opt.pose_optimize(R0, t0, pts, feats.xy, inv_s2, valid,
                                     cam_params)
        return res.R, res.t, res.n_inliers

    return fn


@functools.lru_cache(maxsize=None)
def pose_opt_kernel(cam_type: int, rounds: int = 4, iters: int = 10,
                    n_starts: int = 1):
    from ..ops import pose_opt

    @jax.jit
    def fn(R0, t0, pts_w, uv, inv_sigma2, valid, cam_params, obs_ur=None, bf=0.0,
           prior_R=None, prior_t=None, prior_eps=0.0):
        if n_starts > 1:
            return pose_opt.pose_optimize_multistart(
                R0, t0, pts_w, uv, inv_sigma2, valid, cam_params,
                cam_type=cam_type, rounds=rounds, iters=iters,
                obs_ur=obs_ur, bf=bf, n_starts=n_starts)
        return pose_opt.pose_optimize(
            R0, t0, pts_w, uv, inv_sigma2, valid, cam_params,
            cam_type=cam_type, rounds=rounds, iters=iters,
            obs_ur=obs_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)

    return fn


@functools.lru_cache(maxsize=None)
def init_matcher():
    @jax.jit
    def fn(desc1, valid1, xy1, angle1, desc2, valid2, xy2, angle2):
        return matching.search_for_initialization(
            desc1, valid1, xy1, angle1, desc2, valid2, xy2, angle2)
    return fn


@functools.lru_cache(maxsize=None)
def two_view_kernel(sigma_n: float):
    from ..ops import twoview

    @jax.jit
    def fn(x1, x2, valid, rand_sets):
        return twoview.reconstruct_two_views(x1, x2, valid, rand_sets, sigma_n=sigma_n)
    return fn


@functools.lru_cache(maxsize=None)
def triangulation_matcher(cam_type: int, n_levels: int, scale: float):
    """Epipolar-constrained matching of unmatched features between two KFs +
    batched triangulation + acceptance gates. Operates in normalized coords.

    fn(R1,t1,R2,t2, cam_params,
       xy1 (N,2) desc1 valid1 oct1, xy2 (N,2) desc2 valid2 oct2,
       ratio, max_dist)
      → (idx (N,), ok (N,), xw (N,3))  — for each feature of KF1: matched
        feature in KF2, acceptance, triangulated world point.
    """
    sf2 = jnp.asarray([(scale ** i) ** 2 for i in range(n_levels)], jnp.float32)

    @jax.jit
    def fn(R1, t1, R2, t2, cam_params, xy1, desc1, valid1, oct1,
           xy2, desc2, valid2, oct2, ratio, max_dist, sigma_n):
        rays1 = cam_ops.unproject(cam_type, cam_params, xy1)
        rays2 = cam_ops.unproject(cam_type, cam_params, xy2)
        # relative pose c2←c1: T21 = T2 ∘ inv(T1)
        R1i, t1i = lie.se3_inverse(R1, t1)
        R21, t21 = lie.se3_compose(R2, t2, R1i, t1i)
        # essential matrix E = [t]x R (x2^T E x1 = 0)
        E = lie.hat(t21) @ R21
        # epipolar distance in *pixel* units using the pinhole focal
        l2 = rays1 @ E.T  # lines in normalized cam2 coords
        fx, fy = cam_params[0], cam_params[1]
        a = l2[:, 0] / fx
        b = l2[:, 1] / fy
        cx, cy = cam_params[2], cam_params[3]
        c = l2[:, 2] - l2[:, 0] * cx / fx - l2[:, 1] * cy / fy
        num = a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1] + c[:, None]
        dsq = (num * num) / jnp.maximum((a * a + b * b)[:, None], 1e-18)
        ep = dsq < 3.84 * sf2[oct2][None, :]

        dist = matching.hamming_matrix(desc1, desc2)
        mask = valid1[:, None] & valid2[None, :] & ep
        idx, best, ok = matching.masked_match(dist, mask, max_dist, ratio)
        ok = matching.resolve_duplicates(idx, best, ok, desc2.shape[0])

        r2m = rays2[idx]
        xw = triangulation.triangulate_dlt(R1, t1, rays1, R2, t2, r2m)
        sig_n2_1 = sigma_n * sigma_n * sf2[oct1]
        sig_n2_2 = sigma_n * sigma_n * sf2[oct2[idx]]
        tri_ok, depths = triangulation.check_triangulation(
            xw, R1, t1, rays1, R2, t2, r2m, sig_n2_1, sig_n2_2,
            min_parallax_cos=0.9998, chi2_th=5.991)
        return idx, ok & tri_ok, xw, depths

    return fn


# ---------------------------------------------------------------------------
# Packed-I/O pooled kernels (round 3).
#
# Each host↔device transfer is a synchronisation point with its own latency,
# so these kernels take the map-point pool RESIDENT ON DEVICE
# (models/device_map.py), receive only an id list + a packed pose vector,
# and return ONE packed int32 buffer.
# ---------------------------------------------------------------------------

def _pack_bits_i32(b):
    """(N,) bool → (ceil(N/32),) int32, bit i of word w = element 32·w+i
    (little-endian; host unpacks with
    np.unpackbits(buf.view(np.uint8), bitorder='little'))."""
    n = b.shape[0]
    pad = (-n) % 32
    if pad:
        b = jnp.concatenate([b, jnp.zeros(pad, bool)])
    w = (b.reshape(-1, 32).astype(jnp.uint32)
         << jnp.arange(32, dtype=jnp.uint32)[None, :])
    return jax.lax.bitcast_convert_type(jnp.sum(w, axis=1, dtype=jnp.uint32),
                                        jnp.int32)


def unpack_bits_host(buf_i32: "object", n: int):
    import numpy as np
    u8 = np.asarray(buf_i32, np.int32).view(np.uint8)
    return np.unpackbits(u8, bitorder="little")[:n].astype(bool)


def _bitcast_f2i(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)


def _gather_pool(mpf, mpu, ids):
    """Gather packed map-point rows by id (−1 ⇒ invalid)."""
    safe = jnp.maximum(ids, 0)
    f = mpf[safe]
    u = mpu[safe]
    xyz = f[:, 0:3]
    normal = f[:, 3:6]
    mind = f[:, 6]
    maxd = f[:, 7]
    desc = u[:, 0:8]
    valid = (u[:, 8] > 0) & (ids >= 0)
    return xyz, desc, normal, mind, maxd, valid


def _make_pool_matcher(cam_type: int, n_levels: int, scale: float,
                       camp, whv):
    """Frustum + projection-window + ratio-test matcher over gathered pool
    rows (the fused form of reference Frame::isInFrustum src/Frame.cc:603 +
    ORBmatcher::SearchByProjection src/ORBmatcher.cc:45), shared by the
    visual and visual-inertial fused tracking kernels."""
    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    log_scale = jnp.log(jnp.asarray(scale, jnp.float32))

    def _one_radius(dist_m, frustum, uv, lvl, feat_xy, feat_octave,
                    feat_valid, radius, ratio, max_dist, n_feat):
        mask = (frustum[:, None] & feat_valid[None, :]
                & matching.window_mask(uv, feat_xy, radius * sf[lvl])
                & matching.octave_mask(lvl, feat_octave, 1, 1))
        d_big = jnp.where(mask, dist_m, matching.BIG)
        idx = jnp.argmin(d_big, axis=1)
        best = jnp.take_along_axis(d_big, idx[:, None], axis=1)[:, 0]
        d2 = d_big.at[jnp.arange(d_big.shape[0]), idx].set(matching.BIG)
        second = jnp.min(d2, axis=1)
        ok = (best <= max_dist) & (best.astype(jnp.float32)
                                   < ratio * second.astype(jnp.float32))
        ok = matching.resolve_duplicates(idx, best, ok, n_feat)
        return idx, ok

    def _match(xyz, desc, normal, mind, maxd, mvalid, R, t,
               feat_xy, feat_desc, feat_octave, feat_valid,
               radius, ratio, max_dist, view_cos_th, retry_min=0):
        xc = lie.se3_apply(R, t, xyz)
        z_ok = xc[..., 2] > 0.05
        uv = cam_ops.project(cam_type, camp, xc)
        in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < whv[0])
                  & (uv[:, 1] >= 0) & (uv[:, 1] < whv[1]))
        cam_center = -R.T @ t
        d = xyz - cam_center
        dist = jnp.linalg.norm(d, axis=-1)
        dist_ok = (dist > 0.8 * mind) & (dist < 1.2 * maxd)
        view_cos = jnp.sum(d * normal, axis=-1) / jnp.maximum(dist, 1e-9)
        lvl = jnp.ceil(jnp.log(jnp.maximum(maxd, 1e-9)
                               / jnp.maximum(dist, 1e-9)) / log_scale)
        lvl = jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)
        frustum = (mvalid & z_ok & in_img & dist_ok
                   & (view_cos > view_cos_th))
        dist_m = matching.hamming_matrix(desc, feat_desc)
        n_feat = feat_desc.shape[0]
        idx, ok = _one_radius(dist_m, frustum, uv, lvl, feat_xy, feat_octave,
                              feat_valid, radius, ratio, max_dist, n_feat)
        if retry_min:
            # the reference's motion-model 2x-radius rescue (SURVEY A.2,
            # src/Tracking.cc:3212-3260): when the narrow window finds too
            # few matches (prediction error exceeded it), re-match at 2x.
            # The Hamming matrix is radius-independent, so the retry reuses
            # it and costs only a second masking pass — always computed,
            # selected by a scalar (fixed-shape, no host round trip). The
            # staged cascade has this rescue (tracking._track_motion_model);
            # without it here, a curvature phase whose flow exceeds the
            # window makes the fused path fail PERSISTENTLY while staged
            # rescues every frame (measured: n1 221->6 over 4 frames, then
            # ~2 forever, on the VI orbit fixture).
            idx_w, ok_w = _one_radius(dist_m, frustum, uv, lvl, feat_xy,
                                      feat_octave, feat_valid, 2.0 * radius,
                                      ratio, max_dist, n_feat)
            use_wide = jnp.sum(ok.astype(jnp.int32)) < retry_min
            idx = jnp.where(use_wide, idx_w, idx)
            ok = jnp.where(use_wide, ok_w, ok)
        return idx, ok, frustum

    return _match


@functools.lru_cache(maxsize=None)
def fused_track_pooled(cam_type: int, n_levels: int, scale: float,
                       cam_params: tuple, wh: tuple, bf: float,
                       motion_radius: float, local_radius: float,
                       motion_ratio: float, local_ratio: float,
                       th_high: int, pose_rounds: int = 2,
                       pose_iters: int = 10):
    """One-dispatch per-frame visual tracking against the device-resident
    map pool. Same cascade as :func:`fused_track_kernel` (reference
    TrackWithMotionModel src/Tracking.cc:3173 → TrackLocalMap :3296), but:

    - map-side candidates arrive as ONE id vector (first CL entries = last-
      frame points, rest = local-map points), gathered on device;
    - all scalars/intrinsics are compile-time constants;
    - the result is ONE packed int32 vector:
      [0:12]=bitcast(R,t), [12]=n1, [13]=n_inl,
      [14:14+N]=a_last, [14+N:14+2N]=a_loc (indices into the id vector),
      then packbits(frustum over the CC local candidates),
      then packbits(inlier over features).

    fn(pose_in (25,) f32, ids (CL+CC,) i32, mpf (P,8) f32, mpu (P,9) u32,
       feat_xy, feat_desc, feat_octave, feat_valid, feat_ur)
    """
    from ..ops import pose_opt as pose_ops

    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    inv_s2_lut = 1.0 / (sf * sf)
    camp = jnp.asarray(cam_params, jnp.float32)
    whv = jnp.asarray(wh, jnp.float32)
    _match = _make_pool_matcher(cam_type, n_levels, scale, camp, whv)

    @functools.partial(jax.jit, static_argnames=("cl",))
    def fn(pose_in, ids, mpf, mpu,
           feat_xy, feat_desc, feat_octave, feat_valid, feat_ur, *, cl: int):
        N = feat_xy.shape[0]
        R0 = pose_in[0:9].reshape(3, 3)
        t0 = pose_in[9:12]
        prior_R = pose_in[12:21].reshape(3, 3)
        prior_t = pose_in[21:24]
        prior_eps = pose_in[24]
        inv_s2 = inv_s2_lut[jnp.clip(feat_octave, 0, n_levels - 1)]

        ids_l = ids[:cl]
        ids_c = ids[cl:]
        l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid = \
            _gather_pool(mpf, mpu, ids_l)
        c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid = \
            _gather_pool(mpf, mpu, ids_c)

        # stage 1: last-frame points at the predicted pose
        idx1, ok1, _ = _match(l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid,
                              R0, t0, feat_xy, feat_desc, feat_octave,
                              feat_valid, motion_radius, motion_ratio,
                              th_high, 0.5, retry_min=20)
        a_last = jnp.full((N,), -1, jnp.int32).at[idx1].max(
            jnp.where(ok1, jnp.arange(cl, dtype=jnp.int32), -1))
        m1 = a_last >= 0
        pts1 = l_xyz[jnp.maximum(a_last, 0)]
        res1 = pose_ops.pose_optimize(
            R0, t0, pts1, feat_xy, inv_s2, m1 & feat_valid, camp,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        a_last = jnp.where(res1.inlier & m1, a_last, -1)

        # stage 2: local-map points at the refined pose
        idx2, ok2, frustum2 = _match(
            c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid,
            res1.R, res1.t, feat_xy, feat_desc, feat_octave,
            feat_valid & (a_last < 0), local_radius, local_ratio,
            th_high, 0.5)
        cc = ids_c.shape[0]
        a_loc = jnp.full((N,), -1, jnp.int32).at[idx2].max(
            jnp.where(ok2, jnp.arange(cc, dtype=jnp.int32), -1))
        a_loc = jnp.where(a_last >= 0, -1, a_loc)
        m2 = (a_last >= 0) | (a_loc >= 0)
        pts2 = jnp.where((a_last >= 0)[:, None],
                         l_xyz[jnp.maximum(a_last, 0)],
                         c_xyz[jnp.maximum(a_loc, 0)])
        res2 = pose_ops.pose_optimize(
            res1.R, res1.t, pts2, feat_xy, inv_s2, m2 & feat_valid, camp,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        a_last = jnp.where(res2.inlier, a_last, -1)
        a_loc = jnp.where(res2.inlier, a_loc, -1)
        n1 = jnp.sum((m1 & feat_valid).astype(jnp.int32))
        out = jnp.concatenate([
            _bitcast_f2i(res2.R.reshape(-1)),
            _bitcast_f2i(res2.t),
            jnp.stack([n1, res2.n_inliers.astype(jnp.int32)]),
            a_last, a_loc,
            _pack_bits_i32(frustum2),
            _pack_bits_i32(res2.inlier),
        ])
        return out

    return fn


@functools.lru_cache(maxsize=None)
def fused_track_vi_pooled(cam_type: int, n_levels: int, scale: float,
                          cam_params: tuple, wh: tuple, bf: float,
                          motion_radius: float, local_radius: float,
                          motion_ratio: float, local_ratio: float,
                          th_high: int, sigma_gw: float, sigma_aw: float,
                          pose_rounds: int = 2, pose_iters: int = 10):
    """One-dispatch per-frame VISUAL-INERTIAL tracking against the device-
    resident map pool — the post-IMU-init per-frame hot path as a single
    device call (the reference runs PredictStateIMU src/Tracking.cc:1616 →
    SearchByProjection → PoseOptimization → TrackLocalMap →
    PoseInertialOptimizationLastFrame src/Optimizer.cc:7785 inside the frame
    budget; here prediction, both matching stages, the visual LM and the
    15-dim inertial frame solve fuse into one dispatch).

    Stages (all on device):
      1. IMU state propagation from the previous frame's body state through
         the per-frame preintegration (PredictStateIMU).
      2. last-frame candidates matched at the predicted pose → visual pose
         LM with a weak prior anchored at the prediction.
      3. local-map candidates matched at the refined pose.
      4. pose_inertial_optimize: current pose+velocity+biases against the
         previous 15-dim state through the preintegration edge + bias
         random-walk edges + the carried ConstraintPoseImu marginal prior.

    fn(vi_state (247,) f32, ids (CL+CC,) i32, mpf, mpu,
       feat_xy, feat_desc, feat_octave, feat_valid, feat_ur,
       pre: PreintState, cl: static) → packed int32:
      [0:12]=bitcast(R,t), [12]=n1, [13]=n_inl, [14:14+N]=a_last,
      [14+N:14+2N]=a_loc, packbits(frustum over CC), packbits(inlier),
      then bitcast f32: v(3), bg(3), ba(3), H_marg(225).

    vi_state = [R1_wb(9), p1_wb(3), v1(3), bg(3), ba(3),
                prior_H(225; pass σ⁻²≈1e6·I when no prior is carried),
                prior_eps_visual(1)].
    """
    from ..ops import pose_opt as pose_ops
    from ..ops import vi_ba as vi_ops
    from ..ops import imu as imu_ops

    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    inv_s2_lut = 1.0 / (sf * sf)
    camp = jnp.asarray(cam_params, jnp.float32)
    whv = jnp.asarray(wh, jnp.float32)
    _match = _make_pool_matcher(cam_type, n_levels, scale, camp, whv)

    @functools.partial(jax.jit, static_argnames=("cl",))
    def fn(vi_state, ids, mpf, mpu,
           feat_xy, feat_desc, feat_octave, feat_valid, feat_ur,
           pre: "imu_ops.PreintState", *, cl: int):
        N = feat_xy.shape[0]
        R1_wb = vi_state[0:9].reshape(3, 3)
        p1_wb = vi_state[9:12]
        v1 = vi_state[12:15]
        bg = vi_state[15:18]
        ba = vi_state[18:21]
        prior_H = vi_state[21:246].reshape(15, 15)
        prior_eps = vi_state[246]
        inv_s2 = inv_s2_lut[jnp.clip(feat_octave, 0, n_levels - 1)]

        # 1. PredictStateIMU: propagate the previous body state through the
        # preintegrated deltas (corrected to the current bias estimate)
        dR_c, dV_c, dP_c = imu_ops.corrected_delta(pre, bg, ba)
        g = jnp.asarray([0.0, 0.0, -imu_ops.GRAVITY], jnp.float32)
        dT = pre.dT
        R2_wb = R1_wb @ dR_c
        p2_wb = (p1_wb + v1 * dT + 0.5 * g * dT * dT + R1_wb @ dP_c)
        v2 = v1 + g * dT + R1_wb @ dV_c
        R0 = R2_wb.T
        t0 = -R2_wb.T @ p2_wb

        ids_l = ids[:cl]
        ids_c = ids[cl:]
        l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid = \
            _gather_pool(mpf, mpu, ids_l)
        c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid = \
            _gather_pool(mpf, mpu, ids_c)

        # 2. last-frame points at the IMU-predicted pose; visual LM refines
        # (reference TrackWithMotionModel with PredictStateIMU seed)
        idx1, ok1, _ = _match(l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid,
                              R0, t0, feat_xy, feat_desc, feat_octave,
                              feat_valid, motion_radius, motion_ratio,
                              th_high, 0.5, retry_min=20)
        a_last = jnp.full((N,), -1, jnp.int32).at[idx1].max(
            jnp.where(ok1, jnp.arange(cl, dtype=jnp.int32), -1))
        m1 = a_last >= 0
        pts1 = l_xyz[jnp.maximum(a_last, 0)]
        res1 = pose_ops.pose_optimize(
            R0, t0, pts1, feat_xy, inv_s2, m1 & feat_valid, camp,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf,
            prior_R=R0, prior_t=t0, prior_eps=prior_eps)
        a_last = jnp.where(res1.inlier & m1, a_last, -1)

        # 3. local-map points at the refined pose
        idx2, ok2, frustum2 = _match(
            c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid,
            res1.R, res1.t, feat_xy, feat_desc, feat_octave,
            feat_valid & (a_last < 0), local_radius, local_ratio,
            th_high, 0.5)
        cc = ids_c.shape[0]
        a_loc = jnp.full((N,), -1, jnp.int32).at[idx2].max(
            jnp.where(ok2, jnp.arange(cc, dtype=jnp.int32), -1))
        a_loc = jnp.where(a_last >= 0, -1, a_loc)
        m2 = (a_last >= 0) | (a_loc >= 0)
        pts2 = jnp.where((a_last >= 0)[:, None],
                         l_xyz[jnp.maximum(a_last, 0)],
                         c_xyz[jnp.maximum(a_loc, 0)])

        # 4. visual-inertial frame optimization with the marginal prior
        res2 = vi_ops.pose_inertial_optimize(
            res1.R, res1.t, v2, R1_wb, p1_wb, v1,
            bg, ba, dT, dR_c, dV_c, dP_c,
            pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, pre.C[:9, :9],
            pts2, feat_xy, inv_s2, m2 & feat_valid, camp,
            cam_type=cam_type, sigma_gw=sigma_gw, sigma_aw=sigma_aw,
            prior_H=prior_H)
        a_last = jnp.where(res2.inlier, a_last, -1)
        a_loc = jnp.where(res2.inlier, a_loc, -1)
        n1 = jnp.sum((m1 & feat_valid).astype(jnp.int32))
        out = jnp.concatenate([
            _bitcast_f2i(res2.R.reshape(-1)),
            _bitcast_f2i(res2.t),
            jnp.stack([n1, res2.n_inliers.astype(jnp.int32)]),
            a_last, a_loc,
            _pack_bits_i32(frustum2),
            _pack_bits_i32(res2.inlier),
            _bitcast_f2i(res2.v),
            _bitcast_f2i(res2.bg),
            _bitcast_f2i(res2.ba),
            _bitcast_f2i(res2.H_marg.reshape(-1)),
        ])
        return out

    return fn


@functools.lru_cache(maxsize=None)
def projection_assign_pooled(cam_type: int, n_levels: int, scale: float,
                             cam_params: tuple, wh: tuple,
                             radius: float, ratio: float, max_dist: int,
                             view_cos_th: float,
                             octave_lo: int = 1, octave_hi: int = 1):
    """Pooled projection matcher: candidates as an id vector into the
    device-resident pool, ONE packed int32 result:
    [0:C]=idx, then packbits(ok), then packbits(frustum).

    fn(pose (12,) f32, ids (C,) i32, mpf, mpu,
       feat_xy, feat_desc, feat_octave, feat_valid)"""
    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    log_scale = jnp.log(jnp.asarray(scale, jnp.float32))
    camp = jnp.asarray(cam_params, jnp.float32)
    whv = jnp.asarray(wh, jnp.float32)

    @jax.jit
    def fn(pose, ids, mpf, mpu, feat_xy, feat_desc, feat_octave, feat_valid):
        R = pose[0:9].reshape(3, 3)
        t = pose[9:12]
        xyz, desc, normal, mind, maxd, mvalid = _gather_pool(mpf, mpu, ids)
        xc = lie.se3_apply(R, t, xyz)
        z_ok = xc[..., 2] > 0.05
        uv = cam_ops.project(cam_type, camp, xc)
        in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < whv[0])
                  & (uv[:, 1] >= 0) & (uv[:, 1] < whv[1]))
        cam_center = -R.T @ t
        d = xyz - cam_center
        dist = jnp.linalg.norm(d, axis=-1)
        dist_ok = (dist > 0.8 * mind) & (dist < 1.2 * maxd)
        view_cos = jnp.sum(d * normal, axis=-1) / jnp.maximum(dist, 1e-9)
        lvl = jnp.ceil(jnp.log(jnp.maximum(maxd, 1e-9)
                               / jnp.maximum(dist, 1e-9)) / log_scale)
        lvl = jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)
        frustum = (mvalid & z_ok & in_img & dist_ok
                   & (view_cos > view_cos_th))
        dist_m = matching.hamming_matrix(desc, feat_desc)
        mask = (frustum[:, None] & feat_valid[None, :]
                & matching.window_mask(uv, feat_xy, radius * sf[lvl])
                & matching.octave_mask(lvl, feat_octave, octave_lo, octave_hi))
        d_big = jnp.where(mask, dist_m, matching.BIG)
        idx = jnp.argmin(d_big, axis=1)
        best = jnp.take_along_axis(d_big, idx[:, None], axis=1)[:, 0]
        d2 = d_big.at[jnp.arange(d_big.shape[0]), idx].set(matching.BIG)
        second = jnp.min(d2, axis=1)
        ok = (best <= max_dist) & (best.astype(jnp.float32)
                                   < ratio * second.astype(jnp.float32))
        ok = matching.resolve_duplicates(idx, best, ok, feat_desc.shape[0])
        return jnp.concatenate([idx.astype(jnp.int32),
                                _pack_bits_i32(ok),
                                _pack_bits_i32(frustum)])

    return fn


@functools.lru_cache(maxsize=None)
def pose_opt_pooled(cam_type: int, cam_params: tuple, bf: float,
                    n_levels: int, scale: float,
                    rounds: int = 4, iters: int = 10):
    """Pooled pose-only LM: world points gathered on device from the resident
    pool by the frame's feature→point assignment. ONE packed int32 result:
    [0:12]=bitcast(R,t), [12]=n_inl, then packbits(inlier).

    fn(pose_in (25,) f32, feat_mp (N,) i32, mpf,
       feat_xy, feat_octave, feat_valid, feat_ur)"""
    from ..ops import pose_opt as pose_ops
    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    inv_s2_lut = 1.0 / (sf * sf)
    camp = jnp.asarray(cam_params, jnp.float32)

    @jax.jit
    def fn(pose_in, feat_mp, mpf, feat_xy, feat_octave, feat_valid, feat_ur):
        R0 = pose_in[0:9].reshape(3, 3)
        t0 = pose_in[9:12]
        prior_R = pose_in[12:21].reshape(3, 3)
        prior_t = pose_in[21:24]
        prior_eps = pose_in[24]
        matched = feat_mp >= 0
        pts = mpf[jnp.maximum(feat_mp, 0), 0:3]
        inv_s2 = inv_s2_lut[jnp.clip(feat_octave, 0, n_levels - 1)]
        res = pose_ops.pose_optimize(
            R0, t0, pts, feat_xy, inv_s2, matched & feat_valid, camp,
            cam_type=cam_type, rounds=rounds, iters=iters,
            obs_ur=feat_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        return jnp.concatenate([
            _bitcast_f2i(res.R.reshape(-1)),
            _bitcast_f2i(res.t),
            res.n_inliers.astype(jnp.int32)[None],
            _pack_bits_i32(res.inlier),
        ])

    return fn


@functools.lru_cache(maxsize=None)
def fused_track_kernel(cam_type: int, n_levels: int, scale: float,
                       pose_rounds: int = 2, pose_iters: int = 10):
    """ONE dispatch for the per-frame visual hot path (VERDICT r1 #2: the
    system made 6-10 separate device calls per frame, each with its own
    dispatch and transfer):

        match(last-frame points → features) → pose LM →
        match(local-map points → features, at the refined pose) → pose LM →
        final chi2 classification.

    The reference runs the same cascade as separate CPU stages
    (TrackWithMotionModel src/Tracking.cc:3173 → TrackLocalMap :3296).

    Returns per-FEATURE assignments into the two candidate buffers plus the
    refined pose, so the host writes bookkeeping once per frame.
    """
    from ..ops import pose_opt as pose_ops

    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    inv_s2_lut = 1.0 / (sf * sf)
    log_scale = jnp.log(jnp.asarray(scale, jnp.float32))

    def _match(mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid,
               R, t, cam_params, feat_xy, feat_desc, feat_octave, feat_valid,
               wh, radius, ratio, max_dist, view_cos_th):
        xc = lie.se3_apply(R, t, mp_xyz)
        z_ok = xc[..., 2] > 0.05
        uv = cam_ops.project(cam_type, cam_params, xc)
        in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < wh[0])
                  & (uv[:, 1] >= 0) & (uv[:, 1] < wh[1]))
        cam_center = -R.T @ t
        d = mp_xyz - cam_center
        dist = jnp.linalg.norm(d, axis=-1)
        dist_ok = (dist > 0.8 * mp_mind) & (dist < 1.2 * mp_maxd)
        view_cos = jnp.sum(d * mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
        lvl = jnp.ceil(jnp.log(jnp.maximum(mp_maxd, 1e-9)
                               / jnp.maximum(dist, 1e-9)) / log_scale)
        lvl = jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)
        frustum = (mp_valid & z_ok & in_img & dist_ok
                   & (view_cos > view_cos_th))
        dist_m = matching.hamming_matrix(mp_desc, feat_desc)
        mask = (frustum[:, None] & feat_valid[None, :]
                & matching.window_mask(uv, feat_xy, radius * sf[lvl])
                & matching.octave_mask(lvl, feat_octave, 1, 1))
        d_big = jnp.where(mask, dist_m, matching.BIG)
        idx = jnp.argmin(d_big, axis=1)
        best = jnp.take_along_axis(d_big, idx[:, None], axis=1)[:, 0]
        d2 = d_big.at[jnp.arange(d_big.shape[0]), idx].set(matching.BIG)
        second = jnp.min(d2, axis=1)
        ok = (best <= max_dist) & (best.astype(jnp.float32)
                                   < ratio * second.astype(jnp.float32))
        ok = matching.resolve_duplicates(idx, best, ok, feat_desc.shape[0])
        return idx, ok, frustum

    @jax.jit
    def fn(R0, t0, prior_R, prior_t, prior_eps,
           last_xyz, last_desc, last_norm, last_mind, last_maxd, last_valid,
           loc_xyz, loc_desc, loc_norm, loc_mind, loc_maxd, loc_valid,
           feat_xy, feat_desc, feat_octave, feat_valid, feat_ur,
           cam_params, wh, bf,
           motion_radius, local_radius, motion_ratio, local_ratio, th_high):
        N = feat_xy.shape[0]
        inv_s2 = inv_s2_lut[jnp.clip(feat_octave, 0, n_levels - 1)]

        # stage 1: last-frame points at the predicted pose
        idx1, ok1, _ = _match(last_xyz, last_desc, last_norm, last_mind,
                              last_maxd, last_valid, R0, t0, cam_params,
                              feat_xy, feat_desc, feat_octave, feat_valid,
                              wh, motion_radius, motion_ratio, th_high, 0.5)
        # per-feature: candidate index into the LAST buffer
        a_last = jnp.full((N,), -1, jnp.int32).at[idx1].max(
            jnp.where(ok1, jnp.arange(last_xyz.shape[0], dtype=jnp.int32), -1))
        m1 = a_last >= 0
        pts1 = last_xyz[jnp.maximum(a_last, 0)]
        res1 = pose_ops.pose_optimize(
            R0, t0, pts1, feat_xy, inv_s2, m1 & feat_valid, cam_params,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        a_last = jnp.where(res1.inlier & m1, a_last, -1)

        # stage 2: local-map points at the refined pose (features still free)
        idx2, ok2, frustum2 = _match(
            loc_xyz, loc_desc, loc_norm, loc_mind, loc_maxd, loc_valid,
            res1.R, res1.t, cam_params, feat_xy, feat_desc, feat_octave,
            feat_valid & (a_last < 0), wh, local_radius, local_ratio,
            th_high, 0.5)
        a_loc = jnp.full((N,), -1, jnp.int32).at[idx2].max(
            jnp.where(ok2, jnp.arange(loc_xyz.shape[0], dtype=jnp.int32), -1))
        a_loc = jnp.where(a_last >= 0, -1, a_loc)
        m2 = (a_last >= 0) | (a_loc >= 0)
        pts2 = jnp.where((a_last >= 0)[:, None], last_xyz[jnp.maximum(a_last, 0)],
                         loc_xyz[jnp.maximum(a_loc, 0)])
        res2 = pose_ops.pose_optimize(
            res1.R, res1.t, pts2, feat_xy, inv_s2, m2 & feat_valid, cam_params,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        a_last = jnp.where(res2.inlier, a_last, -1)
        a_loc = jnp.where(res2.inlier, a_loc, -1)
        n1 = jnp.sum((m1 & feat_valid).astype(jnp.int32))
        return (res2.R, res2.t, a_last, a_loc, res2.inlier,
                res2.n_inliers, n1, frustum2)

    return fn


@functools.lru_cache(maxsize=None)
def triangulation_batched(cam_type: int, n_levels: int, scale: float,
                          cam_params: tuple, cap_new: int = 2048,
                          max_dist: int = 50, sigma_n: float = 1.0):
    """Epipolar matching + DLT triangulation of the new keyframe against ALL
    covisible neighbors in ONE dispatch (reference CreateNewMapPoints loop,
    src/LocalMapping.cc:487-497; not one dispatch and one transfer per
    neighbor).

    fn(pose1 (12,), xy1 (N,2), desc1 (N,8), oct1 (N,), un1 (N,) bool,
       nb_ids (B,) i32, nb_valid (B,) bool, poses2 (B,12), un2 (B,N) bool,
       pool_xy (Kc,N,2), pool_desc (Kc,N,8), pool_oct (Kc,N))
    → packed i32 (1 + cap_new·6):
      [0]=count, then per row: f1, f2, b, and xw bitcast (3).
    """
    from ..ops import triangulation
    sf2 = jnp.asarray([(scale ** i) ** 2 for i in range(n_levels)], jnp.float32)
    camp = jnp.asarray(cam_params, jnp.float32)
    sig = float(sigma_n)

    def pair(R1, t1, rays1, desc1, oct1, un1, pose2, xy2, desc2, oct2, un2):
        R2 = pose2[0:9].reshape(3, 3)
        t2 = pose2[9:12]
        rays2 = cam_ops.unproject(cam_type, camp, xy2)
        R1i, t1i = lie.se3_inverse(R1, t1)
        R21, t21 = lie.se3_compose(R2, t2, R1i, t1i)
        E = lie.hat(t21) @ R21
        l2 = rays1 @ E.T
        fx, fy = camp[0], camp[1]
        a = l2[:, 0] / fx
        b = l2[:, 1] / fy
        cx, cy = camp[2], camp[3]
        c = l2[:, 2] - l2[:, 0] * cx / fx - l2[:, 1] * cy / fy
        num = (a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1]
               + c[:, None])
        dsq = (num * num) / jnp.maximum((a * a + b * b)[:, None], 1e-18)
        ep = dsq < 3.84 * sf2[oct2][None, :]
        dist = matching.hamming_matrix(desc1, desc2)
        mask = un1[:, None] & un2[None, :] & ep
        idx, best, ok = matching.masked_match(dist, mask, max_dist, 1.0)
        ok = matching.resolve_duplicates(idx, best, ok, desc2.shape[0])
        r2m = rays2[idx]
        xw = triangulation.triangulate_dlt(R1, t1, rays1, R2, t2, r2m)
        s1 = sig * sig * sf2[oct1]
        s2 = sig * sig * sf2[oct2[idx]]
        tri_ok, depths = triangulation.check_triangulation(
            xw, R1, t1, rays1, R2, t2, r2m, s1, s2,
            min_parallax_cos=0.9998, chi2_th=5.991)
        return idx, ok & tri_ok, xw

    @jax.jit
    def fn(pose1, xy1, desc1, oct1, un1, nb_ids, nb_valid, poses2, un2,
           pool_xy, pool_desc, pool_oct):
        N = xy1.shape[0]
        B = nb_ids.shape[0]
        R1 = pose1[0:9].reshape(3, 3)
        t1 = pose1[9:12]
        rays1 = cam_ops.unproject(cam_type, camp, xy1)
        safe = jnp.maximum(nb_ids, 0)
        xy2 = pool_xy[safe]
        desc2 = pool_desc[safe]
        oct2 = pool_oct[safe]
        idx, ok, xw = jax.vmap(
            lambda p2, x2, d2, o2, u2: pair(R1, t1, rays1, desc1, oct1, un1,
                                            p2, x2, d2, o2, u2)
        )(poses2, xy2, desc2, oct2, un2)
        ok = ok & nb_valid[:, None] & (nb_ids >= 0)[:, None]
        ok_flat = ok.reshape(-1)
        sel = jnp.nonzero(ok_flat, size=cap_new, fill_value=B * N)[0]
        got = sel < B * N
        count = jnp.sum(got.astype(jnp.int32))
        sel_c = jnp.minimum(sel, B * N - 1)
        b = (sel_c // N).astype(jnp.int32)
        f1 = (sel_c % N).astype(jnp.int32)
        f2 = idx.reshape(-1)[sel_c].astype(jnp.int32)
        xw_sel = xw.reshape(-1, 3)[sel_c]
        f1 = jnp.where(got, f1, -1)
        return jnp.concatenate([
            count[None], f1, f2, b,
            _bitcast_f2i(xw_sel[:, 0]),
            _bitcast_f2i(xw_sel[:, 1]),
            _bitcast_f2i(xw_sel[:, 2]),
        ])

    return fn


@functools.lru_cache(maxsize=None)
def fuse_batched(cam_type: int, n_levels: int, scale: float,
                 cam_params: tuple, wh: tuple, cap_cand: int = 4096,
                 cap_out: int = 4096, radius: float = 3.0,
                 max_dist: int = 50):
    """Projection fuse of candidate map points into MULTIPLE target keyframes
    in ONE dispatch (reference SearchInNeighbors → ORBmatcher::Fuse,
    src/LocalMapping.cc:925, src/ORBmatcher.cc:1823).

    fn(tgt_ids (T,) i32, tgt_poses (T,12) f32, tgt_fvalid (T,N) bool,
       cand_ids (T,C) i32, mpf, mpu, pool_xy, pool_desc, pool_oct)
    → packed i32: [0]=count, rows (cap_out): t, c, feat  (candidate c of
      target t matched feature `feat`).
    """
    sf = jnp.asarray([scale ** i for i in range(n_levels)], jnp.float32)
    log_scale = jnp.log(jnp.asarray(scale, jnp.float32))
    camp = jnp.asarray(cam_params, jnp.float32)
    whv = jnp.asarray(wh, jnp.float32)

    def one_target(pose, fvalid, cids, mpf, mpu, xy2, desc2, oct2):
        R = pose[0:9].reshape(3, 3)
        t = pose[9:12]
        xyz, desc, normal, mind, maxd, mvalid = _gather_pool(mpf, mpu, cids)
        xc = lie.se3_apply(R, t, xyz)
        z_ok = xc[..., 2] > 0.05
        uv = cam_ops.project(cam_type, camp, xc)
        in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < whv[0])
                  & (uv[:, 1] >= 0) & (uv[:, 1] < whv[1]))
        cam_center = -R.T @ t
        d = xyz - cam_center
        dist = jnp.linalg.norm(d, axis=-1)
        dist_ok = (dist > 0.8 * mind) & (dist < 1.2 * maxd)
        view_cos = jnp.sum(d * normal, axis=-1) / jnp.maximum(dist, 1e-9)
        lvl = jnp.ceil(jnp.log(jnp.maximum(maxd, 1e-9)
                               / jnp.maximum(dist, 1e-9)) / log_scale)
        lvl = jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)
        frustum = mvalid & z_ok & in_img & dist_ok & (view_cos > 0.5)
        dist_m = matching.hamming_matrix(desc, desc2)
        mask = (frustum[:, None] & fvalid[None, :]
                & matching.window_mask(uv, xy2, radius * sf[lvl])
                & matching.octave_mask(lvl, oct2, 1, 1))
        d_big = jnp.where(mask, dist_m, matching.BIG)
        idx = jnp.argmin(d_big, axis=1)
        best = jnp.take_along_axis(d_big, idx[:, None], axis=1)[:, 0]
        ok = best <= max_dist
        ok = matching.resolve_duplicates(idx, best, ok, desc2.shape[0])
        return idx, ok

    @jax.jit
    def fn(tgt_ids, tgt_poses, tgt_fvalid, cand_ids, mpf, mpu,
           pool_xy, pool_desc, pool_oct):
        T, C = cand_ids.shape
        safe = jnp.maximum(tgt_ids, 0)
        xy2 = pool_xy[safe]
        desc2 = pool_desc[safe]
        oct2 = pool_oct[safe]
        idx, ok = jax.vmap(
            lambda pose, fv, ci, x2, d2, o2:
                one_target(pose, fv, ci, mpf, mpu, x2, d2, o2)
        )(tgt_poses, tgt_fvalid, cand_ids, xy2, desc2, oct2)
        ok = ok & (tgt_ids >= 0)[:, None]
        ok_flat = ok.reshape(-1)
        sel = jnp.nonzero(ok_flat, size=cap_out, fill_value=T * C)[0]
        got = sel < T * C
        count = jnp.sum(got.astype(jnp.int32))
        sel_c = jnp.minimum(sel, T * C - 1)
        t_i = (sel_c // C).astype(jnp.int32)
        c_i = (sel_c % C).astype(jnp.int32)
        f_i = idx.reshape(-1)[sel_c].astype(jnp.int32)
        t_i = jnp.where(got, t_i, -1)
        return jnp.concatenate([count[None], t_i, c_i, f_i])

    return fn


@functools.lru_cache(maxsize=None)
def ba_result_packer():
    """Pack a BAResult into ONE int32 buffer for a single device→host pull:
    [bitcast R (K·9) | bitcast t (K·3) | bitcast pts (P·3) |
     packbits(obs_inlier)]."""
    @jax.jit
    def fn(R, t, pts, obs_inlier):
        return jnp.concatenate([
            _bitcast_f2i(R.astype(jnp.float32).reshape(-1)),
            _bitcast_f2i(t.astype(jnp.float32).reshape(-1)),
            _bitcast_f2i(pts.astype(jnp.float32).reshape(-1)),
            _pack_bits_i32(obs_inlier),
        ])
    return fn
