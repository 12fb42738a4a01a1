"""Smoke run of the SLAM main path on the GPU, compared with plain references.

    python chip_smoke.py               # phases 1-6 on one GPU
    python chip_smoke.py --four-cards  # phase 7 alone, on four GPUs

1. device: the default JAX device must be a GPU; prints its kind and count,
   each card's name and power limit, and whether the native map ops loaded.
2. projection matcher (models/kernels.projection_matcher) at 4096 map points
   x 1024 features (OrbConfig(n_features=1024).total_capacity) against a
   numpy brute-force top-2 search: exact.
3. local BA (ops/ba.local_ba) at K=16/64/256, P=4096, O=16384, and on a
   256-keyframe loop where every keyframe sees 1024 points, on the GPU
   against the same jit on the CPU backend, whose float32 dot ignores the
   precision setting (so the reference is HIGHEST).
4. fused front-end step (ORB extraction + projection matching + pose LM,
   752x480, 1024 features, 4096-point map) on the GPU against the CPU backend.
5. monocular SLAM through SlamSystem (async mapping, loop closing on).
6. stereo-inertial SLAM through SlamSystem (pipelined, so the fused
   visual-inertial dispatch runs once the IMU has initialized).
7. (--four-cards) landmark-sharded global BA at 256 keyframes across four
   GPUs against single-device BA on the first.

Every phase raises on failure. The last line of standard output is one JSON
object naming the device; nothing is printed there unless every phase passed.
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

BIG = 10_000            # ops/matching.BIG: the distance of a masked pair


class CompileLog:
    """Counts XLA backend compiles and their seconds (jax.monitoring)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.n = 0
        self.secs = 0.0

    def __call__(self, event, duration, **kw):
        if event == self.EVENT:
            self.n += 1
            self.secs += duration


def phase_device(n_devices: int = 1):
    from orbslam3_jax import native
    from orbslam3_jax.utils.gpu import card_name_and_power_limit, require_gpu
    devs = require_gpu(n_devices)
    print(f"[1] device_kind={devs[0].device_kind} platform={devs[0].platform} "
          f"count={len(devs)}")
    for line in card_name_and_power_limit():
        print(line)
    print(f"[1] native map ops loaded: {native.available()}")
    return devs


# ---------------------------------------------------------------------------
# 2. projection matcher
# ---------------------------------------------------------------------------

def matcher_problem(n_mp: int = 4096, n_feat: int = 1024, w: int = 752,
                    h: int = 480, n_levels: int = 8, scale: float = 1.2,
                    seed: int = 0):
    """Map points projecting near a frame's features, with descriptors that
    are perturbed copies of theirs. It holds masked rows (invalid points,
    points behind the camera) and repeated feature descriptors (distance
    ties). Camera at the origin looking +z."""
    rng = np.random.default_rng(seed)
    K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
    feat_xy = rng.uniform([0, 0], [w, h], (n_feat, 2)).astype(np.float32)
    feat_desc = rng.integers(0, 2**32, (n_feat, 8), dtype=np.uint32)
    rep = rng.choice(n_feat, n_feat // 8, replace=False)
    feat_desc[rep] = feat_desc[rng.choice(n_feat, len(rep))]
    feat_oct = rng.integers(0, n_levels, n_feat).astype(np.int32)
    feat_valid = rng.random(n_feat) < 0.95

    src = rng.integers(0, n_feat, n_mp)
    z = rng.uniform(2.0, 20.0, n_mp)
    uv = feat_xy[src] + rng.normal(0.0, 3.0, (n_mp, 2))
    xyz = np.stack([(uv[:, 0] - K[2]) / K[0] * z,
                    (uv[:, 1] - K[3]) / K[1] * z, z], -1)
    n_flip = rng.integers(0, 48, n_mp)
    bits = rng.random((n_mp, 256)) < (n_flip / 256.0)[:, None]
    flip = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    mp_desc = feat_desc[src] ^ flip
    dist = np.linalg.norm(xyz, axis=1)
    mp_maxd = dist * scale ** feat_oct[src]
    mp_mind = mp_maxd / scale ** (n_levels - 1)
    mp_normal = xyz / dist[:, None]
    mp_valid = rng.random(n_mp) < 0.9
    xyz[: n_mp // 32, 2] *= -1.0                      # behind the camera
    f32 = lambda a: np.asarray(a, np.float32)
    mp = (f32(xyz), mp_desc, f32(mp_normal), f32(mp_mind), f32(mp_maxd),
          mp_valid)
    frame = (feat_xy, feat_desc, feat_oct, feat_valid)
    return mp, frame, K, np.array([w, h], np.float32)


def match_rows_reference(mp_desc, pred_xy, radius, pred_octave, row_ok,
                         feat_desc, feat_xy, feat_octave, feat_valid,
                         octave_lo=1, octave_hi=1, chunk=256):
    """Numpy brute force of ops/matching.match_rows: every (row, feature)
    pair, masked, then the row's nearest and second-nearest distance."""
    n = len(mp_desc)
    idx = np.zeros(n, np.int32)
    best = np.full(n, BIG, np.int32)
    second = np.full(n, BIG, np.int32)
    for r0 in range(0, n, chunk):
        s = slice(r0, r0 + chunk)
        dist = np.bitwise_count(
            mp_desc[s, None, :] ^ feat_desc[None, :, :]).sum(-1)
        dx = np.abs(pred_xy[s, None, 0] - feat_xy[None, :, 0])
        dy = np.abs(pred_xy[s, None, 1] - feat_xy[None, :, 1])
        r = radius[s, None]
        do = feat_octave[None, :] - pred_octave[s, None]
        mask = (row_ok[s, None] & feat_valid[None, :] & (dx <= r) & (dy <= r)
                & (do >= -octave_lo) & (do <= octave_hi))
        d = np.where(mask, dist, BIG).astype(np.int32)
        i = np.argmin(d, axis=1)
        rows = np.arange(d.shape[0])
        idx[s] = i
        best[s] = d[rows, i]
        d[rows, i] = BIG
        second[s] = d.min(axis=1)
    return idx, best, second


def projection_ok_reference(idx, best, second, max_dist, ratio):
    """Distance and ratio tests, then one row per feature: the lowest
    distance, ties to the lowest row (ops/matching.resolve_duplicates)."""
    ok = (best <= max_dist) & (best.astype(np.float32)
                               < np.float32(ratio) * second.astype(np.float32))
    rows = np.nonzero(ok)[0]
    rows = rows[np.lexsort((rows, best[rows], idx[rows]))]
    first = np.ones(len(rows), bool)
    first[1:] = idx[rows][1:] != idx[rows][:-1]
    keep = np.zeros_like(ok)
    keep[rows[first]] = True
    return keep


def phase_matcher(n_mp=4096, n_features=1024, timing_reps=50):
    import jax
    import jax.numpy as jnp
    from orbslam3_jax.models import kernels
    from orbslam3_jax.ops import features, matching
    cfg = features.OrbConfig(n_features=n_features)
    mp, frame, K, wh = matcher_problem(n_mp, cfg.total_capacity,
                                       n_levels=cfg.n_levels, scale=cfg.scale)
    base_radius, ratio, max_dist, view_cos = 8.0, 0.9, 100, 0.5
    proj = kernels.projection_matcher(0, cfg.n_levels, cfg.scale)
    args = (*mp, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), K,
            *frame, wh, np.float32(base_radius), np.float32(ratio),
            np.int32(max_dist), np.float32(view_cos))
    args = tuple(jnp.asarray(a) for a in args)
    idx, ok, uv, lvl, frustum = jax.block_until_ready(proj(*args))
    uv, lvl, frustum = np.asarray(uv), np.asarray(lvl), np.asarray(frustum)
    sf = np.asarray([cfg.scale ** i for i in range(cfg.n_levels)], np.float32)
    radius = np.float32(base_radius) * sf[lvl]
    feat_xy, feat_desc, feat_oct, feat_valid = frame
    rows_args = (mp[1], uv, radius, lvl, frustum, feat_desc, feat_xy,
                 feat_oct, feat_valid)
    # the device's own best/second come from the row search it runs
    d_idx, d_best, d_second = map(np.asarray, jax.jit(matching.match_rows)(
        *(jnp.asarray(a) for a in rows_args)))
    r_idx, r_best, r_second = match_rows_reference(*rows_args)
    r_ok = projection_ok_reference(r_idx, r_best, r_second, max_dist, ratio)
    for name, got, want in (("idx", np.asarray(idx), r_idx),
                            ("idx(match_rows)", d_idx, r_idx),
                            ("best", d_best, r_best),
                            ("second", d_second, r_second),
                            ("ok", np.asarray(ok), r_ok)):
        n_bad = int((got != want).sum())
        if n_bad:
            raise AssertionError(f"matcher {name}: {n_bad} of {len(want)} "
                                 "rows differ from the numpy reference")
    n_cand = int((r_best < BIG).sum())
    if (n_cand < len(r_best) // 4 or int(r_ok.sum()) == 0
            or int(frustum.sum()) == len(frustum)):
        raise AssertionError(f"matcher fixture too easy: {n_cand} rows with "
                             f"a candidate, {int(r_ok.sum())} matches")
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(timing_reps):
            out = proj(*args)
        jax.block_until_ready(out)
        secs.append((time.perf_counter() - t0) / timing_reps)
    ms = float(np.median(secs)) * 1e3
    print(f"[2] projection matcher M={n_mp} N={cfg.total_capacity}: idx/best/"
          f"second/ok equal to numpy ({n_cand} rows with a candidate, "
          f"{int(r_ok.sum())} matches); {ms:.4f} ms per call")
    return ms


# ---------------------------------------------------------------------------
# 3. bundle adjustment
# ---------------------------------------------------------------------------

# Bounds of the GPU-vs-CPU BA comparison: (chi2 relative difference, max
# |dt| in m) per fixture. Summation order alone moves a BA solution, and the
# GPU's scatter-adds run in another order than the CPU's and in a new one on
# every solve. Permuting the observations on the CPU moves bench K=16/64/256
# by 1.3e-5 / 2.4e-3 / 4.3e-3 m (its random observations leave the K>=64
# poses weakly determined) and the loop by 7e-6 m; two identical solves on
# an H100 differ by up to 5.6e-5 / 3.9e-3 / 1.1e-2 m and 4e-6 m. The loop,
# where every keyframe sees every point, and bench K=16 hold the GPU to the
# CPU within 1e-4 m: at HIGHEST they stayed within 6.3e-6 and 1.6e-5 m, at
# HIGH (TF32) they moved 1.9e-4 m. The K>=64 bounds sit at two to three
# times the largest order spread and catch gross faults only.
BA_BOUNDS = {"bench_K16": (1e-4, 1e-4), "bench_K64": (1e-4, 1e-2),
             "bench_K256": (1e-4, 2e-2), "loop_K256": (1e-5, 1e-4)}


def ba_fixture(name):
    """(problem, K) of a BA_BOUNDS fixture: bench_K<n> is
    bench._make_ba_problem(n) (P=4096, O=16384), loop_K256 is
    loop_ba_local_problem (P=1024, every keyframe sees every point)."""
    import bench
    if name.startswith("bench_K"):
        return bench._make_ba_problem(int(name[7:]))
    _, prob, K = loop_ba_local_problem()
    return prob, K


def phase_ba(fixtures=tuple(BA_BOUNDS)):
    import jax
    from orbslam3_jax.ops import ba
    cpu = jax.devices("cpu")[0]
    solve = jax.jit(functools.partial(ba.local_ba, cam_type=0,
                                      chi2_th=ba.CHI2_MONO))
    print(f"[3] Schur contraction precision: {ba.SCHUR_PRECISION}")
    for name in fixtures:
        prob, K = jax.device_put(ba_fixture(name))
        g = jax.block_until_ready(solve(prob, K))
        g2 = jax.block_until_ready(solve(prob, K))
        c = solve(jax.device_put(prob, cpu), jax.device_put(K, cpu))
        chi2_g, chi2_c = float(g.chi2), float(c.chi2)
        rel = abs(chi2_g - chi2_c) / abs(chi2_c)
        dt = float(np.abs(np.asarray(g.t) - np.asarray(c.t)).max())
        spread = float(np.abs(np.asarray(g.t) - np.asarray(g2.t)).max())
        print(f"[3] BA {name} K={prob.R.shape[0]} P={prob.pts.shape[0]} "
              f"O={prob.obs_kf.shape[0]}: chi2 gpu={chi2_g:.6g} "
              f"cpu={chi2_c:.6g} rel_diff={rel:.3e}; max |dt| gpu-cpu="
              f"{dt:.3e} m, gpu-gpu={spread:.3e} m; inliers "
              f"gpu={int(g.n_inlier)} cpu={int(c.n_inlier)}")
        chi2_rtol, t_atol = BA_BOUNDS[name]
        if not (np.isfinite(chi2_g) and rel <= chi2_rtol and dt <= t_atol):
            raise AssertionError(f"BA {name}: GPU and CPU disagree "
                                 f"(chi2 rel {rel:.3e}, |dt| {dt:.3e} m)")


# ---------------------------------------------------------------------------
# 4. fused front end
# ---------------------------------------------------------------------------

def frontend_problem(cfg, n_mp=4096, seed=0):
    """A 4096-point map seeded from one rendered frame (features back-
    projected through the rendered depth, reference MapPoint distance range
    and normal) plus random far points; the step tracks the next-but-one
    frame of the orbit from the first frame's pose."""
    import jax
    import jax.numpy as jnp
    from orbslam3_jax.ops import features
    from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
    scene = RoomScene(seed=1, n_clutter=4)
    (Ra, ta), _, (Rb, tb) = orbit_trajectory(3, radius=1.0, forward=0.04)
    img_a, depth = scene.render(Ra, ta, return_depth=True)
    img_b = scene.render(Rb, tb)
    f = jax.jit(features.extract_orb, static_argnums=1)(jnp.asarray(img_a),
                                                       cfg)
    xy, desc = np.asarray(f.xy), np.asarray(f.desc)
    octv, valid = np.asarray(f.octave), np.asarray(f.valid)
    px = np.clip(np.round(xy).astype(int), 0, [scene.w - 1, scene.h - 1])
    z = depth[px[:, 1], px[:, 0]]
    sel = np.nonzero(valid & (z > 0))[0][:n_mp]
    fx, fy, cx, cy = scene.K
    xc = np.stack([(xy[sel, 0] - cx) / fx * z[sel],
                   (xy[sel, 1] - cy) / fy * z[sel], z[sel]], -1)
    xw = (xc - ta) @ Ra                       # R_cwᵀ (x_c − t_cw)
    rng = np.random.default_rng(seed)
    n_rand = n_mp - len(sel)
    xw = np.concatenate([xw, rng.uniform([-4, -3, 5], [4, 3, 12], (n_rand, 3))])
    mp_desc = np.concatenate(
        [desc[sel], rng.integers(0, 2**32, (n_rand, 8), dtype=np.uint32)])
    oct_all = np.concatenate([octv[sel], rng.integers(0, cfg.n_levels, n_rand)])
    center = -Ra.T @ ta
    d = xw - center
    dist = np.linalg.norm(d, axis=1)
    maxd = dist * cfg.scale ** oct_all
    mind = maxd / cfg.scale ** (cfg.n_levels - 1)
    f32 = lambda a: np.asarray(a, np.float32)
    args = (f32(Ra), f32(ta), f32(xw), mp_desc, f32(d / dist[:, None]),
            f32(mind), f32(maxd), np.ones(n_mp, bool))
    return scene, f32(img_b), args, (Rb, tb), len(sel)


# ORB extraction is not bitwise equal across backends (float32 transcendental
# functions and summation order differ). On an H100, for the second frame of
# this fixture, 1022 of 1024 keypoints sit at the CPU's positions and octaves,
# but 940 angles and 436 descriptors differ, so the inlier sets differ by
# 1.4% and the poses by 1.4e-3 m in translation, both ~4e-3 m from ground
# truth. The translation bound is twice that difference, and both poses must
# lie within 1e-2 m of ground truth.
FRONTEND_T_ATOL = 3e-3
FRONTEND_GT_ATOL = 1e-2


def phase_frontend(matcher_ms, n_features=1024, timing_reps=30):
    import jax
    import jax.numpy as jnp
    from orbslam3_jax.models import kernels
    from orbslam3_jax.ops import features
    cfg = features.OrbConfig(n_features=n_features)
    scene, img, args, (Rb, tb), n_seeded = frontend_problem(cfg)
    step = kernels.frontend_step(cfg)
    g_in = tuple(jnp.asarray(a) for a in (img, *args)) + (
        jnp.asarray(scene.K, jnp.float32),
        jnp.asarray([scene.w, scene.h], jnp.float32))
    R_g, t_g, n_g = map(np.asarray, jax.block_until_ready(step(*g_in)))
    cpu = jax.devices("cpu")[0]
    R_c, t_c, n_c = map(np.asarray, step(*jax.device_put(g_in, cpu)))
    n_g, n_c = int(n_g), int(n_c)
    dR = float(np.abs(R_g - R_c).max())
    dt = float(np.abs(t_g - t_c).max())
    centre = lambda R, t: -R.T @ t
    err_gt = float(np.linalg.norm(centre(R_g, t_g) - centre(Rb, tb)))
    err_gt_c = float(np.linalg.norm(centre(R_c, t_c) - centre(Rb, tb)))
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(timing_reps):
            out = step(*g_in)
        jax.block_until_ready(out)
        secs.append((time.perf_counter() - t0) / timing_reps)
    ms = float(np.median(secs)) * 1e3
    print(f"[4] front-end step 752x480, {n_features} features, 4096-point map "
          f"({n_seeded} seeded from the scene): inliers gpu={n_g} cpu={n_c}; "
          f"max |dR|={dR:.3e} |dt|={dt:.3e} m; camera-centre error vs ground "
          f"truth gpu {err_gt:.4f} m, cpu {err_gt_c:.4f} m")
    print(f"[4] step {ms:.4f} ms on the GPU; projection matcher "
          f"{matcher_ms:.4f} ms = {100.0 * matcher_ms / ms:.2f}% of the step")
    if n_c < 50:
        raise AssertionError(f"front end: only {n_c} inliers on the CPU")
    if not (err_gt < FRONTEND_GT_ATOL and err_gt_c < FRONTEND_GT_ATOL):
        raise AssertionError("front end: pose off ground truth "
                             f"(gpu {err_gt:.4f} m, cpu {err_gt_c:.4f} m)")
    if (abs(n_g - n_c) > 0.02 * n_c or dR > 1e-3
            or dt > FRONTEND_T_ATOL):
        raise AssertionError("front end: GPU and CPU disagree")


# ---------------------------------------------------------------------------
# 5-6. SlamSystem
# ---------------------------------------------------------------------------

def _report_system(tag, slam, n_frames, secs, compiles, c0):
    import jax
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[{tag}] {n_frames} frames in {secs:.2f} s = {n_frames / secs:.2f} "
          f"frames/s (compiles included); {compiles.n - c0[0]} compiles, "
          f"{compiles.secs - c0[1]:.2f} s; peak_bytes_in_use={peak}; "
          f"paths={slam.tracker.path_counts}")


def phase_mono(compiles, n_features=1024, n_frames=32):
    """The orbit of tests/test_e2e_mono.py through the async system."""
    from orbslam3_jax.models.system import SlamSystem
    from orbslam3_jax.models.tracking import TrackingParams, TrackState
    from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
    from orbslam3_jax.utils.evaluation import evaluate_trajectory
    scene = RoomScene(seed=1)
    poses = orbit_trajectory(n_frames, radius=1.0, forward=0.04)
    imgs = [scene.render(R, t) for R, t in poses]
    gt = np.array([-R.T @ t for R, t in poses])
    c0 = (compiles.n, compiles.secs)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h),
                      n_features=n_features, seed=0, mapping_mode="async",
                      tracking_params=TrackingParams(kf_interval_override=5))
    try:
        states = []
        t0 = time.perf_counter()
        for i, img in enumerate(imgs):
            slam.track_monocular(img, ts=i / 20.0)
            states.append(slam.state)
        slam.tracker.flush_pending()
        secs = time.perf_counter() - t0
        if not slam.wait_idle(timeout=300.0):
            raise AssertionError("mono: the mapper did not drain")
        ts, _, t_wc, lost = slam.export_trajectory()
        sel = ~lost
        ate, n_assoc = evaluate_trajectory(np.arange(n_frames) / 20.0, gt,
                                           ts[sel], t_wc[sel], with_scale=True)
        non_ok = sum(s != TrackState.OK for s in states[10:])
        _report_system(5, slam, n_frames, secs, compiles, c0)
        st = slam.stats()
        keys = ("n_keyframes", "n_map_points", "ba_runs", "culled_kf")
        print(f"[5] mono: state={slam.state.name} non-OK after frame 10: "
              f"{non_ok}; ATE (scale-aligned) {ate:.4f} m over {n_assoc} "
              f"frames; stats={ {k: st[k] for k in keys if k in st} }")
        if slam.state != TrackState.OK or non_ok > 4:
            raise AssertionError(f"mono tracking: {[s.name for s in states]}")
        if n_assoc <= 0.7 * n_frames or not ate < 0.08:
            raise AssertionError(f"mono ATE {ate} over {n_assoc} frames")
    finally:
        slam.shutdown(print_times=False)


def stereo_inertial_pose(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    """The camera path of tests/test_e2e_stereo_inertial.py."""
    c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x),
                  forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def phase_stereo_inertial(compiles, n_frames=60, fps=20.0, imu_hz=200,
                          baseline=0.11):
    """The fixture of tests/test_e2e_stereo_inertial.py, tracked pipelined
    (where the fused visual-inertial dispatch runs) and for 60 frames
    instead of 36: the IMU initializes at frame 36 of this path."""
    from orbslam3_jax.models.system import SlamSystem
    from orbslam3_jax.models.tracking import TrackingParams
    from orbslam3_jax.utils.datasets import RoomScene, synthetic_imu
    from orbslam3_jax.utils.evaluation import evaluate_trajectory
    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5)
    imu_ts, gyro, acc = synthetic_imu(stereo_inertial_pose, n_frames, fps,
                                      imu_hz)
    frames, gt = [], []
    for i in range(n_frames):
        R, t = stereo_inertial_pose(i)
        Rr, tr = scene.stereo_pose(R, t, baseline)
        frames.append((scene.render(R, t), scene.render(Rr, tr)))
        gt.append(-R.T @ t)
    per = imu_hz // int(fps)
    c0 = (compiles.n, compiles.secs)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0, tracking_params=TrackingParams(
                          kf_interval_override=5, pipeline=True),
                      bf=baseline * scene.fx, th_depth=baseline * 40,
                      enable_loop_closing=False)
    try:
        slam.enable_imu(freq=imu_hz)
        t0 = time.perf_counter()
        for i, (img_l, img_r) in enumerate(frames):
            s0, s1 = ((i - 1) * per, i * per) if i else (0, 0)
            slam.track_stereo_inertial(img_l, img_r, ts=i / fps,
                                       imu_ts=imu_ts[s0:s1],
                                       imu_gyro=gyro[s0:s1],
                                       imu_acc=acc[s0:s1])
        slam.tracker.flush_pending()
        secs = time.perf_counter() - t0
        ts, _, t_wc, lost = slam.export_trajectory()
        sel = ~lost
        ate, n_assoc = evaluate_trajectory(np.arange(n_frames) / fps,
                                           np.array(gt), ts[sel], t_wc[sel],
                                           with_scale=False)
        _report_system(6, slam, n_frames, secs, compiles, c0)
        vi = slam.tracker.path_counts["fused_vi"]
        print(f"[6] stereo-inertial: imu_initialized="
              f"{slam.tracker.imu_initialized} fused_vi frames={vi}; metric "
              f"ATE {ate:.4f} m over {n_assoc} frames")
        if not slam.tracker.imu_initialized:
            raise AssertionError("stereo-inertial: the IMU never initialized")
        if vi < 1:
            raise AssertionError("stereo-inertial: no frame took the fused "
                                 "VI dispatch")
        if n_assoc <= 0.7 * n_frames or not ate < 0.1:
            raise AssertionError(f"stereo-inertial ATE {ate} over {n_assoc} "
                                 "frames")
    finally:
        slam.shutdown(print_times=False)


# ---------------------------------------------------------------------------
# 7. sharded global BA across cards
# ---------------------------------------------------------------------------

def loop_ba_problem(n_kf=256, n_pts=1024, seed=3, perturb_seed=4):
    """The 256-keyframe loop of tests/test_sharded_ba.py (every keyframe
    sees every point), perturbed off ground truth as that test does."""
    import jax.numpy as jnp
    from orbslam3_jax.ops import lie
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(5, 15, n_pts)], -1).astype(np.float32)
    Rs, ts, uvs = [], [], []
    for k in range(n_kf):
        R = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.02, 3).astype(np.float32))))
        ph = 2 * np.pi * k / n_kf
        t = np.array([2.0 * np.sin(ph), 1.0 * np.cos(ph), 0.3 * np.sin(2 * ph)],
                     np.float32)
        pc = pts @ R.T + t
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376,
                       458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uvs.append(uv + rng.normal(0, 0.5, uv.shape))
        Rs.append(R)
        ts.append(t)
    R_gt, t_gt = np.stack(Rs), np.stack(ts)
    obs_kf = np.repeat(np.arange(n_kf), n_pts).astype(np.int32)
    obs_mp = np.tile(np.arange(n_pts), n_kf).astype(np.int32)
    obs_uv = np.concatenate(uvs).astype(np.float32)
    rng = np.random.default_rng(perturb_seed)
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(2, n_kf):
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32))))
        R0[k] = dR @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.03, 3)
    pts0 = (pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32)
    return t_gt, (R0, t0, pts0, obs_kf, obs_mp, obs_uv)


LOOP_K = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)


def loop_ba_local_problem(n_kf=256, n_pts=1024):
    """loop_ba_problem as an ops/ba.BAProblem (first two poses fixed):
    (t_gt, problem, K) in numpy arrays."""
    from orbslam3_jax.ops import ba
    t_gt, (R0, t0, pts0, obs_kf, obs_mp, obs_uv) = loop_ba_problem(n_kf, n_pts)
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    n_obs = len(obs_kf)
    prob = ba.BAProblem(
        R=R0, t=t0, pts=pts0, obs_kf=obs_kf, obs_mp=obs_mp, obs_uv=obs_uv,
        obs_inv_sigma2=np.ones(n_obs, np.float32),
        obs_valid=np.ones(n_obs, bool), fixed_pose=fixed,
        obs_ur=np.full(n_obs, -1.0, np.float32), bf=np.float32(0.0))
    return t_gt, prob, LOOP_K


def phase_sharded_ba(n_devices=4, n_kf=256, n_pts=1024, iters=(4, 4)):
    import jax
    import jax.numpy as jnp
    from orbslam3_jax.ops import ba
    from orbslam3_jax.parallel import sharded_ba as sb
    t_gt, prob, K_cam = loop_ba_local_problem(n_kf, n_pts)
    R0, t0, pts0 = prob.R, prob.t, prob.pts
    obs_kf, obs_mp, obs_uv = prob.obs_kf, prob.obs_mp, prob.obs_uv
    fixed = prob.fixed_pose
    n_obs = len(obs_kf)
    dev0 = jax.devices()[0]
    single = jax.jit(functools.partial(ba.local_ba, iters1=iters[0],
                                       iters2=iters[1]))
    prob, K_dev = jax.device_put((prob, K_cam), dev0)
    ref = jax.block_until_ready(single(prob, K_dev))
    t1 = time.perf_counter()
    ref = jax.block_until_ready(single(prob, K_dev))
    single_s = time.perf_counter() - t1

    mesh = sb.make_mesh(n_devices)
    n_pts_pad, _, local_mp, obs_valid, outs = sb.partition_by_landmark(
        obs_mp, n_pts, n_devices, {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[:n_pts] = pts0
    solver = sb.make_sharded_ba_solver(mesh, n_kf, iters1=iters[0],
                                       iters2=iters[1])
    args = tuple(jnp.asarray(a) for a in (
        R0, t0, fixed, pts_pad, outs["kf"], local_mp, outs["uv"],
        obs_valid.astype(np.float32), K_cam))
    R, t, pts, inl = jax.block_until_ready(solver(*args))
    t1 = time.perf_counter()
    R, t, pts, inl = jax.block_until_ready(solver(*args))
    sharded_s = time.perf_counter() - t1
    shard_devs = {s.device for s in pts.addressable_shards}
    err_ref = float(np.abs(np.asarray(ref.t) - t_gt).max())
    err_sh = float(np.abs(np.asarray(t) - t_gt).max())
    d_ref = float(np.abs(np.asarray(t) - np.asarray(ref.t)).max())
    n_inl = int(np.asarray(inl).sum())
    print(f"[7] sharded BA K={n_kf} P={n_pts} O={n_obs} on "
          f"{len(shard_devs)} devices {sorted(d.id for d in shard_devs)}: "
          f"max |t - gt| sharded={err_sh:.5f} single={err_ref:.5f}; max "
          f"|t_sharded - t_single|={d_ref:.5f}; inliers {n_inl}/{n_obs}; "
          f"solve {sharded_s * 1e3:.1f} ms sharded vs {single_s * 1e3:.1f} ms "
          "on one device (warm)")
    if len(shard_devs) != n_devices or len(mesh.devices.reshape(-1)) != n_devices:
        raise AssertionError(f"landmark shards sit on {len(shard_devs)} "
                             f"devices, not {n_devices}")
    if not (err_sh < 0.02 and abs(err_sh - err_ref) < 5e-3 and d_ref < 1e-2
            and n_inl > 0.9 * n_obs):
        raise AssertionError("sharded BA disagrees with single-device BA")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded global BA across four GPUs")
    args = ap.parse_args(argv)
    import jax
    from orbslam3_jax.models.system import enable_compilation_cache
    n_devices = 4 if args.four_cards else 1
    devs = phase_device(n_devices)
    enable_compilation_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_sharded_ba(n_devices)
    else:
        compiles = CompileLog()
        jax.monitoring.register_event_duration_secs_listener(compiles)
        matcher_ms = phase_matcher()
        phase_ba()
        phase_frontend(matcher_ms)
        phase_mono(compiles)
        phase_stereo_inertial(compiles)
        print(f"[-] {compiles.n} compiles, {compiles.secs:.2f} s in all")
    print(f"[-] phases took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
