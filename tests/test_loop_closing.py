"""Deterministic loop-closure test on a hand-built drifted map.

Simulates the state after a drifting loop traversal: keyframes around a
circle, the revisited region mapped TWICE (original points + drift-displaced
duplicates with the same descriptors), then runs the full LoopCloser
(BoW candidates → Sim3 RANSAC → projection check → pose graph) and asserts
the trajectory snaps back toward ground truth.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.models.loop_closing import LoopCloser
from orbslam3_jax.models.map import MapConfig, MapState
from orbslam3_jax.ops import lie, vocab as vocab_ops

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)
WH = (752, 480)


def project(R, t, pts):
    pc = pts @ R.T + t
    z = pc[:, 2]
    u = 458.0 * pc[:, 0] / np.maximum(z, 1e-6) + 376.0
    v = 458.0 * pc[:, 1] / np.maximum(z, 1e-6) + 240.0
    ok = (z > 0.5) & (u > 10) & (u < 742) & (v > 10) & (v < 470)
    return np.stack([u, v], -1), ok


@pytest.fixture(scope="module")
def drifted_map():
    rng = np.random.default_rng(0)
    n_world = 900
    # points on a cylinder of radius 8 around the origin
    ang = rng.uniform(0, 2 * np.pi, n_world)
    wp = np.stack([8 * np.cos(ang), rng.uniform(-2, 2, n_world), 8 * np.sin(ang)], -1)
    wdesc = rng.integers(0, 2 ** 32, (n_world, 8), dtype=np.uint32)

    n_kf = 20
    cfg = MapConfig(max_keyframes=64, max_map_points=8192, n_features=512)
    m = MapState(cfg)
    gt_R, gt_t = [], []
    drift_R, drift_t = [], []
    # drift grows linearly along the loop, closing mismatch ~0.5; the last
    # 4 keyframes sit back at the loop start (revisit)
    for k in range(n_kf):
        a = 2 * np.pi * min(k, n_kf - 4) / (n_kf - 4)
        # camera at radius 2, looking outward
        c = np.array([2 * np.cos(a), 0.0, 2 * np.sin(a)])
        yaw = -a  # look along +x rotated
        R_wc = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                         [-np.sin(yaw), 0, np.cos(yaw)]])
        R = R_wc.T
        t = -R @ c
        gt_R.append(R.astype(np.float32)); gt_t.append(t.astype(np.float32))
        frac = k / (n_kf - 1)
        dR = np.asarray(lie.so3_exp(jnp.asarray([0, 0.06 * frac, 0], jnp.float32)))
        dt = np.array([0.4 * frac, 0.0, 0.25 * frac], np.float32)
        Rd = dR @ R
        td = t + dt
        drift_R.append(Rd.astype(np.float32)); drift_t.append(td.astype(np.float32))

    world_mp = np.full(n_world, -1, np.int32)
    for k in range(n_kf):
        uv, ok = project(gt_R[k], gt_t[k], wp)
        sel = np.nonzero(ok)[0][:500]
        n = len(sel)
        fresh = sel[world_mp[sel] < 0]
        # last 4 KFs revisit the start region: enough for the
        # 3-consecutive-verification temporal gate (reference :427)
        if k < n_kf - 4:
            # map new world points at their TRUE position transformed by the
            # drift of this KF: x_est = T_drift⁻¹(T_gt(x))
            xc = wp[fresh] @ gt_R[k].T + gt_t[k]
            x_est = (xc - drift_t[k]) @ drift_R[k]
            c_k = -drift_R[k].T @ drift_t[k]
            dist = np.linalg.norm(x_est - c_k, axis=1).astype(np.float32)
            ids = m.add_map_points(x_est.astype(np.float32), wdesc[fresh], k,
                                   np.tile([0, 0, 1.0], (len(fresh), 1)).astype(np.float32),
                                   dist / 3.6, dist,   # octave-0 scale range
                                   first_kf=k)
            world_mp[fresh] = ids
        else:
            # revisit: create drift-displaced duplicates for ALL visible points
            xc = wp[sel] @ gt_R[k].T + gt_t[k]
            x_est = (xc - drift_t[k]) @ drift_R[k]
            c_k = -drift_R[k].T @ drift_t[k]
            dist = np.linalg.norm(x_est - c_k, axis=1).astype(np.float32)
            ids = m.add_map_points(x_est.astype(np.float32), wdesc[sel], k,
                                   np.tile([0, 0, 1.0], (len(sel), 1)).astype(np.float32),
                                   dist / 3.6, dist,   # octave-0 scale range
                                   first_kf=k)
            dup_map = dict(zip(sel, ids))

        feat_mp = np.full(cfg.n_features, -1, np.int32)
        if k < n_kf - 4:
            feat_mp[:n] = world_mp[sel]
        else:
            feat_mp[:n] = [dup_map[s] for s in sel]
        kf = m.add_keyframe(drift_R[k], drift_t[k], float(k), k,
                            uv[sel].astype(np.float32),
                            np.zeros(cfg.n_features, np.float32)[:n] * 0,
                            np.zeros(n, np.int32), wdesc[sel],
                            np.ones(n, bool), feat_mp=feat_mp[:n])
    return m, gt_R, gt_t, n_kf


def test_loop_detected_and_corrected(drifted_map):
    m, gt_R, gt_t, n_kf = drifted_map
    lc = LoopCloser(m, K_CAM, WH, min_kfs=4, exclude_recent=4)
    detected_at = []
    for k in range(n_kf):
        if lc.process_keyframe(k):
            detected_at.append(k)
    assert detected_at, lc.stats
    assert lc.stats["loops_corrected"] >= 1
    # temporal consistency: the first candidate pass (KF 16) must NOT fire a
    # correction — acceptance needs 3 consecutive verifications (:427)
    assert detected_at[0] >= n_kf - 2, detected_at
    # the accepted loop edge persists for later essential-graph solves
    assert len(lc.loop_edges) == 1
    assert lc.loop_edges[0][1] == 0
    # trajectory should be much closer to gt after correction
    errs = [np.linalg.norm((-m.kf_R[k].T @ m.kf_t[k]) - (-gt_R[k].T @ gt_t[k]))
            for k in range(n_kf)]
    # pre-correction drift reached ~0.42 at the last KF; the pose graph closes
    # the loop-end discrepancy. Mid-chain keeps interpolated residual (the
    # yaw part of the drift works through a radius-2 lever arm) until the
    # global BA that the SYSTEM runs right after a correction (reference
    # RunGlobalBundleAdjustment, src/LoopClosing.cc:2587) — this unit fixture
    # has no mapper, so only the graph result is asserted
    assert errs[-1] < 0.2, errs
    assert errs[-4] < 0.25, errs          # whole revisit group snapped
    assert max(errs) < 0.6, errs


def test_relocalization_candidates(drifted_map):
    m, _, _, n_kf = drifted_map
    lc = LoopCloser(m, K_CAM, WH, min_kfs=4, exclude_recent=4)
    for k in range(n_kf):
        lc.process_keyframe(k)
    # query with KF 2's own descriptors: KF 2 (or a close covisible) must
    # lead the candidate list (reference DetectRelocalizationCandidates)
    cands = lc.detect_relocalization_candidates(
        m.kf_feat_desc[2], m.kf_feat_valid[2])
    assert len(cands) > 0
    assert any(abs(int(c) - 2) <= 2 for c in cands[:3]), cands
