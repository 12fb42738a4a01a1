"""Background-GBA correction propagation to keyframes created mid-run.

Reference RunGlobalBundleAdjustment (src/LoopClosing.cc:2640-2830): keyframes
inserted while the BA ran are corrected through their spanning-tree parent's
correction. Here the anchor is each keyframe's most-covisible snapshot
keyframe — this test drives a GBA whose correction varies strongly along the
trajectory and inserts a new keyframe (covisible with the SMALL-correction
region) mid-run via the abort_check hook; a single last-snapshot anchor would
drag it by the LARGE end-of-chain correction.
"""
import numpy as np
import pytest

from orbslam3_jax.models.local_mapping import LocalMapper
from orbslam3_jax.models.map import MapConfig, MapState
from orbslam3_jax.ops import features as feat_ops

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)


def project(R, t, pts):
    pc = pts @ R.T + t
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([458 * pc[:, 0] / z + 376, 458 * pc[:, 1] / z + 240], -1), pc[:, 2] > 0.5


@pytest.fixture()
def drifted_line_map():
    """A corridor of keyframes with drift growing along the chain."""
    rng = np.random.default_rng(0)
    n_kf, n_pts = 12, 400
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(6, 14, n_pts) + rng.uniform(0, 10, n_pts)], -1)
    pts[:, 2] += np.linspace(0, 10, n_pts)  # spread along the corridor
    desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    cfg = MapConfig(max_keyframes=64, max_map_points=4096, n_features=256)
    m = MapState(cfg)
    gt_t = []
    for k in range(n_kf):
        R = np.eye(3, dtype=np.float32)
        t_gt = np.asarray([0, 0, -1.2 * k], np.float32)     # camera walks +z
        gt_t.append(t_gt)
        drift = np.asarray([0.4, 0.0, 0.0], np.float32) * (k / (n_kf - 1)) ** 2
        uv, ok = project(R, t_gt, pts)
        inb = ok & (uv[:, 0] > 5) & (uv[:, 0] < 747) & (uv[:, 1] > 5) & (uv[:, 1] < 475)
        sel = np.nonzero(inb)[0][:256]
        feat_mp = np.full(256, -1, np.int32)
        feat_mp[: len(sel)] = sel
        m.add_keyframe(R, t_gt + drift, float(k), k,
                       uv[sel].astype(np.float32),
                       np.zeros(len(sel), np.float32),
                       np.zeros(len(sel), np.int32), desc[sel],
                       np.ones(len(sel), bool), feat_mp=feat_mp[: len(sel)])
    ids = m.add_map_points(pts.astype(np.float32), desc, 0,
                           np.tile([0, 0, -1.0], (n_pts, 1)).astype(np.float32),
                           np.full(n_pts, 0.5, np.float32),
                           np.full(n_pts, 60.0, np.float32))
    assert (ids == np.arange(n_pts)).all()
    return m, np.asarray(gt_t), pts, desc


def test_midrun_keyframes_propagate_via_covisible_anchor(drifted_line_map):
    m, gt_t, pts, desc = drifted_line_map
    cfg = feat_ops.OrbConfig(n_features=256)
    mapper = LocalMapper(m, K_CAM, cfg, wh=(752, 480))
    inserted = {}

    calls = {"n": 0}

    def insert_midrun():
        calls["n"] += 1
        if calls["n"] == 2 and not inserted:
            # a new keyframe observing the SAME points as keyframe 1 (the
            # small-drift end), with keyframe 1's (drifted) pose
            src = 1
            k_new = m.add_keyframe(
                m.kf_R[src].copy(), m.kf_t[src].copy(), 99.0, 99,
                m.kf_feat_xy[src], m.kf_feat_angle[src],
                m.kf_feat_octave[src], m.kf_feat_desc[src],
                m.kf_feat_valid[src], feat_mp=m.kf_feat_mp[src].copy())
            inserted["id"] = k_new
        return False

    ok = mapper.global_ba(iters=(6, 8), abort_check=insert_midrun,
                          propagate=True)
    assert ok and "id" in inserted
    k_new = inserted["id"]
    # the mid-run keyframe must land with its covisible neighbor (KF 1),
    # whose GBA correction was tiny — NOT at the far end's large correction
    d_neighbor = np.linalg.norm(m.kf_t[k_new] - m.kf_t[1])
    assert d_neighbor < 0.05, d_neighbor
    # sanity: the far end actually received a large correction
    d_far = np.linalg.norm(m.kf_t[11] - (gt_t[11] + [0.4, 0, 0]))
    assert d_far > 0.2, d_far
