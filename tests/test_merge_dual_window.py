"""Merge seam-stress distribution over a drifted map (VERDICT r4 #8).

Reference MergeLocal corrects the welding window, then runs
OptimizeEssentialGraph on the REST of the map with edges measured from the
non-corrected poses (src/LoopClosing.cc:1772-1853 window propagation +
:2141 essential graph; src/Optimizer.cc:3019 merge variant). The per-KF
window propagation factors into one world Sim3 (see SlamSystem._merge_with),
so the part that matters for a long drifted map is the essential graph's
measurement frame: measured from the PRE-weld poses, the weld correction
propagates along the trajectory; measured from the current (already
corrected-at-the-weld) poses, the solve is a zero-residual no-op and the
drift stays.

This drives a 64-keyframe map whose pose error grows quadratically toward
the weld (the merge seam), snaps the weld window to ground truth (what the
welding BA does), anchors the start of the chain as well (the revisit case:
the map's origin was itself merged/relocalized earlier, so stored loop edges
pin it), and checks that the snapshot-measured graph distributes the seam
correction along the chain toward ground truth while the no-snapshot variant
cannot move at all.
"""
import numpy as np
import pytest

from orbslam3_jax.models.loop_closing import LoopCloser
from orbslam3_jax.models.map import MapConfig, MapState

# 64-KF drifted-map merge — excluded from the fast profile (pytest.ini)
pytestmark = pytest.mark.slow

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)
N_KF = 64
WELD = list(range(60, 64))


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _drifted_map():
    """64 keyframes on a corridor; the map poses integrate odometry with a
    small per-step yaw bias — the realistic monocular drift profile, whose
    accumulated translation error grows toward the merge seam (far end)."""
    rng = np.random.default_rng(3)
    cfg = MapConfig(max_keyframes=128, max_map_points=64, n_features=16)
    m = MapState(cfg)
    xy = rng.uniform(0, 400, (16, 2)).astype(np.float32)
    desc = rng.integers(0, 2**32, (16, 8), dtype=np.uint32)
    gt_Rt, dr_Rt = [], []
    R_g = np.eye(3, dtype=np.float32); t_g = np.zeros(3, np.float32)
    R_d = np.eye(3, dtype=np.float32); t_d = np.zeros(3, np.float32)
    yaw_bias = _yaw(0.004)                   # odometry bias per step
    for k in range(N_KF):
        gt_Rt.append((R_g.copy(), t_g.copy()))
        dr_Rt.append((R_d.copy(), t_d.copy()))
        m.add_keyframe(R_d.copy(), t_d.copy(), float(k), k, xy,
                       np.zeros(16, np.float32), np.zeros(16, np.int32),
                       desc, np.ones(16, bool))
        # gt relative step: forward 0.8 with a gentle arc
        R_rel = _yaw(0.002); t_rel = np.asarray([0.02, 0.0, 0.8], np.float32)
        R_g, t_g = R_rel @ R_g, R_rel @ t_g + t_rel
        R_rel_d = yaw_bias @ R_rel
        R_d, t_d = R_rel_d @ R_d, R_rel_d @ t_d + t_rel
    return m, gt_Rt


def _ate(m, gt_Rt):
    ids = m.valid_kf_ids()
    ctr = -np.einsum("kij,ki->kj", m.kf_R[ids].transpose(0, 2, 1),
                     m.kf_t[ids])
    ctr_gt = np.stack([-gt_Rt[k][0].T @ gt_Rt[k][1] for k in ids])
    return float(np.sqrt(np.mean(np.sum((ctr - ctr_gt) ** 2, -1))))


@pytest.mark.parametrize("use_meas", [True, False])
def test_merge_graph_distributes_weld_correction(use_meas):
    m, gt = _drifted_map()
    closer = LoopCloser(m, K_CAM, (752, 480), fix_scale=True)
    ate0 = _ate(m, gt)
    assert ate0 > 0.25                      # the drift is real
    meas = (m.kf_R.copy(), m.kf_t.copy())   # pre-weld-correction snapshot
    anchors = WELD + [0, 1]                 # weld + previously-pinned origin
    for k in anchors:                       # what the welding BA does
        m.kf_R[k] = gt[k][0].copy()
        m.kf_t[k] = gt[k][1].copy()
    closer.optimize_essential_graph(anchors,
                                    meas=meas if use_meas else None)
    ate1 = _ate(m, gt)
    if use_meas:
        # the weld correction must distribute along the chain: the LM spreads
        # the seam inconsistency over the ~60 odometry edges, so mid-chain
        # error drops well below the accumulated drift
        assert ate1 < 0.5 * ate0, (ate0, ate1)
    else:
        # measured from current poses the graph cannot distribute the seam
        # correction — documents why the snapshot is required
        assert ate1 > 0.8 * ate0, (ate0, ate1)
