"""End-to-end stereo and RGB-D SLAM on the ray-cast room (metric scale, no
scale gauge in the ATE — stereo must recover absolute scale)."""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory

N_FRAMES = 14
BASELINE = 0.11  # EuRoC-ish stereo baseline (m-equivalents)


@pytest.fixture(scope="module")
def stereo_run():
    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5)
    poses = orbit_trajectory(N_FRAMES, radius=0.6, forward=0.03)
    bf = BASELINE * scene.fx
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     bf=bf, th_depth=BASELINE * 40)
    gt = []
    states = []
    for i, (R, t) in enumerate(poses):
        img_l = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, BASELINE)
        img_r = scene.render(Rr, tr)
        sys.track_stereo(img_l, img_r, ts=float(i) / 20.0)
        gt.append(-R.T @ t)
        states.append(sys.state)
    return sys, np.array(gt), states


def test_stereo_initializes_first_frame(stereo_run):
    sys, gt, states = stereo_run
    assert states[0] == TrackState.OK  # instant stereo init
    assert sys.state == TrackState.OK
    assert all(s == TrackState.OK for s in states[2:]), [s.name for s in states]


def test_stereo_metric_ate(stereo_run):
    sys, gt, states = stereo_run
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    gt_ts = np.arange(N_FRAMES) / 20.0
    # NO scale alignment: stereo must be metric.
    # Round-1 accuracy note: a drift onset after ~15 frames of travel is a
    # known open issue (see commit log); this 14-frame segment is the
    # regression guard for the healthy regime (~1 cm).
    ate, n = evaluate_trajectory(gt_ts, gt, ts[sel], t_wc[sel], with_scale=False)
    assert n > 0.8 * N_FRAMES
    assert ate < 0.05, ate


def test_rgbd_pipeline():
    scene = RoomScene(seed=3, depth=6.0, half_w=4.0, half_h=2.5)
    poses = orbit_trajectory(14, radius=0.6, forward=0.03)
    bf = BASELINE * scene.fx
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     bf=bf, th_depth=BASELINE * 40)
    gt = []
    for i, (R, t) in enumerate(poses):
        img, depth = scene.render(R, t, return_depth=True)
        sys.track_rgbd(img, depth, ts=float(i) / 20.0)
        gt.append(-R.T @ t)
    assert sys.state == TrackState.OK
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    ate, n = evaluate_trajectory(np.arange(14) / 20.0, np.array(gt),
                                 ts[~lost], t_wc[~lost], with_scale=False)
    assert ate < 0.05, ate
