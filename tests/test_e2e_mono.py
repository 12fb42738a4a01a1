"""End-to-end monocular SLAM on synthetic sequences with ground truth.

The framework analogue of the reference's dataset integration tests
(euroc_examples.sh → evaluate_ate_scale.py): track a rendered sequence, export
the trajectory, align with Horn+scale, assert RMS ATE.

Measured after the scale-drift + trajectory re-anchoring fixes: ~0.02 scene
units ATE over this 32-frame orbit (scene scale ~10 m).
"""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory

N_FRAMES = 32


@pytest.fixture(scope="module")
def slam_run():
    scene = RoomScene(seed=1)
    poses = orbit_trajectory(N_FRAMES, radius=1.0, forward=0.04)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params())
    gt_centers = []
    states = []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        sys.track_monocular(img, ts=float(i) / 20.0)
        gt_centers.append(-R.T @ t)
        states.append(sys.state)
    return sys, np.array(gt_centers), states


def test_initializes_and_tracks(slam_run):
    sys, gt, states = slam_run
    assert sys.state == TrackState.OK
    # brief RECENTLY_LOST episodes must recover (relocalization); sustained
    # loss fails
    non_ok = sum(s != TrackState.OK for s in states[10:])
    assert non_ok <= 4, [s.name for s in states]
    st = sys.stats()
    # reference-faithful keyframe culling (uncapped, scale-aware — reference
    # src/LocalMapping.cc:1218) prunes hard on this feature-stable synthetic
    # scene: most KFs are >90% redundant, as they would be for the reference
    assert st["n_keyframes"] >= 3
    assert st.get("culled_kf", 0) > 0          # culling actually ran
    assert st["n_map_points"] > 150, st


def test_trajectory_ate(slam_run):
    sys, gt, states = slam_run
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    assert sel.sum() > 0.7 * N_FRAMES, sel.sum()
    gt_ts = np.arange(N_FRAMES) / 20.0
    ate, n_assoc = evaluate_trajectory(gt_ts, gt, ts[sel], t_wc[sel], with_scale=True)
    assert n_assoc > 0.7 * N_FRAMES
    assert ate < 0.08, ate  # measured 0.018; margin for platform jitter


def test_stats_sane(slam_run):
    sys, gt, states = slam_run
    st = sys.stats()
    assert st["triangulated"] > 0
    assert st["ba_runs"] >= 1


def test_trajectory_export_tum_format(slam_run, tmp_path):
    sys, gt, states = slam_run
    path = tmp_path / "traj.txt"
    sys.save_trajectory_tum(str(path))
    lines = path.read_text().strip().splitlines()
    assert len(lines) > 10
    row = [float(x) for x in lines[0].split()]
    assert len(row) == 8  # ts xyz qxyzw
    q = np.array(row[4:])
    assert abs(np.linalg.norm(q) - 1.0) < 1e-4
