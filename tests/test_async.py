"""Asynchronous runtime: mapper + loop-closing threads with backpressure,
map-lock consistency and interruptible background GBA (the framework analogue
of the reference's System thread wiring, src/System.cc:135-164).

The synchronous pipeline is deterministic and covered by the E2E tests; here
we assert that the SAME sequence tracked in async mode (a) keeps tracking,
(b) drains cleanly at shutdown, and (c) produces a comparable trajectory.
"""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory

N_FRAMES = 28


@pytest.fixture(scope="module")
def async_run():
    scene = RoomScene(seed=1)
    poses = orbit_trajectory(N_FRAMES, radius=1.0, forward=0.04)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     mapping_mode="async")
    gt_centers = []
    states = []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        sys.track_monocular(img, ts=float(i) / 20.0)
        gt_centers.append(-R.T @ t)
        states.append(sys.state)
    drained = sys.wait_idle(timeout=300.0)
    sys.shutdown()
    return sys, np.array(gt_centers), states, drained


def test_async_tracks_and_drains(async_run):
    sys, gt, states, drained = async_run
    assert drained
    assert states[-1] == TrackState.OK
    non_ok = sum(s != TrackState.OK for s in states[10:])
    assert non_ok <= 6, [s.name for s in states]
    st = sys.stats()
    assert st["n_keyframes"] >= 3
    assert st["n_map_points"] > 100, st
    assert st.get("mapper_errors", 0) == 0, st.get("last_mapper_error")
    assert st.get("lc_errors", 0) == 0, st.get("last_lc_error")


def test_async_trajectory_ate(async_run):
    sys, gt, states, drained = async_run
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    assert sel.sum() > 0.6 * N_FRAMES, sel.sum()
    gt_ts = np.arange(N_FRAMES) / 20.0
    ate, n_assoc = evaluate_trajectory(gt_ts, gt, ts[sel], t_wc[sel],
                                       with_scale=True)
    assert n_assoc > 0.6 * N_FRAMES
    assert ate < 0.6, ate


def test_background_gba_propagates_new_keyframes():
    """A propagated global BA must leave keyframes created during the run
    consistent with the rest (anchor-relative correction, reference
    src/LoopClosing.cc:2640-2830)."""
    scene = RoomScene(seed=2)
    poses = orbit_trajectory(24, radius=1.0, forward=0.04)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params())
    for i, (R, t) in enumerate(poses):
        sys.track_monocular(scene.render(R, t), ts=float(i) / 20.0)
    assert sys.state == TrackState.OK
    m = sys.map
    before = m.kf_t[m.valid_kf_ids()].copy()
    ok = sys.mapper.global_ba(iters=(4, 4), propagate=True)
    assert ok
    after = m.kf_t[m.valid_kf_ids()]
    # poses moved but stayed finite and near the originals (no divergence)
    assert np.isfinite(after).all()
    assert np.linalg.norm(after - before, axis=1).max() < 1.0


def test_gba_abort_leaves_map_untouched():
    scene = RoomScene(seed=3)
    poses = orbit_trajectory(20, radius=1.0, forward=0.04)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params())
    for i, (R, t) in enumerate(poses):
        sys.track_monocular(scene.render(R, t), ts=float(i) / 20.0)
    m = sys.map
    before_R = m.kf_R.copy()
    before_x = m.mp_xyz.copy()
    applied = sys.mapper.global_ba(iters=(4, 4), abort_check=lambda: True)
    assert not applied
    assert np.array_equal(m.kf_R, before_R)
    assert np.array_equal(m.mp_xyz, before_x)
