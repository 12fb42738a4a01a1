"""Pipelined tracking (TrackingParams.pipeline): the one-frame software
pipeline must preserve tracking quality — same fixture as the synchronous
mono e2e, asserting state, map health and ATE."""
import numpy as np

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory


def test_pipelined_mono_tracks_and_matches_sync_quality():
    scene = RoomScene(seed=1, n_clutter=4)
    n = 40
    poses = orbit_trajectory(n, radius=1.0, forward=0.0)
    imgs = [scene.render(R, t) for (R, t) in poses]
    gt = np.array([-R.T @ t for (R, t) in poses])

    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0,
                      tracking_params=dense_tracking_params(pipeline=True))
    for i in range(n):
        slam.track_monocular(imgs[i], ts=i / 20.0)
    # flush happens inside stats/export
    st = slam.stats()
    assert slam.get_tracking_state() == TrackState.OK
    assert st["n_map_points"] > 100
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    assert len(ts) >= n - 5          # at most the init frames missing
    assert lost.sum() == 0
    ate, n_assoc = evaluate_trajectory(np.arange(n) / 20.0, gt, ts, t_wc,
                                       with_scale=True)
    assert n_assoc >= n - 5
    assert ate < 0.08, ate           # same bound class as the sync e2e


def test_pipeline_flush_on_state_reads():
    """Reading tracker state mid-stream must finalize the in-flight frame."""
    scene = RoomScene(seed=2, n_clutter=4)
    poses = orbit_trajectory(12, radius=1.0, forward=0.0)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0,
                      tracking_params=dense_tracking_params(pipeline=True))
    for i, (R, t) in enumerate(poses):
        slam.track_monocular(scene.render(R, t), ts=i / 20.0)
    state = slam.get_tracking_state()                 # flushes
    assert slam.tracker._pending == []
    assert state == TrackState.OK


def test_pipelined_depth2_tracks():
    """Two-frame-deep pipeline: the round trip leaves the critical path;
    candidate sets lag two frames and a synchronous fused retry bridges
    stale-candidate misses."""
    scene = RoomScene(seed=1, n_clutter=4)
    n = 30
    poses = orbit_trajectory(n, radius=1.0, forward=0.0)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0,
                      tracking_params=dense_tracking_params(
                          pipeline=True, pipeline_depth=2))
    for i, (R, t) in enumerate(poses):
        slam.track_monocular(scene.render(R, t), ts=i / 20.0)
    assert slam.get_tracking_state() == TrackState.OK
    assert slam.tracker._pending == []
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    assert len(ts) >= n - 6 and lost.sum() == 0
