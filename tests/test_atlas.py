"""Atlas multi-map: loss spawns a new map; revisiting merges it back."""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory


def test_loss_creates_new_map_and_merge_on_revisit():
    scene = RoomScene(seed=5, depth=6.0, half_w=4.0, half_h=2.5)
    poses = orbit_trajectory(14, radius=0.6, forward=0.03)
    B = 0.11
    bf = B * scene.fx
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     bf=bf, th_depth=B * 40, enable_loop_closing=False)
    sys.tracker.frames_to_new_map = 4
    sys.tracker.p.kf_interval_override = 1  # densify KFs to exceed the
    # reference's >=10-KF keep-map threshold quickly

    # phase 1: build map A
    for i in range(14):
        R, t = poses[i]
        il = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, B)
        sys.track_stereo(il, scene.render(Rr, tr), ts=i / 20.0)
    assert sys.state == TrackState.OK
    assert len(sys.atlas.maps) == 1
    kf_a = sys.map.n_kf
    assert kf_a >= 11, kf_a

    # phase 2: blackout → loss → new map spawned
    blank = np.zeros((scene.h, scene.w), np.float32)
    for j in range(7):
        sys.track_stereo(blank, blank, ts=(10 + j) / 20.0)
    assert len(sys.atlas.maps) == 2, sys.atlas.maps
    assert sys.map.n_kf == 0  # fresh map, not yet initialized

    # phase 3: revisit original view → the new map re-initializes instantly
    # (stereo), then cross-map place recognition at the next keyframes merges
    # it back into map A (reference MergeLocal2 flow)
    for j in range(8):
        R, t = poses[3 + j % 4]
        il = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, B)
        sys.track_stereo(il, scene.render(Rr, tr), ts=(21 + j) / 20.0)
        if sys.atlas.merges:
            break
    assert sys.atlas.merges >= 1
    assert sys.state == TrackState.OK
    # merged map holds both sessions' keyframes
    assert sys.map.n_kf >= kf_a + 1


def test_merge_found_by_database_query_against_old_keyframe():
    """With loop closing enabled, merge candidates come from a BoW database
    query over WHOLE stored maps in the loop-closing path (reference
    DetectNBestCandidates merge split, src/KeyFrameDatabase.cc:67) — the
    merge target here is an EARLY keyframe of the stored map, which the r3
    brute-force scan of the 10 newest keyframes could never find."""
    scene = RoomScene(seed=5, depth=6.0, half_w=4.0, half_h=2.5)
    n1 = 24
    poses = orbit_trajectory(n1, radius=0.6, forward=0.08)
    B = 0.11
    bf = B * scene.fx
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                     seed=0, tracking_params=dense_tracking_params(),
                     bf=bf, th_depth=B * 40, enable_loop_closing=True)
    sys.tracker.frames_to_new_map = 4
    sys.tracker.p.kf_interval_override = 1

    # phase 1: traverse away from the start — map A spans the whole path
    for i in range(n1):
        R, t = poses[i]
        il = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, B)
        sys.track_stereo(il, scene.render(Rr, tr), ts=i / 20.0)
    assert sys.state == TrackState.OK
    kf_a = sys.map.n_kf
    assert kf_a >= 15, kf_a

    # phase 2: blackout → loss → fresh map
    blank = np.zeros((scene.h, scene.w), np.float32)
    for j in range(7):
        sys.track_stereo(blank, blank, ts=(n1 + j) / 20.0)
    assert len(sys.atlas.maps) == 2

    # phase 3: revisit the START of the stored map (its keyframes there are
    # far outside the 10 newest) — the database query must find the merge
    for j in range(10):
        R, t = poses[2 + j % 4]
        il = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, B)
        sys.track_stereo(il, scene.render(Rr, tr),
                         ts=(n1 + 8 + j) / 20.0)
        if sys.atlas.merges:
            break
    assert sys.atlas.merges >= 1
    lc_stats = sys.stats()
    assert lc_stats.get("merges_detected", 0) >= 1, lc_stats
