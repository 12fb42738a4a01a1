"""System facade API parity (reference include/System.h:134-193):
localization-only mode, resets, state getters, map save/load."""
import numpy as np

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory


def _run(sys, scene, poses, start=0, n=None):
    for i, (R, t) in enumerate(poses[start:n and start + n or None], start=start):
        img = scene.render(R, t)
        sys.track_monocular(img, ts=float(i) / 20.0)


def test_localization_mode_and_resets(tmp_path):
    scene = RoomScene(seed=1)
    poses = orbit_trajectory(26, radius=1.0, forward=0.04)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     enable_loop_closing=False)
    _run(sys, scene, poses, 0, 16)
    assert sys.get_tracking_state() == TrackState.OK
    n_kf = sys.stats()["n_keyframes"]
    assert n_kf >= 3

    # localization mode: tracking continues, the map is frozen
    sys.activate_localization_mode()
    _run(sys, scene, poses, 16, 10)
    assert sys.get_tracking_state() == TrackState.OK
    assert sys.stats()["n_keyframes"] == n_kf  # no new keyframes
    assert len(sys.get_tracked_map_points()) > 20
    assert sys.get_tracked_keypoints().shape[1] == 2
    sys.deactivate_localization_mode()

    # save / load roundtrip keeps the map usable
    d = str(tmp_path / "atlas")
    sys.save_map(d)
    xyz_before = sys.map.mp_xyz[sys.map.mp_valid].copy()
    sys2 = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0, tracking_params=dense_tracking_params(), enable_loop_closing=False)
    sys2.load_map(d)
    assert np.array_equal(sys2.map.mp_xyz[sys2.map.mp_valid], xyz_before)
    assert sys2.get_tracking_state() in (TrackState.RECENTLY_LOST,
                                         TrackState.NOT_INITIALIZED)

    # reset_active_map wipes the current map; reset wipes the atlas
    sys.reset_active_map()
    assert sys.stats()["n_keyframes"] == 0
    assert sys.get_tracking_state() == TrackState.NOT_INITIALIZED
    sys.reset()
    assert len(sys.atlas.maps) == 1
    assert sys.stats()["n_keyframes"] == 0
