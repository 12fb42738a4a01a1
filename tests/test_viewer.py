"""Viewer parity: headless map/frame rendering + the live HTTP viewer
(reference Viewer/FrameDrawer/MapDrawer, src/Viewer.cc:130-250)."""
import time
import urllib.request

import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory


@pytest.fixture(scope="module")
def small_run():
    scene = RoomScene(seed=1, n_clutter=3)
    poses = orbit_trajectory(8, radius=1.0, forward=0.0)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=256,
                      seed=0, use_viewer=True, viewer_port=8698,
                      tracking_params=dense_tracking_params())
    for i, (R, t) in enumerate(poses):
        slam.track_monocular(scene.render(R, t), ts=i / 20.0)
    yield slam
    slam.shutdown(print_times=False)


def test_headless_render(small_run, tmp_path):
    from orbslam3_jax.models import viewer
    out = tmp_path / "map.png"
    ts, R_wc, t_wc, lost = small_run.export_trajectory()
    viewer.render_map(small_run.map, str(out), trajectory=t_wc)
    assert out.stat().st_size > 10_000


def test_live_viewer_serves(small_run):
    time.sleep(1.5)   # let the render thread produce at least one frame
    base = "http://127.0.0.1:8698"
    page = urllib.request.urlopen(base + "/", timeout=20).read()
    assert b"live viewer" in page
    png = urllib.request.urlopen(base + "/map.png", timeout=20).read()
    assert png[:4] == b"\x89PNG"
    state = urllib.request.urlopen(base + "/state", timeout=20).read()
    assert b"n_keyframes" in state
    # menu toggle flips the flag (reference menuShowGraph)
    g0 = small_run.viewer.toggles["show_graph"]
    urllib.request.urlopen(base + "/toggle?key=show_graph", timeout=20).read()
    assert small_run.viewer.toggles["show_graph"] != g0
    # localization-mode action reaches the System API (reference
    # menuLocalizationMode -> ActivateLocalizationMode)
    urllib.request.urlopen(base + "/action?do=localization", timeout=20).read()
    assert small_run.tracker.only_tracking
    urllib.request.urlopen(base + "/action?do=mapping", timeout=20).read()
    assert not small_run.tracker.only_tracking
