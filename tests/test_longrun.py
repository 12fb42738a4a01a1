"""Full-length-sequence survivability (VERDICT r1 gate: a 3,000+ frame run —
EuRoC-MH01 length and dynamics — completes in bounded memory with stable ATE).

The map is configured with deliberately SMALL pools (96 keyframes / 8,192
points — a fraction of what the insertion cadence produces over 3,000 frames)
so the run exercises the full reclamation machinery: keyframe/map-point
culling (reference src/LocalMapping.cc:430,1218) frees slots, MapState.compact
reclaims them, and growth stays a rarely-needed backstop. A mid-run blackout
exercises the loss → RECENTLY_LOST → relocalization/new-map path (reference
src/Tracking.cc:2007-2086).

The walk trajectory is periodic, so rendered frames repeat every lap — a
render cache keeps the test's cost in the SLAM pipeline, not the ray caster.

Default length is 600 frames (~5 min on the CPU mesh — the CI gate that
caught the r3 culling collapse); set ORBSLAM3_LONGRUN_FRAMES=3000 for the
full survivability run.
"""
import os

import numpy as np
import pytest

from orbslam3_jax.models.map import MapConfig
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackingParams, TrackState
from orbslam3_jax.utils.datasets import RoomScene
from orbslam3_jax.utils.evaluation import evaluate_trajectory

# multi-hundred-frame bounded-cost runs — excluded from the fast profile (pytest.ini)
pytestmark = pytest.mark.slow

N_FRAMES = int(os.environ.get("ORBSLAM3_LONGRUN_FRAMES", "600"))
PERIOD = 400
FPS = 20.0


def walk_pose(i: int):
    """Periodic walk inside the room (revisits every PERIOD frames) with
    bounded yaw — MH01-like gentle dynamics at 20 fps."""
    ph = 2 * np.pi * (i % PERIOD) / PERIOD
    c = np.array([2.5 * np.sin(ph), 0.6 * np.sin(2 * ph),
                  2.0 + 1.2 * np.cos(ph)])
    yaw = 0.25 * np.sin(ph + 0.7)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    R_cw = R_wc.T
    return R_cw, -R_cw @ c


@pytest.fixture(scope="module")
def longrun():
    scene = RoomScene(seed=3, h=240, w=376, fx=229.3, fy=228.6,
                      cx=188.0, cy=120.0, n_clutter=6)
    slam = SlamSystem(
        scene.K, None, (scene.w, scene.h), n_features=256, seed=0,
        tracking_params=TrackingParams(kf_interval_override=5),
        map_cfg=MapConfig(max_keyframes=96, max_map_points=8192))
    blackout = range(N_FRAMES // 2, N_FRAMES // 2 + 8)
    render_cache: dict[int, np.ndarray] = {}
    black = np.zeros((scene.h, scene.w), np.float32)
    gt_ts, gt_c, states = [], [], []
    for i in range(N_FRAMES):
        R, t = walk_pose(i)
        if i in blackout:
            img = black
        else:
            key = i % PERIOD
            if key not in render_cache:
                render_cache[key] = scene.render(R, t)
            img = render_cache[key]
        slam.track_monocular(img, ts=i / FPS)
        gt_ts.append(i / FPS)
        gt_c.append(-R.T @ t)
        states.append(slam.state)
    return slam, np.asarray(gt_ts), np.asarray(gt_c), states, blackout


def test_completes_in_bounded_memory(longrun):
    slam, gt_ts, gt_c, states, blackout = longrun
    m = slam.map
    # pools stayed bounded: culling + compaction reclaimed slots; growth (the
    # backstop) at most doubled each pool once
    for mp in slam.atlas.maps:
        assert mp.cfg.max_keyframes <= 192, mp.cfg
        assert mp.cfg.max_map_points <= 16384, mp.cfg
    total_compactions = sum(mp.n_compactions for mp in slam.atlas.maps)
    assert total_compactions >= 1            # reclamation actually ran
    st = slam.stats()
    assert st.get("culled_kf", 0) > 50       # culling kept up with insertion
    assert int(m.kf_valid.sum()) < 96


def test_tracks_throughout(longrun):
    slam, gt_ts, gt_c, states, blackout = longrun
    ok = np.array([s == TrackState.OK for s in states])
    # after initialization, tracking holds except around the blackout
    assert ok[60:].mean() > 0.85, ok[60:].mean()
    # recovery: within 40 frames after the blackout, tracking is OK again
    end = max(blackout) + 1
    assert any(ok[end:end + 40]), "no recovery after blackout"
    # and stays healthy to the end
    assert ok[-200:].mean() > 0.9


def test_ate_stable(longrun):
    """ATE of the final tracked segment (the active map's frame), Horn+scale —
    the long-run analogue of evaluate_ate_scale.py. The bound is loose (this
    is a survivability gate, not an accuracy benchmark) but catches scale
    runaways and monotone drift."""
    slam, gt_ts, gt_c, states, blackout = longrun
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    sel = ~lost & (ts > (max(blackout) + 1) / FPS)
    min_pts = int(0.6 * (N_FRAMES - max(blackout)))
    assert sel.sum() > min_pts
    ate, n_assoc = evaluate_trajectory(gt_ts, gt_c, ts[sel], t_wc[sel],
                                       with_scale=True)
    assert n_assoc > min_pts
    # scene scale ~8-12 units; keep < 5% of scene scale
    assert ate < 0.5, ate
