"""Instrumented longrun repro (VERDICT r3 Weak #2 / test_longrun@600 failure).

Replays tests/test_longrun.py's fixture on CPU, logging per-frame state
transitions and map health to find where tracking drops.
Run: python scripts/debug_longrun.py [n_frames]
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_jax.models.map import MapConfig
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackingParams, TrackState
from orbslam3_jax.utils.datasets import RoomScene
from orbslam3_jax.utils.evaluation import evaluate_trajectory

N_FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 600
PERIOD = 400
FPS = 20.0


def walk_pose(i: int):
    ph = 2 * np.pi * (i % PERIOD) / PERIOD
    c = np.array([2.5 * np.sin(ph), 0.6 * np.sin(2 * ph),
                  2.0 + 1.2 * np.cos(ph)])
    yaw = 0.25 * np.sin(ph + 0.7)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    R_cw = R_wc.T
    return R_cw, -R_cw @ c


def main():
    scene = RoomScene(seed=3, h=240, w=376, fx=229.3, fy=228.6,
                      cx=188.0, cy=120.0, n_clutter=6)
    slam = SlamSystem(
        scene.K, None, (scene.w, scene.h), n_features=256, seed=0,
        tracking_params=TrackingParams(kf_interval_override=5),
        map_cfg=MapConfig(max_keyframes=96, max_map_points=8192))
    blackout = range(N_FRAMES // 2, N_FRAMES // 2 + 8)
    render_cache: dict[int, np.ndarray] = {}
    black = np.zeros((scene.h, scene.w), np.float32)
    states = []
    prev_state = None
    gt_ts, gt_c = [], []
    for i in range(N_FRAMES):
        R, t = walk_pose(i)
        if i in blackout:
            img = black
        else:
            key = i % PERIOD
            if key not in render_cache:
                render_cache[key] = scene.render(R, t)
            img = render_cache[key]
        info = slam.track_monocular(img, ts=i / FPS)
        gt_ts.append(i / FPS)
        gt_c.append(-R.T @ t)
        slam.tracker.flush_pending()
        st = slam.state
        states.append(st)
        if os.environ.get("DBG_EVERY") and (
                info.get("inliers", 99) < 60 or i % 5 == 0):
            m = slam.map
            print(f"  f{i:4d} {st.name:14s} kf={int(m.kf_valid.sum()):3d} "
                  f"mp={int(m.mp_valid.sum()):5d} info={info}")
        if st != prev_state:
            m = slam.map
            print(f"f{i:4d} {prev_state and prev_state.name}->{st.name:14s} "
                  f"kf={int(m.kf_valid.sum()):3d} "
                  f"mp={int(m.mp_valid.sum()):5d} "
                  f"maps={len(slam.atlas.maps)} info={info}")
            prev_state = st
    ok = np.array([s == TrackState.OK for s in states])
    print(f"ok[60:].mean = {ok[60:].mean():.4f}  "
          f"ok[-200:].mean = {ok[-200:].mean():.4f}")
    not_ok = np.where(~ok[60:])[0] + 60
    print("not-OK frames:", not_ok[:80], "..." if len(not_ok) > 80 else "")
    st = slam.stats()
    print({k: v for k, v in st.items()
           if k not in ("stage_times",) and np.isscalar(v)})
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    sel = ~lost & (ts > (max(blackout) + 1) / FPS)
    if sel.sum() > 10:
        ate, n = evaluate_trajectory(np.asarray(gt_ts), np.asarray(gt_c),
                                     ts[sel], t_wc[sel], with_scale=True)
        print(f"post-blackout ATE={ate:.4f} n_assoc={n} sel={int(sel.sum())}")


if __name__ == "__main__":
    main()
