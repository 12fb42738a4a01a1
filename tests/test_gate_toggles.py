"""Unit coverage for the adaptive-gate toggles (VERDICT r4 Next #2: each
empirically-tuned gate must be ablatable and must demonstrably change the
decision it guards)."""
import numpy as np

from orbslam3_jax.ops import features as feat_ops
from orbslam3_jax.models.map import MapConfig, MapState
from orbslam3_jax.models.tracking import Tracker, TrackingParams


def _tracker(**gate_kw):
    cfg = feat_ops.OrbConfig(n_features=128)
    m = MapState(MapConfig(n_features=cfg.total_capacity, max_keyframes=8,
                           max_map_points=256))
    K = np.array([458.0, 457.0, 376.0, 240.0], np.float32)
    return Tracker(K, None, (752, 480), cfg, m,
                   params=TrackingParams(**gate_kw))


def test_ema_floor_toggle():
    tr = _tracker()
    tr.inlier_ema = 300.0
    assert tr._min_local_inliers() == 60       # 0.2 * EMA floor active
    tr_off = _tracker(gate_ema_floor=False)
    tr_off.inlier_ema = 300.0
    assert tr_off._min_local_inliers() == tr_off.p.min_local_inliers


def test_anchor_health_toggle():
    tr = _tracker()
    # a degraded last frame (few matches) disables the anchored protections
    from orbslam3_jax.models.frame import Frame
    n = tr.orb_cfg.total_capacity
    lf = Frame(0, 0.0, xy=np.zeros((n, 2), np.float32),
               angle=np.zeros(n, np.float32), octave=np.zeros(n, np.int32),
               desc=np.zeros((n, 8), np.uint32), valid=np.ones(n, bool),
               tracked=True, R=np.eye(3, dtype=np.float32),
               t=np.zeros(3, np.float32))
    lf.feat_mp[:] = -1
    lf.feat_mp[:5] = np.arange(5)              # 5 matches: unhealthy
    tr.last_frame = lf
    assert tr._last_track_healthy() is False
    tr_off = _tracker(gate_anchor=False)
    tr_off.last_frame = lf
    assert tr_off._last_track_healthy() is True  # ablated: always protected
