"""Map/Atlas save-load roundtrip + timing instrumentation."""
import numpy as np

from orbslam3_jax.models.atlas import Atlas
from orbslam3_jax.models.map import MapConfig, MapState
from orbslam3_jax.utils import serialization as ser
from orbslam3_jax.utils.timing import StageTimer


def _toy_map(seed=0):
    rng = np.random.default_rng(seed)
    cfg = MapConfig(max_keyframes=16, max_map_points=256, n_features=64)
    m = MapState(cfg)
    for k in range(3):
        n = 40
        m.add_keyframe(np.eye(3, dtype=np.float32),
                       np.asarray([0.1 * k, 0, 0], np.float32), k * 0.05, k,
                       rng.uniform(0, 100, (n, 2)).astype(np.float32),
                       rng.uniform(-3, 3, n).astype(np.float32),
                       rng.integers(0, 8, n).astype(np.int32),
                       rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
                       np.ones(n, bool))
    ids = m.add_map_points(
        rng.normal(0, 1, (30, 3)).astype(np.float32),
        rng.integers(0, 2 ** 32, (30, 8), dtype=np.uint32), 0,
        np.tile([0, 0, 1.0], (30, 1)).astype(np.float32),
        np.full(30, 0.5, np.float32), np.full(30, 10.0, np.float32))
    m.kf_feat_mp[0, :30] = ids
    return m


def test_map_roundtrip(tmp_path):
    m = _toy_map()
    p = str(tmp_path / "map.npz")
    ser.save_map(m, p)
    m2 = ser.load_map(p)
    assert m2.n_kf == m.n_kf and m2.n_mp == m.n_mp
    assert np.array_equal(m2.kf_feat_desc, m.kf_feat_desc)
    assert np.array_equal(m2.mp_xyz, m.mp_xyz)
    assert np.array_equal(m2.kf_feat_mp, m.kf_feat_mp)
    # derived relations survive
    assert np.array_equal(m2.covisibility_row(0), m.covisibility_row(0))


def test_atlas_roundtrip(tmp_path):
    cfg = MapConfig(max_keyframes=16, max_map_points=256, n_features=64)
    atlas = Atlas(cfg)
    atlas.maps[0] = _toy_map(1)
    atlas.create_new_map()
    atlas.maps[1] = _toy_map(2)
    atlas.current_idx = 1
    d = str(tmp_path / "atlas")
    ser.save_atlas(atlas, d)
    a2 = ser.load_atlas(d, cfg)
    assert len(a2.maps) == 2
    assert a2.current_idx == 1
    assert np.array_equal(a2.maps[0].mp_xyz, atlas.maps[0].mp_xyz)


def test_stage_timer():
    t = StageTimer()
    with t.stage("extract"):
        pass
    t.add("ba", 0.01)
    s = t.stats()
    assert "extract" in s and s["ba"]["mean_ms"] == 10.0
