"""Map pool lifecycle: compaction, growth, remap callbacks.

The reference frees map memory through SetBadFlag/culling (reference
src/KeyFrame.cc:746, src/LocalMapping.cc:430) so it runs indefinitely; the SoA
pools here reclaim culled slots via MapState.compact() (order-preserving remap
announced to consumers) and grow() doubles capacity when culling cannot keep
up. These tests pin the remap protocol.
"""
import numpy as np
import pytest

from orbslam3_jax.models.map import MapConfig, MapState


def make_map(K=16, P=64, N=8):
    cfg = MapConfig(max_keyframes=K, max_map_points=P, n_features=N)
    return MapState(cfg)


def add_kf(m, ts=0.0):
    n = m.cfg.n_features
    return m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          ts, int(ts * 20),
                          np.zeros((n, 2), np.float32), np.zeros(n, np.float32),
                          np.zeros(n, np.int32),
                          np.zeros((n, 8), np.uint32), np.ones(n, bool))


def add_pts(m, k, count=4):
    xyz = np.random.default_rng(k).normal(size=(count, 3)).astype(np.float32)
    ids = m.add_map_points(xyz, np.zeros((count, 8), np.uint32), k,
                           np.tile([0, 0, 1.0], (count, 1)).astype(np.float32),
                           np.full(count, 0.1, np.float32),
                           np.full(count, 10.0, np.float32))
    m.kf_feat_mp[k, : count] = ids
    return ids


def test_compact_remaps_ids_and_fires_callbacks():
    m = make_map()
    for i in range(6):
        k = add_kf(m, ts=float(i))
        add_pts(m, k)
    # cull keyframe 2 and the points of keyframe 0
    ids0 = m.kf_feat_mp[0][m.kf_feat_mp[0] >= 0].copy()
    m.remove_keyframe(2)
    m.remove_map_points(ids0)
    seen = {}

    def cb(kf_remap, mp_remap):
        seen["kf"] = kf_remap.copy()
        seen["mp"] = mp_remap.copy()

    m.on_remap["t"] = cb
    old_xyz3 = m.mp_xyz[m.kf_feat_mp[3][m.kf_feat_mp[3] >= 0]].copy()
    old_ts = m.kf_ts[[0, 1, 3, 4, 5]].copy()
    kf_remap, mp_remap = m.compact()
    assert "kf" in seen and np.array_equal(seen["kf"], kf_remap)
    assert m.n_kf == 5 and kf_remap[2] == -1
    # order preserved
    assert np.array_equal(m.kf_ts[: m.n_kf], old_ts)
    # observations still point at the same 3D points
    k3 = kf_remap[3]
    mp3 = m.kf_feat_mp[k3][m.kf_feat_mp[k3] >= 0]
    assert np.allclose(m.mp_xyz[mp3], old_xyz3)
    # all culled points gone, survivors valid
    assert m.n_mp == m.mp_valid[: m.n_mp].sum()
    assert (mp_remap[ids0] == -1).all()


def test_compact_reanchors_dangling_refs():
    m = make_map()
    for i in range(4):
        k = add_kf(m, ts=float(i))
    ids = add_pts(m, 1)
    m.kf_feat_mp[2, :4] = ids      # second observer keeps the points alive
    m.remove_keyframe(1)           # the anchor dies
    assert (m.mp_ref_kf[ids] != 1).all()   # re-anchored at remove time
    m.compact()
    assert m.mp_valid[: m.n_mp].all()
    assert (m.mp_ref_kf[: m.n_mp] >= 0).all()
    assert (m.mp_ref_kf[: m.n_mp] < m.n_kf).all()


def test_grow_preserves_ids():
    m = make_map(K=4, P=8)
    ks = [add_kf(m, ts=float(i)) for i in range(4)]
    ids = add_pts(m, ks[0], 4)
    old_cfg = m.cfg
    k_new = add_kf(m, ts=9.0)       # triggers growth, must not raise
    assert k_new == 4
    assert m.cfg.max_keyframes == 2 * old_cfg.max_keyframes
    assert np.array_equal(m.kf_feat_mp[0, :4], ids)
    ids2 = m.add_map_points(np.zeros((8, 3), np.float32),
                            np.zeros((8, 8), np.uint32), 0,
                            np.tile([0, 0, 1.0], (8, 1)).astype(np.float32),
                            np.full(8, 0.1, np.float32),
                            np.full(8, 10.0, np.float32))
    assert m.cfg.max_map_points == 16
    assert ids2[0] == 4


def test_maybe_compact_compacts_then_grows():
    m = make_map(K=8, P=64)
    for i in range(8):
        add_kf(m, ts=float(i))
    for k in range(4):
        m.remove_keyframe(k + 2)
    kf_id = m.maybe_compact(7)
    assert m.n_kf == 4 and kf_id == 3          # compaction freed enough
    # now fill without culling: compaction can't help → growth
    for i in range(4):
        add_kf(m, ts=10.0 + i)
    kf_id = m.maybe_compact(m.n_kf - 1)
    assert m.cfg.max_keyframes > 8


def test_tracker_remap_integration():
    """Tracker-held ids (ref_kf, trajectory, live frame assignments) follow a
    compaction."""
    from orbslam3_jax.models.frame import Frame
    from orbslam3_jax.ops.features import OrbConfig
    from orbslam3_jax.models.tracking import Tracker

    m = make_map(K=16, P=64, N=8)
    cfg = OrbConfig(n_features=8)
    tr = Tracker(np.array([100.0, 100.0, 32.0, 32.0]), None, (64, 64),
                 cfg, m, seed=0)
    for i in range(5):
        k = add_kf(m, ts=float(i))
        add_pts(m, k)
    tr.ref_kf = 4
    mp_of_3 = int(m.kf_feat_mp[3][m.kf_feat_mp[3] >= 0][0])
    f = Frame(frame_id=10, ts=1.0, xy=np.zeros((8, 2), np.float32),
              angle=np.zeros(8, np.float32), octave=np.zeros(8, np.int32),
              desc=np.zeros((8, 8), np.uint32), valid=np.ones(8, bool))
    f.feat_mp = np.full(8, -1, np.int32)
    f.feat_mp[0] = mp_of_3
    tr.last_frame = f
    tr.trajectory.append((1.0, 3, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32), False))
    tr.kf_preints[4] = "sentinel"
    m.remove_keyframe(1)
    m.compact()
    assert tr.ref_kf == 3                      # 4 shifted down by one
    assert tr.trajectory[-1][1] == 2           # 3 shifted down by one
    assert tr.kf_preints == {3: "sentinel"}
    new_mp = f.feat_mp[0]
    k3 = 2
    assert new_mp in m.kf_feat_mp[k3]


def test_spanning_tree_reparent_and_compact():
    """Spanning tree (reference KeyFrame::mpParent): parent assignment
    survives culling (children re-parent to the grandparent,
    src/KeyFrame.cc:758-888) and compaction (value remap)."""
    from orbslam3_jax.models.map import MapConfig, MapState
    cfg = MapConfig(max_keyframes=8, max_map_points=64, n_features=8)
    m = MapState(cfg)
    rng = np.random.default_rng(0)
    for i in range(5):
        m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       ts=float(i), frame_id=i,
                       xy=rng.uniform(0, 10, (8, 2)).astype(np.float32),
                       angle=np.zeros(8, np.float32),
                       octave=np.zeros(8, np.int32),
                       desc=np.zeros((8, 8), np.uint32),
                       fvalid=np.ones(8, bool))
    # chain 0 <- 1 <- 2 <- 3 <- 4
    for k in range(1, 5):
        m.kf_parent[k] = k - 1
    # cull 2: its child 3 re-parents to 1 (grandparent)
    m.remove_keyframe(2)
    assert m.kf_parent[3] == 1
    # compact: ids shift down, parent values remap
    m.compact()
    # surviving order: old 0,1,3,4 -> new 0,1,2,3
    assert m.n_kf == 4
    assert m.kf_parent[2] == 1       # old 3 -> parent old 1 -> new 1
    assert m.kf_parent[3] == 2       # old 4 -> parent old 3 -> new 2
    assert m.kf_parent[0] == -1
