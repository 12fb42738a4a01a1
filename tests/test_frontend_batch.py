"""Multi-stream frontend on the 8-virtual-device mesh: per-stream results
must match the single-stream path bitwise-ish (same kernels, vmapped)."""
import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import features as feat_ops, pose_opt
from orbslam3_jax.models import kernels
from orbslam3_jax.parallel import sharded_ba
from orbslam3_jax.parallel.frontend_batch import make_batched_frontend


def test_batched_frontend_matches_single():
    n_dev = len(jax.devices())
    S = n_dev  # one stream per device
    h, w = 96, 128
    cfg = feat_ops.OrbConfig(n_features=128, n_levels=3)
    n_mp = 256
    rng = np.random.default_rng(0)
    mesh = sharded_ba.make_mesh(n_dev)
    step = make_batched_frontend(mesh, h, w, cfg, n_mp)

    imgs = rng.uniform(0, 255, (S, h, w)).astype(np.float32)
    K = np.tile(np.array([100.0, 100.0, 64.0, 48.0], np.float32), (S, 1))
    R0 = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
    t0 = np.zeros((S, 3), np.float32)
    mp_xyz = rng.uniform([-2, -2, 3], [2, 2, 8], (S, n_mp, 3)).astype(np.float32)
    mp_desc = rng.integers(0, 2**32, (S, n_mp, 8), dtype=np.uint32)
    mp_normal = np.tile(np.array([0, 0, -1.0], np.float32), (S, n_mp, 1))
    mp_mind = np.full((S, n_mp), 0.1, np.float32)
    mp_maxd = np.full((S, n_mp), 50.0, np.float32)
    mp_valid = np.ones((S, n_mp), bool)

    R, t, ninl = jax.block_until_ready(step(
        jnp.asarray(imgs), jnp.asarray(R0), jnp.asarray(t0),
        jnp.asarray(mp_xyz), jnp.asarray(mp_desc), jnp.asarray(mp_normal),
        jnp.asarray(mp_mind), jnp.asarray(mp_maxd), jnp.asarray(mp_valid),
        jnp.asarray(K)))
    assert R.shape == (S, 3, 3) and t.shape == (S, 3)
    assert np.isfinite(np.asarray(R)).all() and np.isfinite(np.asarray(t)).all()

    # single-stream reference for stream 0
    proj_match = kernels.projection_matcher(0, cfg.n_levels, cfg.scale)
    cap = cfg.total_capacity
    wh = jnp.asarray([float(w), float(h)], jnp.float32)

    def single(i):
        feats = feat_ops.extract_orb(jnp.asarray(imgs[i]), cfg)
        idx, ok, uv, lvl, frustum = proj_match(
            jnp.asarray(mp_xyz[i]), jnp.asarray(mp_desc[i]),
            jnp.asarray(mp_normal[i]), jnp.asarray(mp_mind[i]),
            jnp.asarray(mp_maxd[i]), jnp.asarray(mp_valid[i]),
            jnp.asarray(R0[i]), jnp.asarray(t0[i]), jnp.asarray(K[i]),
            feats.xy, feats.desc, feats.octave, feats.valid, wh,
            jnp.asarray(8.0, jnp.float32), jnp.asarray(0.9, jnp.float32),
            jnp.asarray(100, jnp.int32), jnp.asarray(0.5, jnp.float32))
        # each matched row's point in its feature's slot, in plain numpy
        rows = np.nonzero(np.asarray(ok))[0]
        slots = np.asarray(idx)[rows]
        assert len(set(slots.tolist())) == len(slots)
        pts = np.zeros((cap, 3), np.float32)
        pts[slots] = mp_xyz[i][rows]
        valid = np.zeros(cap, bool)
        valid[slots] = True
        pts, valid = jnp.asarray(pts), jnp.asarray(valid)
        inv_s2 = 1.0 / (cfg.scale ** (2.0 * feats.octave.astype(jnp.float32)))
        return pose_opt.pose_optimize(jnp.asarray(R0[i]), jnp.asarray(t0[i]),
                                      pts, feats.xy, inv_s2, valid,
                                      jnp.asarray(K[i]))

    ref = single(0)
    np.testing.assert_allclose(np.asarray(R)[0], np.asarray(ref.R),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(t)[0], np.asarray(ref.t),
                               rtol=0, atol=5e-4)
