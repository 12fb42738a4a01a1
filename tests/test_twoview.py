import numpy as np
import pytest
import jax.numpy as jnp

from orbslam3_jax.ops import lie, twoview


def make_pair(n=300, noise_n=0.5 / 458.0, n_out=30, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 15, n)
    ], -1).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.01, -0.06, 0.02], jnp.float32)))
    t = np.array([-0.6, 0.05, 0.1], np.float32)
    t = t / np.linalg.norm(t)
    pc1 = pts
    pc2 = pts @ R.T + t
    x1 = pc1[:, :2] / pc1[:, 2:3] + rng.normal(0, noise_n, (n, 2))
    x2 = pc2[:, :2] / pc2[:, 2:3] + rng.normal(0, noise_n, (n, 2))
    # outliers: shuffle some correspondences
    idx = rng.choice(n, n_out, replace=False)
    x2[idx] = x2[rng.permutation(idx)]
    return pts, R, t, x1.astype(np.float32), x2.astype(np.float32), idx


def test_two_view_reconstruction_recovers_motion():
    pts, R_gt, t_gt, x1, x2, out_idx = make_pair()
    n = len(x1)
    rng = np.random.default_rng(1)
    rand_sets = rng.integers(0, n, size=(200, 8)).astype(np.int32)
    res = twoview.reconstruct_two_views(
        jnp.asarray(x1), jnp.asarray(x2), jnp.ones(n, bool),
        jnp.asarray(rand_sets), sigma_n=1.0 / 458.0,
    )
    assert bool(res.success)
    assert not bool(res.is_homography)
    assert np.abs(np.asarray(res.R) - R_gt).max() < 0.01
    # translation up to sign is fixed by cheirality; compare directly
    assert np.abs(np.asarray(res.t) - t_gt).max() < 0.05, (np.asarray(res.t), t_gt)
    # triangulated points match gt after depth-scale alignment; absolute depth
    # error grows with baseline-direction error × depth/parallax, so compare
    # relative structure, not absolute coords
    good = np.asarray(res.good)
    assert good.sum() > 150
    est = np.asarray(res.pts)[good]
    gt = pts[good]
    s = np.median(gt[:, 2] / est[:, 2])
    rel = np.linalg.norm(est * s - gt, axis=-1) / gt[:, 2]
    assert np.median(rel) < 0.05, np.median(rel)


def test_two_view_planar_scene_is_safe():
    """Planar scene: the Faugeras H path (and the reconstruction gates on the
    F path) must never return a *successful but geometrically wrong* bootstrap.
    Note the reference's RH>0.50 rule (src/TwoViewReconstruction.cc:135) picks
    F even on a pure plane (the 1-DoF epipolar score always beats the 2-DoF H
    score on points fitting both models); with the 8-way H candidates in the
    pool, whichever model wins must yield the true motion when it succeeds."""
    rng = np.random.default_rng(2)
    n = 200
    # points on a plane z = 8 + 0.3x + 0.1y
    xy = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n)], -1)
    z = 8 + 0.3 * xy[:, 0] + 0.1 * xy[:, 1]
    pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.0, -0.04, 0.01], jnp.float32)))
    t = np.array([-0.5, 0.0, 0.05], np.float32)
    pc2 = pts @ R.T + t
    x1 = (pts[:, :2] / pts[:, 2:3]).astype(np.float32)
    x2 = (pc2[:, :2] / pc2[:, 2:3]).astype(np.float32)
    rand_sets = rng.integers(0, n, size=(200, 8)).astype(np.int32)
    res = twoview.reconstruct_two_views(
        jnp.asarray(x1), jnp.asarray(x2), jnp.ones(n, bool),
        jnp.asarray(rand_sets), sigma_n=1.0 / 458.0,
    )
    if bool(res.success):
        # whenever it claims success, the motion must actually be right
        t_unit = t / np.linalg.norm(t)
        assert np.abs(np.asarray(res.R) - R).max() < 0.05
        assert np.abs(np.asarray(res.t) - t_unit).max() < 0.1, np.asarray(res.t)


def test_homography_decomposition_contains_truth():
    """Faugeras 8-way decomposition must contain the true (R, t/|t|)."""
    rng = np.random.default_rng(4)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.12, 0.08], jnp.float32)))
    t = np.array([0.4, -0.1, 0.2], np.float32)
    n = np.array([0.1, -0.05, 1.0]); n /= np.linalg.norm(n)
    d = 5.0
    H = R + np.outer(t, n) / d
    R8, t8, n8 = twoview.decompose_homography(jnp.asarray(H, jnp.float32))
    t_unit = t / np.linalg.norm(t)
    r_errs = np.abs(np.asarray(R8) - R).max(axis=(1, 2))
    t_errs = np.abs(np.asarray(t8) - t_unit).max(axis=1)
    best = np.argmin(r_errs + t_errs)
    assert r_errs[best] < 1e-3, r_errs
    assert t_errs[best] < 1e-3, t_errs


def test_two_view_fails_on_garbage():
    rng = np.random.default_rng(3)
    n = 200
    x1 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    rand_sets = rng.integers(0, n, size=(200, 8)).astype(np.int32)
    res = twoview.reconstruct_two_views(
        jnp.asarray(x1), jnp.asarray(x2), jnp.ones(n, bool),
        jnp.asarray(rand_sets), sigma_n=1.0 / 458.0,
    )
    assert not bool(res.success)
