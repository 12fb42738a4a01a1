import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import lie, pnp


def test_pnp_ransac_recovers_pose_with_outliers():
    rng = np.random.default_rng(0)
    n = 120
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(5, 15, n)], -1).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.3, -0.5, 0.2], jnp.float32)))
    t = np.array([0.5, -0.3, 1.0], np.float32)
    xc = xw @ R.T + t
    rays = (xc / xc[:, 2:3]).astype(np.float32)
    rays[:, :2] += rng.normal(0, 0.5 / 458.0, (n, 2))  # 0.5 px noise
    # 25% outliers
    out = rng.choice(n, n // 4, replace=False)
    rays[out, :2] += rng.uniform(0.05, 0.2, (len(out), 2))

    rand = rng.integers(0, n, (256, 6)).astype(np.int32)
    res = pnp.pnp_ransac(jnp.asarray(xw), jnp.asarray(rays), jnp.ones(n, bool),
                         jnp.asarray(rand), jnp.ones(n, jnp.float32))
    assert bool(res.success)
    assert np.abs(np.asarray(res.R) - R).max() < 0.02, np.asarray(res.R) - R
    assert np.abs(np.asarray(res.t) - t).max() < 0.15, np.asarray(res.t)
    assert int(res.n_inliers) > 0.6 * (n - len(out))
    # injected outliers mostly rejected
    assert np.asarray(res.inliers)[out].mean() < 0.2


def test_epnp_recovers_pose():
    rng = np.random.default_rng(2)
    n = 80
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(5, 15, n)], -1).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([-0.2, 0.4, 0.1], jnp.float32)))
    t = np.array([-0.4, 0.2, 0.8], np.float32)
    xc = xw @ R.T + t
    xn = (xc[:, :2] / xc[:, 2:3]).astype(np.float32)
    Re, te = pnp.epnp(jnp.asarray(xw)[None], jnp.asarray(xn)[None])
    assert np.abs(np.asarray(Re[0]) - R).max() < 1e-3
    assert np.abs(np.asarray(te[0]) - t).max() < 5e-3


def test_epnp_ransac_with_outliers():
    rng = np.random.default_rng(3)
    n = 100
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(4, 12, n)], -1).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.1, 0.3, -0.2], jnp.float32)))
    t = np.array([0.2, -0.1, 0.5], np.float32)
    xc = xw @ R.T + t
    rays = (xc / xc[:, 2:3]).astype(np.float32)
    rays[:, :2] += rng.normal(0, 0.5 / 458.0, (n, 2))
    out = rng.choice(n, n // 5, replace=False)
    rays[out, :2] += rng.uniform(0.05, 0.2, (len(out), 2))
    rand = rng.integers(0, n, (256, 5)).astype(np.int32)
    res = pnp.epnp_ransac(jnp.asarray(xw), jnp.asarray(rays),
                          jnp.ones(n, bool), jnp.asarray(rand),
                          jnp.ones(n, jnp.float32))
    assert bool(res.success)
    assert np.abs(np.asarray(res.R) - R).max() < 0.02
    assert np.abs(np.asarray(res.t) - t).max() < 0.15
    assert np.asarray(res.inliers)[out].mean() < 0.2


def test_pnp_fails_on_garbage():
    rng = np.random.default_rng(1)
    n = 60
    xw = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rays = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                           np.ones((n, 1))], -1).astype(np.float32)
    rand = rng.integers(0, n, (128, 6)).astype(np.int32)
    res = pnp.pnp_ransac(jnp.asarray(xw), jnp.asarray(rays), jnp.ones(n, bool),
                         jnp.asarray(rand), jnp.ones(n, jnp.float32))
    assert not bool(res.success)


def test_mlpnp_refine_improves_dlt_pose():
    """MLPnP GN refinement (reference src/MLPnPsolver.cpp): from a coarse
    pose, covariance-weighted bearing optimization converges to the truth —
    including with non-pinhole bearing geometry (rays off the z≈1 plane)."""
    import jax.numpy as jnp
    from orbslam3_jax.ops import lie, pnp as pnp_ops
    rng = np.random.default_rng(2)
    N = 80
    xw = rng.uniform([-4, -3, 4], [4, 3, 14], (N, 3)).astype(np.float32)
    R_gt = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.1, 0.08], jnp.float32)))
    t_gt = np.asarray([0.3, -0.2, 0.5], np.float32)
    xc = xw @ R_gt.T + t_gt
    rays = xc / np.linalg.norm(xc, axis=-1, keepdims=True)
    # bearing noise ≈ 0.5 px at f=458
    rays = rays + rng.normal(0, 0.5 / 458.0, rays.shape).astype(np.float32)
    # coarse start
    R0 = np.asarray(lie.so3_exp(jnp.asarray([0.02, 0.03, -0.02], jnp.float32))) @ R_gt
    t0 = t_gt + np.asarray([0.1, -0.08, 0.12], np.float32)
    R, t = pnp_ops.mlpnp_refine(
        jnp.asarray(xw), jnp.asarray(rays.astype(np.float32)),
        jnp.full(N, 458.0 ** 2, jnp.float32), jnp.ones(N, bool),
        jnp.asarray(R0.astype(np.float32)), jnp.asarray(t0))
    err_R0 = np.abs(R0 - R_gt).max()
    err_R = np.abs(np.asarray(R) - R_gt).max()
    err_t = np.abs(np.asarray(t) - t_gt).max()
    assert err_R < 0.2 * err_R0, (err_R, err_R0)
    assert err_t < 0.03, err_t
