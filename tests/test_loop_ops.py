import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import lie, posegraph, sim3, vocab


def test_horn_sim3_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.2, -0.3, 0.5], jnp.float32)))
    s_gt, t_gt = 1.4, np.array([0.3, -1.0, 2.0], np.float32)
    y = s_gt * x @ R.T + t_gt
    s, Re, te = sim3.horn_sim3(jnp.asarray(x), jnp.asarray(y))
    assert abs(float(s) - s_gt) < 1e-4
    assert np.abs(np.asarray(Re) - R).max() < 1e-4
    assert np.abs(np.asarray(te) - t_gt).max() < 1e-3


def test_sim3_ransac_with_outliers():
    rng = np.random.default_rng(1)
    n = 80
    x = (rng.normal(size=(n, 3)) * [2, 2, 1] + [0, 0, 6]).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.05, 0.8, -0.1], jnp.float32)))
    s_gt, t_gt = 1.2, np.array([1.0, 0.2, -0.5], np.float32)
    y = s_gt * x @ R.T + t_gt
    out = rng.choice(n, 20, replace=False)
    y[out] += rng.normal(0, 3.0, (20, 3))
    K = jnp.asarray([458.0, 458.0, 376.0, 240.0], jnp.float32)
    rand = rng.integers(0, n, (100, 3)).astype(np.int32)
    th = jnp.full(n, 9.21 * 4.0)
    res = sim3.sim3_ransac(jnp.asarray(x), jnp.asarray(y), jnp.ones(n, bool),
                           jnp.asarray(rand), th, th, K)
    assert bool(res.success)
    assert abs(float(res.s) - s_gt) < 0.02
    assert np.abs(np.asarray(res.R) - R).max() < 0.02
    assert int(res.n_inliers) >= 50


def test_pose_graph_closes_loop():
    """Chain of 12 nodes with odometry edges + one loop edge; drift injected
    into the odometry — the loop edge should pull the chain closed."""
    rng = np.random.default_rng(2)
    K = 12
    # ground truth: circle
    angles = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
    gt_t = np.stack([np.cos(angles), np.sin(angles), np.zeros(K)], -1).astype(np.float32) * 3
    gt_R = np.stack([np.asarray(lie.so3_exp(jnp.asarray([0, 0, a], jnp.float32))) for a in angles])
    gt_s = np.ones(K, np.float32)

    # odometry measurements: exact relative Sim3 between consecutive (+ loop K-1→0)
    edges_i, edges_j, ms, mR, mt = [], [], [], [], []
    def rel(i, j):
        si, Ri, ti = gt_s[i], gt_R[i], gt_t[i]
        sj, Rj, tj = gt_s[j], gt_R[j], gt_t[j]
        sji, Rji, tji = lie.sim3_inverse(jnp.asarray(sj), jnp.asarray(Rj), jnp.asarray(tj))
        return lie.sim3_compose(jnp.asarray(si), jnp.asarray(Ri), jnp.asarray(ti), sji, Rji, tji)
    for i in range(K - 1):
        s_, R_, t_ = rel(i + 1, i)
        edges_i.append(i + 1); edges_j.append(i)
        ms.append(float(s_)); mR.append(np.asarray(R_)); mt.append(np.asarray(t_))
    s_, R_, t_ = rel(0, K - 1)
    edges_i.append(0); edges_j.append(K - 1)
    ms.append(float(s_)); mR.append(np.asarray(R_)); mt.append(np.asarray(t_))

    # initial estimates: accumulate odometry with injected drift
    est_R = [gt_R[0]]; est_t = [gt_t[0]]; est_s = [1.0]
    for i in range(1, K):
        drift = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3).astype(np.float32))))
        est_R.append(drift @ gt_R[i])
        est_t.append(gt_t[i] + rng.normal(0, 0.2, 3).astype(np.float32))
        est_s.append(float(np.exp(rng.normal(0, 0.03))))
    fixed = np.zeros(K, bool); fixed[0] = True

    s, R, t, costs = posegraph.optimize_pose_graph(
        jnp.asarray(np.asarray(est_s, np.float32)), jnp.asarray(np.stack(est_R)),
        jnp.asarray(np.stack(est_t).astype(np.float32)),
        jnp.ones(K, bool), jnp.asarray(fixed),
        jnp.asarray(edges_i, jnp.int32), jnp.asarray(edges_j, jnp.int32),
        jnp.asarray(ms, jnp.float32), jnp.asarray(np.stack(mR)),
        jnp.asarray(np.stack(mt).astype(np.float32)),
        jnp.ones(K, bool), jnp.ones(K, jnp.float32), iters=15)
    t_err = np.abs(np.asarray(t) - gt_t).max()
    s_err = np.abs(np.asarray(s) - 1.0).max()
    assert float(costs[-1]) < 1e-5, float(costs[-1])
    assert t_err < 0.02, t_err
    assert s_err < 0.01, s_err


def test_vocab_transform_and_scoring():
    rng = np.random.default_rng(3)
    train = vocab.random_descriptors(20000, seed=0)
    v = vocab.BinaryVocabulary(k=8, levels=3).train(train, seed=0)
    tf = v.transform_fn()
    bow = v.bow_fn()

    d1 = vocab.random_descriptors(300, seed=1)
    d1b = d1.copy()
    # perturb a few bits of each descriptor (same place, different view)
    bits = np.unpackbits(d1b.view(np.uint8), axis=-1)
    flip = rng.random(bits.shape) < 0.03
    bits = bits ^ flip
    d1b = np.packbits(bits, axis=-1).view(np.uint32).reshape(-1, 8)
    d2 = vocab.random_descriptors(300, seed=99)

    ones = jnp.ones(300, bool)
    w1 = tf(jnp.asarray(d1), ones)
    w1b = tf(jnp.asarray(d1b), ones)
    w2 = tf(jnp.asarray(d2), ones)
    # greedy tree descent is per-descriptor brittle (each flipped bit can cross
    # a centroid boundary); what matters is the aggregate histogram separation
    assert (np.asarray(w1) == np.asarray(w1b)).mean() > 0.35
    v1 = bow(w1); v1b = bow(w1b); v2 = bow(w2)
    db = jnp.stack([v1b, v2])
    scores = np.asarray(vocab.l1_scores(v1, db))
    assert scores[0] > 1.8 * scores[1], scores


def test_pose_graph_4dof_preserves_gravity_and_scale():
    """4DoF essential graph (reference OptimizeEssentialGraph4DoF,
    src/Optimizer.cc:8367): with dof_mask = [0,0,yaw | v | 0] the correction
    moves yaw + translation only — every node's world-z direction (gravity
    axis of an IMU-aligned map) and scale are bit-preserved, yet the loop
    still closes in translation."""
    rng = np.random.default_rng(5)
    K = 10
    angles = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
    gt_t = np.stack([np.cos(angles), np.sin(angles), np.zeros(K)], -1).astype(np.float32) * 2
    gt_R = np.stack([np.asarray(lie.so3_exp(jnp.asarray([0, 0, a], jnp.float32)))
                     for a in angles])
    gt_s = np.ones(K, np.float32)

    edges_i, edges_j, ms, mR, mt = [], [], [], [], []

    def rel(i, j):
        sji, Rji, tji = lie.sim3_inverse(jnp.asarray(gt_s[j]), jnp.asarray(gt_R[j]),
                                         jnp.asarray(gt_t[j]))
        return lie.sim3_compose(jnp.asarray(gt_s[i]), jnp.asarray(gt_R[i]),
                                jnp.asarray(gt_t[i]), sji, Rji, tji)

    for i in range(K - 1):
        s_, R_, t_ = rel(i + 1, i)
        edges_i.append(i + 1); edges_j.append(i)
        ms.append(float(s_)); mR.append(np.asarray(R_)); mt.append(np.asarray(t_))
    s_, R_, t_ = rel(0, K - 1)
    edges_i.append(0); edges_j.append(K - 1)
    ms.append(float(s_)); mR.append(np.asarray(R_)); mt.append(np.asarray(t_))

    # drift: yaw-only rotation error + translation error (what an inertial
    # map accumulates — roll/pitch/scale are pinned by gravity/IMU)
    est_R = [gt_R[0]]; est_t = [gt_t[0]]
    for i in range(1, K):
        dyaw = np.asarray(lie.so3_exp(jnp.asarray(
            [0.0, 0.0, rng.normal(0, 0.05)], jnp.float32)))
        est_R.append(gt_R[i] @ dyaw)
        est_t.append(gt_t[i] + rng.normal(0, 0.15, 3).astype(np.float32))
    est_R = np.stack(est_R); est_t = np.stack(est_t).astype(np.float32)
    fixed = np.zeros(K, bool); fixed[0] = True
    dof = jnp.asarray(np.array([0, 0, 1, 1, 1, 1, 0], bool))

    s, R, t, costs = posegraph.optimize_pose_graph(
        jnp.ones(K, jnp.float32), jnp.asarray(est_R), jnp.asarray(est_t),
        jnp.ones(K, bool), jnp.asarray(fixed),
        jnp.asarray(edges_i, jnp.int32), jnp.asarray(edges_j, jnp.int32),
        jnp.asarray(ms, jnp.float32), jnp.asarray(np.stack(mR)),
        jnp.asarray(np.stack(mt).astype(np.float32)),
        jnp.ones(K, bool), jnp.ones(K, jnp.float32), iters=15, dof_mask=dof)
    s = np.asarray(s); R = np.asarray(R); t = np.asarray(t)
    # scale untouched
    assert np.abs(s - 1.0).max() < 1e-6
    # world gravity axis untouched: R @ e_z identical to the estimate's
    z_before = est_R @ np.array([0, 0, 1.0], np.float32)
    z_after = R @ np.array([0, 0, 1.0], np.float32)
    assert np.abs(z_after - z_before).max() < 1e-5
    # loop closed
    assert float(costs[-1]) < 1e-4, float(costs[-1])
    assert np.abs(t - gt_t).max() < 0.05, np.abs(t - gt_t).max()


def test_optimize_sim3_converges():
    """GN Sim3 refinement (reference Optimizer::OptimizeSim3
    src/Optimizer.cc:3555) recovers a known similarity from reprojections."""
    import jax.numpy as jnp
    from orbslam3_jax.ops import lie, sim3 as sim3_ops
    rng = np.random.default_rng(0)
    N = 120
    K = jnp.asarray([458.0, 458.0, 376.0, 240.0], jnp.float32)
    x1 = rng.uniform([-3, -2, 4], [3, 2, 10], (N, 3)).astype(np.float32)
    Rt = np.asarray(lie.so3_exp(jnp.asarray([0.01, 0.03, -0.02], jnp.float32)))
    st, tt = 1.05, np.array([0.2, -0.1, 0.15], np.float32)
    x2 = st * (x1 @ Rt.T) + tt

    def proj(p):
        return np.stack([458 * p[:, 0] / p[:, 2] + 376,
                         458 * p[:, 1] / p[:, 2] + 240], -1).astype(np.float32)

    uv1 = proj(x1) + rng.normal(0, 0.3, (N, 2))
    uv2 = proj(x2) + rng.normal(0, 0.3, (N, 2))
    res = sim3_ops.optimize_sim3(
        jnp.asarray(x1), jnp.asarray(x2.astype(np.float32)),
        jnp.asarray(uv1.astype(np.float32)), jnp.asarray(uv2.astype(np.float32)),
        jnp.ones(N, jnp.float32), jnp.ones(N, jnp.float32), jnp.ones(N, bool),
        jnp.asarray(1.0, jnp.float32), jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), K)
    assert abs(float(res.s) - st) < 0.005
    assert int(res.n_inliers) >= N - 2
    assert np.abs(np.asarray(res.R) - Rt).max() < 2e-3
    # fixed-scale mode pins s
    res2 = sim3_ops.optimize_sim3(
        jnp.asarray(x1), jnp.asarray(x2.astype(np.float32)),
        jnp.asarray(uv1.astype(np.float32)), jnp.asarray(uv2.astype(np.float32)),
        jnp.ones(N, jnp.float32), jnp.ones(N, jnp.float32), jnp.ones(N, bool),
        jnp.asarray(1.0, jnp.float32), jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), K, fix_scale=True)
    assert abs(float(res2.s) - 1.0) < 1e-5
