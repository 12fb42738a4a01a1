"""Inertial-only initialization: recover gravity direction, scale and biases
from keyframe poses + preintegrations on a synthetic trajectory."""
import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import imu as imu_ops
from orbslam3_jax.ops import imu_init, lie


def simulate(n_kf=10, kf_dt=0.25, hz=200, scale=0.25, g_tilt=(0.06, -0.04),
             bg=(0.004, -0.003, 0.002), ba=(0.03, -0.02, 0.05), seed=0):
    """Body moves on a smooth 3D curve; gravity tilted in the 'map' frame by
    Rwg; visual map scale differs from metric by `scale`."""
    rng = np.random.default_rng(seed)
    Rwg = np.asarray(lie.so3_exp(jnp.asarray([g_tilt[0], g_tilt[1], 0.0], jnp.float32)))
    g_true = Rwg @ np.array([0, 0, -imu_ops.GRAVITY])

    dt = 1.0 / hz
    n_steps = int(n_kf * kf_dt * hz)
    ts = np.arange(n_steps + 1) * dt
    # metric trajectory (world frame where gravity = g_true)
    p = np.stack([0.8 * np.sin(1.1 * ts), 0.5 * np.sin(0.9 * ts + 1), 0.3 * np.sin(0.7 * ts)], -1)
    v = np.gradient(p, dt, axis=0)
    a_w = np.gradient(v, dt, axis=0)
    # body orientation: slow rotation
    R_wb = np.stack([np.asarray(lie.so3_exp(jnp.asarray(
        [0.2 * np.sin(0.5 * t), 0.15 * t * 0.1, 0.3 * np.sin(0.3 * t)], jnp.float32))) for t in ts])
    # gyro from finite differences of R
    gyro = np.zeros((n_steps, 3))
    for i in range(n_steps):
        dRm = R_wb[i].T @ R_wb[i + 1]
        gyro[i] = np.asarray(lie.so3_log(jnp.asarray(dRm))) / dt
    acc = np.einsum("nji,nj->ni", R_wb[:-1], (a_w[:-1] - g_true))  # body-frame specific force

    # measured = true + bias
    gyro_m = gyro + np.asarray(bg)
    acc_m = acc + np.asarray(ba)

    per = int(kf_dt * hz)
    kf_idx = np.arange(0, n_steps + 1, per)[: n_kf]
    preints = []
    for i in range(len(kf_idx) - 1):
        s0, s1 = kf_idx[i], kf_idx[i + 1]
        st = imu_ops.preintegrate(
            jnp.asarray(acc_m[s0:s1], jnp.float32), jnp.asarray(gyro_m[s0:s1], jnp.float32),
            jnp.full(s1 - s0, dt, jnp.float32), jnp.ones(s1 - s0, bool),
            jnp.zeros(3), jnp.zeros(3), 1.7e-4, 2e-3, 1e-6, 1e-5, hz)
        preints.append(st)

    # visual map: scaled + gravity-unaligned poses (map world = Rwg⁻¹ world / scale...
    # choose: map positions = p / scale in the ROTATED frame Rwg^T world)
    p_map = (p[kf_idx] @ Rwg) / scale
    R_map = np.einsum("ij,kjl->kil", Rwg.T, R_wb[kf_idx])
    return (R_map.astype(np.float32), p_map.astype(np.float32), preints,
            Rwg, scale, np.asarray(bg), np.asarray(ba), v[kf_idx] )


def test_inertial_init_recovers_scale_gravity_bias():
    R_map, p_map, preints, Rwg_gt, scale_gt, bg_gt, ba_gt, v_gt = simulate()
    Kn = len(R_map)
    stack = lambda attr: jnp.asarray(np.stack([np.asarray(getattr(s, attr)) for s in preints]))
    cov = jnp.asarray(np.stack([np.asarray(s.C)[:9, :9] for s in preints]))
    res = imu_init.inertial_init(
        jnp.asarray(R_map), jnp.asarray(p_map),
        stack("dT"), stack("dR"), stack("dV"), stack("dP"),
        stack("JRg"), stack("JVg"), stack("JVa"), stack("JPg"), stack("JPa"),
        jnp.ones(Kn - 1, bool), cov=cov, opt_scale=True, iters=40, prior_a=1e2)
    s_est = float(res.scale)
    assert abs(s_est - scale_gt) / scale_gt < 0.03, s_est
    # gravity direction in map frame: g_map = Rwg_est @ [0,0,-g]; truth: the map
    # frame is Rwg_gt^T-rotated world → gravity in map frame = Rwg_gt^T g_true
    g_est = np.asarray(res.Rwg) @ np.array([0, 0, -imu_ops.GRAVITY])
    g_map_true = Rwg_gt.T @ (Rwg_gt @ np.array([0, 0, -imu_ops.GRAVITY]))
    cos = g_est @ g_map_true / (np.linalg.norm(g_est) * np.linalg.norm(g_map_true))
    assert cos > 0.9995, cos
    assert np.abs(np.asarray(res.bg) - bg_gt).max() < 2e-3, res.bg
    # acc bias is weakly observable on short windows; loose gate
    assert np.abs(np.asarray(res.ba) - ba_gt).max() < 0.08, res.ba


def test_apply_scaled_rotation_consistency():
    rng = np.random.default_rng(1)
    Kn = 5
    R = np.stack([np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3).astype(np.float32))))
                  for _ in range(Kn)])
    t = rng.normal(0, 1, (Kn, 3)).astype(np.float32)
    pts = rng.normal(0, 2, (30, 3)).astype(np.float32)
    Rgw = np.asarray(lie.so3_exp(jnp.asarray([0.1, -0.05, 0.0], jnp.float32)))
    s = 2.5
    Rn, tn, pn = imu_init.apply_scaled_rotation(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts), jnp.asarray(Rgw),
        jnp.asarray(s, jnp.float32))
    # projections must be preserved: xc' = s * xc (same direction)
    for k in range(Kn):
        xc = pts @ R[k].T + t[k]
        xc2 = np.asarray(pn) @ np.asarray(Rn)[k].T + np.asarray(tn)[k]
        assert np.abs(xc2 - s * xc).max() < 1e-4
