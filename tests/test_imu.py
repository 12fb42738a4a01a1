import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import imu, lie


def integrate(acc_fn, gyro_fn, n=100, dt=0.005, bg=None, ba=None):
    ts = np.arange(n) * dt
    acc = np.stack([acc_fn(t) for t in ts]).astype(np.float32)
    gyro = np.stack([gyro_fn(t) for t in ts]).astype(np.float32)
    dts = np.full(n, dt, np.float32)
    return imu.preintegrate(
        jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
        jnp.ones(n, bool),
        jnp.zeros(3) if bg is None else jnp.asarray(bg),
        jnp.zeros(3) if ba is None else jnp.asarray(ba),
        noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3, freq=200.0)


def test_static_body_measures_gravity():
    # body at rest, z-up: accelerometer reads +g in body z
    s = integrate(lambda t: [0, 0, imu.GRAVITY], lambda t: [0, 0, 0], n=200)
    assert np.allclose(np.asarray(s.dR), np.eye(3), atol=1e-5)
    # predicted state from rest should stay at rest
    R2, p2, v2 = imu.predict_state(jnp.eye(3), jnp.zeros(3), jnp.zeros(3), s,
                                   jnp.zeros(3), jnp.zeros(3))
    assert np.abs(np.asarray(v2)).max() < 1e-3
    assert np.abs(np.asarray(p2)).max() < 1e-3


def test_constant_rotation():
    w = np.array([0.3, -0.2, 0.5], np.float32)
    s = integrate(lambda t: [0, 0, 0], lambda t: w, n=100, dt=0.005)
    expected = np.asarray(lie.so3_exp(jnp.asarray(w * 0.5)))
    assert np.abs(np.asarray(s.dR) - expected).max() < 1e-4


def test_constant_acceleration_freefall_comp():
    a = np.array([1.0, 0.0, imu.GRAVITY], np.float32)  # 1 m/s² x + gravity comp
    s = integrate(lambda t: a, lambda t: [0, 0, 0], n=200, dt=0.005)
    T = float(s.dT)
    R2, p2, v2 = imu.predict_state(jnp.eye(3), jnp.zeros(3), jnp.zeros(3), s,
                                   jnp.zeros(3), jnp.zeros(3))
    assert np.allclose(np.asarray(v2), [1.0 * T, 0, 0], atol=1e-3)
    assert np.allclose(np.asarray(p2), [0.5 * T * T, 0, 0], atol=1e-3)


def test_bias_jacobian_correction_matches_reintegration():
    rng = np.random.default_rng(0)
    acc_t = lambda t: [np.sin(t * 3) * 2, np.cos(t * 2), 9.5 + 0.3 * np.sin(t)]
    gyr_t = lambda t: [0.4 * np.sin(t * 5), -0.2, 0.3 * np.cos(t * 4)]
    s0 = integrate(acc_t, gyr_t, n=100)
    db_g = np.array([0.01, -0.02, 0.015], np.float32)
    db_a = np.array([0.05, 0.02, -0.04], np.float32)
    # first-order correction
    dR_c, dV_c, dP_c = imu.corrected_delta(s0, jnp.asarray(db_g), jnp.asarray(db_a))
    # exact: re-integrate with biased measurements removed
    s1 = integrate(acc_t, gyr_t, n=100, bg=db_g, ba=db_a)
    assert np.abs(np.asarray(dR_c) - np.asarray(s1.dR)).max() < 2e-4
    assert np.abs(np.asarray(dV_c) - np.asarray(s1.dV)).max() < 5e-3
    assert np.abs(np.asarray(dP_c) - np.asarray(s1.dP)).max() < 2e-3


def test_residual_zero_for_consistent_states():
    acc_t = lambda t: [np.sin(t * 3), 0.2, 9.81]
    gyr_t = lambda t: [0.1, -0.05, 0.2]
    s = integrate(acc_t, gyr_t, n=100)
    R1 = jnp.eye(3)
    p1 = jnp.zeros(3)
    v1 = jnp.asarray([0.3, -0.1, 0.05])
    R2, p2, v2 = imu.predict_state(R1, p1, v1, s, jnp.zeros(3), jnp.zeros(3))
    r = imu.inertial_residual(R1, p1, v1, R2, p2, v2,
                              jnp.zeros(3), jnp.zeros(3), s)
    assert np.abs(np.asarray(r)).max() < 1e-4


def test_covariance_grows_and_is_psd():
    s = integrate(lambda t: [0, 0, 9.81], lambda t: [0.1, 0, 0], n=200)
    C = np.asarray(s.C)[:9, :9]
    assert np.all(np.linalg.eigvalsh(C) > -1e-12)
    assert np.trace(C) > 0


def test_invalid_slots_ignored():
    n = 50
    acc = np.tile([0, 0, 9.81], (n, 1)).astype(np.float32)
    gyro = np.zeros((n, 3), np.float32)
    dts = np.full(n, 0.005, np.float32)
    valid = np.zeros(n, bool)
    valid[:20] = True
    s = imu.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                         jnp.asarray(valid), jnp.zeros(3), jnp.zeros(3),
                         1e-4, 1e-3, 1e-5, 1e-4, 200.0)
    assert abs(float(s.dT) - 0.1) < 1e-6
