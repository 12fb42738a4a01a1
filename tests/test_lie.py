import numpy as np
import jax.numpy as jnp
import pytest

from orbslam3_jax.ops import lie


def rand_w(n, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(n, 3)) * scale, dtype=jnp.float32)


def test_hat_vee_roundtrip():
    w = rand_w(16)
    assert np.allclose(lie.vee(lie.hat(w)), w)


def test_exp_is_rotation():
    w = rand_w(32, 2.0)
    R = lie.so3_exp(w)
    eye = np.eye(3)
    err = np.abs(np.einsum("nij,nkj->nik", np.asarray(R), np.asarray(R)) - eye).max()
    assert err < 1e-5
    assert np.allclose(np.linalg.det(np.asarray(R)), 1.0, atol=1e-5)


def test_exp_log_roundtrip():
    for scale in (1e-6, 1e-3, 0.5, 2.0):
        w = rand_w(64, scale, seed=int(scale * 1000) + 1)
        # keep |w| < pi for uniqueness of log
        wn = np.linalg.norm(np.asarray(w), axis=-1, keepdims=True)
        w = jnp.asarray(np.asarray(w) * np.minimum(1.0, 3.0 / np.maximum(wn, 1e-12)))
        w2 = lie.so3_log(lie.so3_exp(w))
        assert np.allclose(w2, w, atol=5e-5), scale


def test_log_near_pi():
    axis = np.array([[1.0, 0, 0], [0, 1 / np.sqrt(2), 1 / np.sqrt(2)]])
    for theta in (3.10, 3.141):
        w = jnp.asarray(axis * theta, dtype=jnp.float32)
        R = lie.so3_exp(w)
        w2 = np.asarray(lie.so3_log(R))
        # log may return the equivalent negative-axis representation
        d = np.minimum(np.linalg.norm(w2 - np.asarray(w), axis=-1), np.linalg.norm(w2 + np.asarray(w), axis=-1))
        R2 = lie.so3_exp(jnp.asarray(w2))
        assert np.abs(np.asarray(R2) - np.asarray(R)).max() < 3e-3


def test_right_jacobian_finite_diff():
    w = rand_w(8, 0.7, seed=3)
    Jr = np.asarray(lie.so3_right_jacobian(w))
    eps = 1e-4
    for k in range(3):
        dw = np.zeros(3, dtype=np.float32)
        dw[k] = eps
        # Exp(w + dw) ≈ Exp(w) Exp(Jr dw)
        lhs = np.asarray(lie.so3_exp(w + jnp.asarray(dw)))
        rhs = np.asarray(lie.so3_exp(w)) @ np.asarray(lie.so3_exp(jnp.broadcast_to(jnp.asarray(Jr @ dw), (8, 3))))
        assert np.abs(lhs - rhs).max() < 1e-4


def test_right_jacobian_inverse():
    w = rand_w(16, 1.2, seed=4)
    Jr = np.asarray(lie.so3_right_jacobian(w))
    Jri = np.asarray(lie.so3_right_jacobian_inv(w))
    prod = np.einsum("nij,njk->nik", Jr, Jri)
    assert np.abs(prod - np.eye(3)).max() < 1e-4


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(5)
    xi = jnp.asarray(rng.normal(size=(32, 6)) * 0.8, dtype=jnp.float32)
    R, t = lie.se3_exp(xi)
    xi2 = lie.se3_log(R, t)
    assert np.allclose(xi2, xi, atol=1e-4)


def test_se3_compose_inverse():
    rng = np.random.default_rng(6)
    xi = jnp.asarray(rng.normal(size=(8, 6)) * 0.5, dtype=jnp.float32)
    R, t = lie.se3_exp(xi)
    Ri, ti = lie.se3_inverse(R, t)
    Rc, tc = lie.se3_compose(R, t, Ri, ti)
    assert np.abs(np.asarray(Rc) - np.eye(3)).max() < 1e-5
    assert np.abs(np.asarray(tc)).max() < 1e-5


def test_quat_roundtrip():
    w = rand_w(64, 2.0, seed=7)
    R = lie.so3_exp(w)
    q = lie.quat_from_mat(R)
    R2 = lie.mat_from_quat(q)
    assert np.abs(np.asarray(R2) - np.asarray(R)).max() < 1e-5


def test_normalize_rotation():
    w = rand_w(8, 1.0, seed=8)
    R = np.asarray(lie.so3_exp(w)) + np.random.default_rng(8).normal(size=(8, 3, 3)) * 1e-3
    Rn = np.asarray(lie.normalize_rotation(jnp.asarray(R, dtype=jnp.float32)))
    assert np.abs(np.einsum("nij,nkj->nik", Rn, Rn) - np.eye(3)).max() < 1e-5
    assert np.allclose(np.linalg.det(Rn), 1.0, atol=1e-5)


def test_sim3_exp_log_roundtrip():
    rng = np.random.default_rng(9)
    xi = np.concatenate(
        [rng.normal(size=(16, 3)) * 0.8, rng.normal(size=(16, 3)), rng.normal(size=(16, 1)) * 0.3],
        axis=-1,
    )
    xi = jnp.asarray(xi, dtype=jnp.float32)
    s, R, t = lie.sim3_exp(xi)
    xi2 = lie.sim3_log(s, R, t)
    assert np.allclose(xi2, xi, atol=2e-3)


def test_sim3_compose_apply():
    rng = np.random.default_rng(10)
    s = jnp.asarray(np.exp(rng.normal(size=(4,)) * 0.2), dtype=jnp.float32)
    R = lie.so3_exp(jnp.asarray(rng.normal(size=(4, 3)), dtype=jnp.float32))
    t = jnp.asarray(rng.normal(size=(4, 3)), dtype=jnp.float32)
    si, Ri, ti = lie.sim3_inverse(s, R, t)
    x = jnp.asarray(rng.normal(size=(4, 3)), dtype=jnp.float32)
    y = lie.sim3_apply(s, R, t, x)
    x2 = lie.sim3_apply(si, Ri, ti, y)
    assert np.allclose(x2, x, atol=1e-4)
