import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_jax.ops import camera


K = jnp.asarray([458.654, 457.296, 367.215, 248.375], dtype=jnp.float32)  # EuRoC-like
D = jnp.asarray([-0.2834, 0.0739, 1.99e-4, 1.76e-5, 0.0], dtype=jnp.float32)
KB = jnp.asarray([190.978, 190.973, 254.932, 256.897, 0.00348, 0.000715, -0.00205, 0.000202], dtype=jnp.float32)  # TUM-VI-like


def rand_points(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, size=(n,))
    y = rng.uniform(-1.0, 1.0, size=(n,))
    z = rng.uniform(0.5, 10.0, size=(n,))
    return jnp.asarray(np.stack([x * z * 0.3, y * z * 0.3, z], -1), dtype=jnp.float32)


def test_pinhole_roundtrip():
    xc = rand_points(256)
    uv = camera.pinhole_project(K, xc)
    ray = camera.pinhole_unproject(K, uv)
    # ray should be parallel to xc
    xc_n = np.asarray(xc) / np.asarray(xc)[..., 2:3]
    assert np.abs(np.asarray(ray) - xc_n).max() < 1e-4


def test_pinhole_jacobian_vs_autodiff():
    xc = rand_points(32, seed=1)
    J = np.asarray(camera.pinhole_project_jac(K, xc))
    Jad = np.asarray(jax.vmap(jax.jacfwd(lambda p: camera.pinhole_project(K, p)))(xc))
    assert np.abs(J - Jad).max() < 1e-3


def test_radtan_undistort_roundtrip():
    rng = np.random.default_rng(2)
    xn = jnp.asarray(rng.uniform(-0.6, 0.6, size=(128, 2)), dtype=jnp.float32)
    xd = camera.radtan_distort(D, xn)
    xu = camera.radtan_undistort(D, xd)
    assert np.abs(np.asarray(xu) - np.asarray(xn)).max() < 1e-4


def test_pinhole_undistort_pixels_matches_cv2():
    cv2 = __import__("cv2")
    rng = np.random.default_rng(3)
    uv = rng.uniform([50, 50], [680, 430], size=(64, 2)).astype(np.float32)
    Knp = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]], dtype=np.float32)
    Dnp = np.array([-0.2834, 0.0739, 1.99e-4, 1.76e-5], dtype=np.float32)
    ref = cv2.undistortPoints(uv.reshape(-1, 1, 2), Knp, Dnp, P=Knp).reshape(-1, 2)
    ours = np.asarray(camera.pinhole_undistort_pixels(K, D, jnp.asarray(uv)))
    # cv2 only runs 5 fixed-point iterations so it is itself ~0.2 px off at the
    # image edge; require loose agreement with cv2 but a tight true inverse.
    assert np.abs(ours - ref).max() < 0.5  # pixels
    xn = (ours - [367.215, 248.375]) / [458.654, 457.296]
    back = np.asarray(camera.radtan_distort(D, jnp.asarray(xn, dtype=jnp.float32)))
    back = back * [458.654, 457.296] + [367.215, 248.375]
    assert np.abs(back - uv).max() < 5e-3  # true roundtrip, pixels


def test_kb8_roundtrip():
    xc = rand_points(256, seed=4)
    uv = camera.kb8_project(KB, xc)
    ray = camera.kb8_unproject(KB, uv)
    xc_n = np.asarray(xc) / np.asarray(xc)[..., 2:3]
    assert np.abs(np.asarray(ray) - xc_n).max() < 1e-3


def test_kb8_project_matches_cv2_fisheye():
    cv2 = __import__("cv2")
    xc = rand_points(64, seed=5)
    Knp = np.array([[190.978, 0, 254.932], [0, 190.973, 256.897], [0, 0, 1]], dtype=np.float64)
    Dnp = np.array([0.00348, 0.000715, -0.00205, 0.000202], dtype=np.float64)
    obj = np.asarray(xc, dtype=np.float64).reshape(-1, 1, 3)
    ref, _ = cv2.fisheye.projectPoints(obj, np.zeros(3), np.zeros(3), Knp, Dnp)
    ours = np.asarray(camera.kb8_project(KB, xc))
    assert np.abs(ours - ref.reshape(-1, 2)).max() < 0.1


def test_kb8_jacobian_vs_autodiff():
    xc = rand_points(32, seed=6)
    J = np.asarray(camera.kb8_project_jac(KB, xc))
    Jad = np.asarray(jax.vmap(jax.jacfwd(lambda p: camera.kb8_project(KB, p)))(xc))
    assert np.abs(J - Jad).max() < 1e-2
