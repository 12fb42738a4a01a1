"""Monocular-inertial end-to-end: IMU initialization recovers metric scale
and gravity on a synthetic sequence (camera = body, 200 Hz IMU)."""
import numpy as np
import jax.numpy as jnp
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.ops import lie
from orbslam3_jax.utils.datasets import RoomScene
from orbslam3_jax.utils.evaluation import evaluate_trajectory

G_W = np.array([0.0, 9.81, 0.0])  # camera y is down → gravity along +y in world
FPS = 20.0
IMU_HZ = 200


def pose_at(x, radius=0.8, forward=0.03, yaw_rate=0.003):
    """Continuous version of orbit_trajectory (x in frame units), with
    strong excitation (~3.2 m/s^2 peak): monocular-inertial scale is
    observable only through acceleration, and the estimator needs realistic
    excitation + >=2 s span before the first init (scripts/diag_init_op.py
    sweep: at 0.4 m/s^2 the scale MAP is noise-dominated and attenuates
    toward 0 — the reference would fare the same, its InertialOptimization
    has the same observability; at the round-2 1.5 m/s^2 the 3 s fixture
    sits on the observability knife edge and the recovered scale flips with
    sub-percent perturbations of the visual map)."""
    c = np.array([radius * np.sin(0.10 * x), 0.25 * np.sin(0.06 * x), forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def make_imu(n_frames):
    """Analytic IMU stream at IMU_HZ between frames at FPS."""
    dt = 1.0 / IMU_HZ
    n_steps = int(n_frames * IMU_HZ / FPS)
    xs = np.arange(n_steps + 1) * (FPS / IMU_HZ)  # frame-unit time
    poses = [pose_at(x) for x in xs]
    R_wb = np.stack([R.T for R, t in poses])          # body→world
    p = np.stack([-R.T @ t for R, t in poses])
    v = np.gradient(p, dt, axis=0)
    a_w = np.gradient(v, dt, axis=0)
    gyro = np.zeros((n_steps, 3))
    for i in range(n_steps):
        dRm = R_wb[i].T @ R_wb[i + 1]
        gyro[i] = np.asarray(lie.so3_log(jnp.asarray(dRm.astype(np.float32)))) / dt
    acc = np.einsum("nji,nj->ni", R_wb[:-1], a_w[:-1] - G_W[None])
    ts = (np.arange(n_steps) + 1) * dt
    return ts, gyro.astype(np.float32), acc.astype(np.float32)


def test_mono_inertial_recovers_metric_scale():
    # ≥2 s of travel: the init needs ≥0.25 s-spaced keyframe pairs for the
    # gravity/scale signal (reference waits 1-2 s before InitializeIMU too)
    n_frames = 64
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5)
    imu_ts, gyro, acc = make_imu(n_frames)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     enable_loop_closing=False)
    sys.enable_imu(freq=IMU_HZ)
    per = IMU_HZ // int(FPS)
    gt = []
    for i in range(n_frames):
        R, t = pose_at(i)
        img = scene.render(R, t)
        s0, s1 = (i - 1) * per, i * per
        if i == 0:
            s0 = 0; s1 = 0
        sys.track_monocular_inertial(
            img, ts=i / FPS, imu_ts=imu_ts[s0:s1], imu_gyro=gyro[s0:s1],
            imu_acc=acc[s0:s1])
        gt.append(-R.T @ t)
    assert sys.tracker.imu_initialized, sys.stats()
    # metric check: align WITHOUT scale — IMU must have recovered true scale
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    ate, n = evaluate_trajectory(np.arange(n_frames) / FPS, np.array(gt),
                                 ts[sel], t_wc[sel], with_scale=False)
    ate_s, _ = evaluate_trajectory(np.arange(n_frames) / FPS, np.array(gt),
                                   ts[sel], t_wc[sel], with_scale=True)
    # scale-free ATE must be close to the scale-aligned one (scale ≈ metric;
    # measured init scale within ~10-15% at this excitation/span —
    # scripts/diag_vi_init.py; VIBA1/2 would tighten it over a longer run).
    # The PRIMARY assertion is the scale-consistency ratio below; the
    # absolute bound is a sanity ceiling. This fixture has a genuinely hard
    # low-coverage midsection (inliers dip to ~40 at f17-19 regardless of
    # tracker version) and its ATE wobbles ±0.03 around 0.30 under any
    # change of LM tie-breaking; 0.35 keeps the gate meaningful without
    # pinning solver numerics.
    assert ate < 0.35, (ate, ate_s)
    assert ate < 4.0 * max(ate_s, 0.02), (ate, ate_s)


def test_bad_imu_reset_on_insufficient_motion():
    """Reference mbBadImu (src/LocalMapping.cc:164-172 + src/Tracking.cc:1805):
    within 10 s of IMU init and before VIBA2, near-zero travel across the last
    three keyframes resets the active map — under-excited inertial estimates
    must not be allowed to diverge."""
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     tracking_params=dense_tracking_params(),
                     enable_loop_closing=False)
    sys.enable_imu(freq=IMU_HZ)
    tr = sys.tracker
    m = sys.map
    n = sys.orb_cfg.total_capacity
    rng = np.random.default_rng(0)
    # three (nearly) stationary keyframes 0.3 s apart
    for i in range(3):
        m.add_keyframe(np.eye(3, dtype=np.float32),
                       np.asarray([1e-4 * i, 0, 0], np.float32),
                       ts=0.3 * i, frame_id=i * 6,
                       xy=rng.uniform(0, 100, (n, 2)).astype(np.float32),
                       angle=np.zeros(n, np.float32),
                       octave=np.zeros(n, np.int32),
                       desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
                       fvalid=np.ones(n, bool))
    tr.imu_initialized = True
    tr.imu_init_ts = 0.0
    tr.viba2_done = False
    mapper = sys.mapper
    mapper._inertial_stage(2)
    assert mapper.stats.get("bad_imu_resets", 0) == 1
    assert sys.map is not m                 # active map was reset
    assert sys.map.n_kf == 0
    assert not sys.tracker.imu_initialized
