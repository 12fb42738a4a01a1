"""Stereo-inertial end-to-end (reference IMU_STEREO): stereo gives metric
scale from frame one; the IMU init must refine gravity/biases WITHOUT
breaking that scale (fixed-scale inertial MAP, reference InitializeIMU with
the 1e5 acc prior for stereo, src/LocalMapping.cc:213-221)."""
import numpy as np

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.utils.datasets import RoomScene, synthetic_imu
from orbslam3_jax.utils.evaluation import evaluate_trajectory

G_W = np.array([0.0, 9.81, 0.0])
FPS = 20.0
IMU_HZ = 200
BASELINE = 0.11


def pose_at(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x), forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def test_stereo_inertial_metric_ate():
    n_frames = 36
    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5)
    imu_ts, gyro, acc = synthetic_imu(pose_at, n_frames, FPS, IMU_HZ, G_W)
    bf = BASELINE * scene.fx
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     bf=bf, th_depth=BASELINE * 40, enable_loop_closing=False)
    sys.enable_imu(freq=IMU_HZ)
    per = IMU_HZ // int(FPS)
    gt = []
    for i in range(n_frames):
        R, t = pose_at(i)
        img_l = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, BASELINE)
        img_r = scene.render(Rr, tr)
        s0, s1 = (i - 1) * per, i * per
        if i == 0:
            s0 = s1 = 0
        sys.track_stereo_inertial(img_l, img_r, ts=i / FPS,
                                  imu_ts=imu_ts[s0:s1], imu_gyro=gyro[s0:s1],
                                  imu_acc=acc[s0:s1])
        gt.append(-R.T @ t)
    assert sys.tracker.imu_initialized, sys.stats()
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    # metric (no scale gauge): the IMU init must preserve stereo's scale.
    # With IMU the gravity gauge is also fixed — but the synthetic world's
    # yaw/origin is not, so standard rigid alignment is still applied.
    ate, n = evaluate_trajectory(np.arange(n_frames) / FPS, np.array(gt),
                                 ts[sel], t_wc[sel], with_scale=False)
    ate_s, _ = evaluate_trajectory(np.arange(n_frames) / FPS, np.array(gt),
                                   ts[sel], t_wc[sel], with_scale=True)
    assert n > 0.7 * n_frames
    assert ate < 0.1, (ate, ate_s)
    # scale must stay within a few percent of metric
    assert ate < 2.0 * max(ate_s, 0.02), (ate, ate_s)
