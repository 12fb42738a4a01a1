"""Monocular fisheye (Kannala-Brandt-8) end-to-end tracking.

The reference's headline TUM-VI capability (reference
src/CameraModels/KannalaBrandt8.cpp, Examples/Monocular/TUM_512.yaml:
512x512 fisheye). The room fixture renders through the KB8 model; the full
tracking pipeline runs with cam_type=1 (projection/unprojection/Jacobians
dispatch through the fisheye model everywhere).
"""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory

# TUM-VI-like fisheye intrinsics on a 512x512 sensor
KB8 = np.asarray([190.978, 190.973, 256.0, 256.0,
                  0.00348, 0.000715, -0.00205, 0.000202], np.float32)
N_FRAMES = 24


def test_fisheye_two_camera_stereo_tracks_metric():
    """Two-camera KB8 stereo with lapping areas (reference Frame.cc:1440
    ComputeStereoFishEyeMatches + KannalaBrandt8::TriangulateMatches): the
    rig baseline makes the map metric — ATE is asserted WITHOUT scale
    alignment."""
    import jax.numpy as jnp
    from orbslam3_jax.ops import lie as lie_ops
    scene = RoomScene(seed=8, depth=6.0, half_w=4.0, half_h=2.5,
                      h=512, w=512, fx=190.978, fy=190.973, cx=256.0, cy=256.0)
    scene.kb8_params = KB8
    baseline = 0.101
    R_rl = np.asarray(lie_ops.so3_exp(jnp.asarray([0.0, 0.008, 0.0],
                                                  jnp.float32)))
    t_rl = np.array([-baseline, 0.0, 0.0], np.float32)  # x_r = R x_l + t
    poses = orbit_trajectory(N_FRAMES, radius=0.5, forward=0.03)
    sys = SlamSystem(KB8, None, (512, 512), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     cam_type=1, enable_loop_closing=False)
    sys.set_fisheye_rig(KB8, R_rl, t_rl, lap_l=(0.0, 511.0), lap_r=(0.0, 511.0))
    gt, states = [], []
    for i, (R, t) in enumerate(poses):
        img_l = scene.render(R, t)
        # right camera pose: T_r = T_rl ∘ T_l
        R_r = R_rl @ R
        t_r = R_rl @ t + t_rl
        img_r = scene.render(R_r, t_r)
        sys.track_stereo_fisheye(img_l, img_r, ts=i / 20.0)
        gt.append(-R.T @ t)
        states.append(sys.state)
    assert sys.state == TrackState.OK, [s.name for s in states]
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    ate, n = evaluate_trajectory(np.arange(N_FRAMES) / 20.0, np.array(gt),
                                 ts[sel], t_wc[sel], with_scale=False)
    ate_s, _ = evaluate_trajectory(np.arange(N_FRAMES) / 20.0, np.array(gt),
                                   ts[sel], t_wc[sel], with_scale=True)
    assert n > 0.6 * N_FRAMES
    # metric (no scale alignment) bound — round-1 accuracy envelope; the
    # ToBody residuals keep metric scale near truth (scale-free ≈ scaled)
    assert ate < 0.6, (ate, ate_s)
    assert ate < 3.5 * max(ate_s, 0.05), (ate, ate_s)


def test_mono_fisheye_tracks():
    scene = RoomScene(seed=6, depth=6.0, half_w=4.0, half_h=2.5,
                      h=512, w=512, fx=190.978, fy=190.973, cx=256.0, cy=256.0)
    scene.kb8_params = KB8
    poses = orbit_trajectory(N_FRAMES, radius=0.6, forward=0.03)
    sys = SlamSystem(KB8, None, (512, 512), n_features=512, seed=0, tracking_params=dense_tracking_params(),
                     cam_type=1, enable_loop_closing=False)
    gt = []
    states = []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        sys.track_monocular(img, ts=i / 20.0)
        gt.append(-R.T @ t)
        states.append(sys.state)
    assert sys.state == TrackState.OK, [s.name for s in states]
    non_ok = sum(s != TrackState.OK for s in states[12:])
    assert non_ok <= 3, [s.name for s in states]
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    ate, n = evaluate_trajectory(np.arange(N_FRAMES) / 20.0, np.array(gt),
                                 ts[sel], t_wc[sel], with_scale=True)
    assert n > 0.6 * N_FRAMES
    assert ate < 0.5, ate
