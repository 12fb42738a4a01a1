"""Per-frame error on the stereo-inertial E2E fixture, with ablations:
NO_VIBA=1 disables LocalInertialBA, NO_VIOPT=1 disables the per-frame VI pose
optimizer, NO_INIT=1 blocks IMU init entirely (pure stereo baseline)."""
import os
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.ops import lie
from orbslam3_jax.utils.datasets import RoomScene
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


def make_imu(n_frames):
    dt = 1.0 / IMU_HZ
    n_steps = int(n_frames * IMU_HZ / FPS)
    xs = np.arange(n_steps + 1) * (FPS / IMU_HZ)
    poses = [pose_at(x) for x in xs]
    R_wb = np.stack([R.T for R, t in poses])
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


def main(n_frames=36):
    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5)
    imu_ts, gyro, acc = make_imu(n_frames)
    bf = BASELINE * scene.fx
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     bf=bf, th_depth=BASELINE * 40, enable_loop_closing=False)
    sys.enable_imu(freq=IMU_HZ)
    tr = sys.tracker
    if os.environ.get("NO_INIT"):
        tr.try_imu_init = lambda *a, **k: False
    if os.environ.get("NO_VIBA"):
        sys.mapper.local_inertial_ba = lambda *a, **k: None
    if os.environ.get("NO_VIOPT"):
        tr._optimize_frame_pose_vi = lambda *a, **k: -1
    per = IMU_HZ // int(FPS)
    gt, est, lost = [], [], []
    for i in range(n_frames):
        R, t = pose_at(i)
        img_l = scene.render(R, t)
        Rr, tr_r = scene.stereo_pose(R, t, BASELINE)
        img_r = scene.render(Rr, tr_r)
        s0, s1 = (i - 1) * per, i * per
        if i == 0:
            s0 = s1 = 0
        if i == 22 and os.environ.get("INSTR"):
            instrument(tr)
        out = sys.track_stereo_inertial(img_l, img_r, ts=i / FPS,
                                        imu_ts=imu_ts[s0:s1],
                                        imu_gyro=gyro[s0:s1], imu_acc=acc[s0:s1])
        gt.append(-R.T @ t)
        f = tr.last_frame
        c = (-f.R.T @ f.t) if f is not None and f.R is not None else np.full(3, np.nan)
        est.append(c)
        # raw (unaligned) per-frame error — stereo is metric and starts at GT
        e = np.linalg.norm(c - gt[-1])
        print(f"{i:3d} err={e:7.4f} state={out.get('state','')} "
              f"init={tr.imu_initialized} nKF={len(sys.map.valid_kf_ids())}")
    ts_, R_wc, t_wc, lost_ = sys.export_trajectory()
    sel = ~lost_
    ate, n = evaluate_trajectory(np.arange(n_frames) / FPS, np.array(gt),
                                 ts_[sel], t_wc[sel], with_scale=False)
    print(f"final ATE (rigid): {ate:.4f} over {n}")




def instrument(tr):
    """Print stage outcomes around the IMU-init transition."""
    import functools
    for name in ("_predict_pose_imu", "_track_with_prediction",
                 "_track_motion_model", "_track_reference_kf",
                 "_track_local_map", "_optimize_frame_pose_vi",
                 "_optimize_frame_pose", "_relocalize"):
        orig = getattr(tr, name)

        def wrap(orig=orig, name=name):
            @functools.wraps(orig)
            def f(*a, **k):
                out = orig(*a, **k)
                print(f"      {name} -> {out if not hasattr(out,'shape') else out}")
                return out
            return f
        setattr(tr, name, wrap())


if __name__ == "__main__":
    main()
