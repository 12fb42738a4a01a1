"""Diagnose why try_imu_init fails on the mono-inertial E2E fixture."""
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.ops import lie
from orbslam3_jax.utils.datasets import RoomScene

G_W = np.array([0.0, 9.81, 0.0])
FPS = 20.0
IMU_HZ = 200


SPEED = float(__import__("os").environ.get("SPEED", 1.0))


def pose_at(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    c = np.array([radius * np.sin(SPEED * 0.04 * x),
                  0.15 * np.sin(SPEED * 0.02 * x), forward * x])
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


def main(n_frames=None):
    import os
    if n_frames is None:
        n_frames = int(os.environ.get("NFRAMES", 40))
    stereo = bool(os.environ.get("STEREO"))
    BASELINE = 0.11
    scene = RoomScene(seed=2 if stereo else 4, depth=6.0, half_w=4.0, half_h=2.5)
    imu_ts, gyro, acc = make_imu(n_frames)
    kw = dict(bf=BASELINE * scene.fx, th_depth=BASELINE * 40) if stereo else {}
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     enable_loop_closing=False, **kw)
    sys.enable_imu(freq=IMU_HZ)
    tr = sys.tracker

    orig = tr.try_imu_init

    def instrumented(min_kfs=8, **kw):
        m = tr.map
        kfs = [int(k) for k in m.valid_kf_ids()]
        chain0 = [k for k in kfs if k in tr.kf_preints or k == kfs[0]]
        contig = [True] * len(chain0)
        for i in range(1, len(chain0)):
            dt_kf = float(m.kf_ts[chain0[i]] - m.kf_ts[chain0[i - 1]])
            contig[i] = abs(float(tr.kf_preints[chain0[i]].dT) - dt_kf) < 0.015
        ok = orig(min_kfs=min_kfs, **kw)
        print(f"  try_imu_init(kw={kw}): nkf={len(kfs)} chain0={len(chain0)} "
              f"contig={sum(contig)}/{len(contig)} -> {ok}")
        return ok

    tr.try_imu_init = instrumented
    per = IMU_HZ // int(FPS)
    for i in range(n_frames):
        R, t = pose_at(i)
        img = scene.render(R, t)
        s0, s1 = (i - 1) * per, i * per
        if i == 0:
            s0 = 0; s1 = 0
        if stereo:
            Rr, tr_r = scene.stereo_pose(R, t, BASELINE)
            img_r = scene.render(Rr, tr_r)
            sys.track_stereo_inertial(img, img_r, ts=i / FPS,
                                      imu_ts=imu_ts[s0:s1],
                                      imu_gyro=gyro[s0:s1], imu_acc=acc[s0:s1])
        else:
            sys.track_monocular_inertial(
                img, ts=i / FPS, imu_ts=imu_ts[s0:s1], imu_gyro=gyro[s0:s1],
                imu_acc=acc[s0:s1])
        if i % 5 == 0 or i == n_frames - 1:
            # Horn scale of KF centers vs GT (1.0 = metric)
            m = sys.map
            kfids = m.valid_kf_ids()
            est, gtc = [], []
            for k in kfids:
                fi = int(m.kf_frame_id[k])
                if fi <= i:
                    est.append(-m.kf_R[k].T @ m.kf_t[k])
                    Rg, tg = pose_at(fi)
                    gtc.append(-Rg.T @ tg)
            s = np.nan
            if len(est) >= 3:
                E = np.array(est) - np.mean(est, 0)
                G = np.array(gtc) - np.mean(gtc, 0)
                W = G.T @ E
                U, S, Vt = np.linalg.svd(W)
                D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
                s = (S * np.diag(D)).sum() / max((E * E).sum(), 1e-12)
            print(f"frame {i}: state={sys.state.name} nKF={len(kfids)} "
                  f"imu_init={tr.imu_initialized} horn_s={s:.4f}")
    print("stats:", sys.stats())


if __name__ == "__main__":
    main()
