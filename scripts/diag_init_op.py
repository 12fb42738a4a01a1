"""Isolated probe of ops.imu_init.inertial_init on the E2E fixture's motion:
'visual' KF poses = GT scaled by 1/s_true (+ optional noise), preintegrations
= exact analytic IMU between them. True recovery: scale == s_true, gravity
aligned. Sweep KF spacing / span / noise from env."""
import os
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from orbslam3_jax.ops import imu as imu_ops, imu_init as ii, lie

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


def main():
    n_frames = int(os.environ.get("NFRAMES", 24))
    kf_every = int(os.environ.get("KF_EVERY", 1))       # frames between KFs
    s_true = float(os.environ.get("S_TRUE", 5.85))      # visual = GT / s_true
    pos_noise = float(os.environ.get("POS_NOISE", 0.0)) # visual noise (GT units)
    iters = int(os.environ.get("ITERS", 40))
    rng = np.random.default_rng(0)
    imu_ts, gyro, acc = make_imu(n_frames)
    per = IMU_HZ // int(FPS)

    kf_frames = list(range(0, n_frames, kf_every))
    # visual body poses: R_wb exact, p scaled down by s_true (+noise)
    R_wb, p_wb = [], []
    for fi in kf_frames:
        R, t = pose_at(fi)
        R_wb.append(R.T)
        p_wb.append((-R.T @ t) / s_true
                    + rng.normal(0, pos_noise / s_true, 3))
    R_wb = np.stack(R_wb).astype(np.float32)
    p_wb = np.stack(p_wb).astype(np.float32)

    # exact preintegration between consecutive KFs
    pre = []
    for a, b in zip(kf_frames[:-1], kf_frames[1:]):
        sl = slice(a * per, b * per)
        nsl = b * per - a * per
        st = imu_ops.preintegrate(
            jnp.asarray(acc[sl]), jnp.asarray(gyro[sl]),
            jnp.full(nsl, 1.0 / IMU_HZ, jnp.float32),
            jnp.ones(nsl, bool),
            jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
            1.7e-4, 2e-3, 1e-5, 1e-4, float(IMU_HZ))
        pre.append(st)
    stack = lambda attr: jnp.asarray(np.stack([np.asarray(getattr(s, attr)) for s in pre]))
    cov = jnp.asarray(np.stack([np.asarray(s.C)[:9, :9] for s in pre]))
    res = ii.inertial_init(
        jnp.asarray(R_wb), jnp.asarray(p_wb),
        stack("dT"), stack("dR"), stack("dV"), stack("dP"),
        stack("JRg"), stack("JVg"), stack("JVa"), stack("JPg"), stack("JPa"),
        jnp.ones(len(pre), bool), cov=cov, opt_scale=True, iters=iters,
        prior_g=1e2, prior_a=1e10)
    g_new = np.asarray(res.Rwg) @ np.array([0, 0, -9.81])
    print(f"KFs={len(kf_frames)} span={kf_frames[-1]/FPS:.2f}s "
          f"kf_dt={kf_every/FPS:.3f}s noise={pos_noise}")
    print(f"scale: got {float(res.scale):.4f}  want {s_true:.4f} "
          f"(err {float(res.scale)/s_true - 1:+.1%})")
    print(f"gravity(old world): got {np.asarray(g_new).round(3)} want {G_W}")
    print(f"bg={np.asarray(res.bg).round(5)} ba={np.asarray(res.ba).round(5)} "
          f"cost={float(res.cost):.3e}")


if __name__ == "__main__":
    main()
