"""Multi-seed evaluation harness for tracking-quality experiments.

Runs the 40-frame RoomScene monocular fixture across seeds and reports
per-KF max/rms error (GT-aligned, Horn+scale) per configuration. Used to
evaluate accuracy changes without single-run chaos.
"""
import os
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np

import sys as _s
_s.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.utils.datasets import RoomScene


def pose_at(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x), forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def run_one(seed, n_frames=40, configure=None):
    scene = RoomScene(seed=seed, depth=6.0, half_w=4.0, half_h=2.5)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                     seed=0, enable_loop_closing=False)
    if configure:
        configure(sys)
    for i in range(n_frames):
        R, t = pose_at(i)
        sys.track_monocular(scene.render(R, t), ts=i / 20.0)
    m = sys.map
    kfs = [int(k) for k in m.valid_kf_ids()]
    if len(kfs) < 3:
        return None
    ctr = -np.einsum("kij,ki->kj", m.kf_R[kfs].transpose(0, 2, 1), m.kf_t[kfs])
    gtc = np.array([-pose_at(int(m.kf_frame_id[k]))[0].T
                    @ pose_at(int(m.kf_frame_id[k]))[1] for k in kfs])
    X, Y = ctr - ctr.mean(0), gtc - gtc.mean(0)
    s = np.sqrt((Y ** 2).sum() / (X ** 2).sum())
    U, S, Vt = np.linalg.svd(Y.T @ X)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    err = np.linalg.norm((s * ((U @ D @ Vt) @ X.T).T) - Y, axis=1)
    return {"max": err.max(), "rms": float(np.sqrt((err ** 2).mean())),
            "n_kf": len(kfs)}


def sweep(configs, seeds=(1, 2, 4, 7)):
    for name, configure in configs.items():
        outs = []
        for sd in seeds:
            r = run_one(sd, configure=configure)
            outs.append(r)
        ok = [r for r in outs if r]
        if not ok:
            print(f"{name}: ALL FAILED")
            continue
        print(f"{name}: max {[round(r['max'],3) for r in ok]} "
              f"rms {[round(r['rms'],3) for r in ok]} "
              f"mean-rms {np.mean([r['rms'] for r in ok]):.4f}")


if __name__ == "__main__":
    sweep({"baseline": None})
