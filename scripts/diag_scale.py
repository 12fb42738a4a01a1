"""Diagnose mono scale consistency on the inertial-test fixture (vision only).

For each tracked frame, compare estimated inter-frame translation magnitude to
ground truth: scale_i = |dt_est| / |dt_gt|. A consistent mono map has a single
constant scale; drift here is what breaks inertial initialization.
"""
import numpy as np
import jax.numpy as jnp

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.utils.datasets import RoomScene
from orbslam3_jax.utils.evaluation import evaluate_trajectory

FPS = 20.0


def pose_at(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x), forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def main(n_frames=40):
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     enable_loop_closing=False)
    gt = []
    for i in range(n_frames):
        R, t = pose_at(i)
        img = scene.render(R, t)
        sys.track_monocular(img, ts=i / FPS)
        gt.append(-R.T @ t)
    gt = np.array(gt)
    ts, R_wc, t_wc, lost = sys.export_trajectory()
    sel = ~lost
    print("tracked:", sel.sum(), "/", n_frames, " state:", sys.tracker.state)
    est = t_wc
    fid = np.round(ts * FPS).astype(int)
    # per-frame-pair scale
    print(" i->j   |dt_est|   |dt_gt|   scale")
    scales = []
    prev = None
    for k in range(len(fid)):
        if lost[k]:
            prev = None
            continue
        if prev is not None:
            i, j = fid[prev], fid[k]
            de = np.linalg.norm(est[k] - est[prev])
            dg = np.linalg.norm(gt[j] - gt[i])
            if dg > 1e-6:
                s = de / dg
                scales.append((j, s))
                if k % 2 == 0 or s < 0.5 * np.median([x[1] for x in scales]) or \
                   s > 2 * np.median([x[1] for x in scales]):
                    print(f"{i:3d}->{j:3d}  {de:8.4f}  {dg:8.4f}  {s:8.3f}")
        prev = k
    sarr = np.array([s for _, s in scales])
    print(f"scale: median={np.median(sarr):.3f} min={sarr.min():.3f} "
          f"max={sarr.max():.3f} ratio={sarr.max()/max(sarr.min(),1e-9):.2f}")
    ate_s, n = evaluate_trajectory(np.arange(n_frames) / FPS, gt, ts[sel],
                                   est[sel], with_scale=True)
    ate, _ = evaluate_trajectory(np.arange(n_frames) / FPS, gt, ts[sel],
                                 est[sel], with_scale=False)
    print(f"ATE(scale-aligned)={ate_s:.4f}  ATE(rigid)={ate:.4f}  n={n}")
    print(sys.stats())


if __name__ == "__main__":
    main()
