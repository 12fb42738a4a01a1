"""Decompose per-frame drift: relative rotation error (deg), translation
direction error (deg), magnitude ratio est/gt, for frames 10-30."""
import numpy as np

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.utils.datasets import RoomScene

FPS = 20.0
SCALE = 5.83  # est->gt scale from the stable window


def pose_at(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x), forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def main(n_frames=32):
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     enable_loop_closing=False)
    t = sys.tracker
    poses = {}
    gts = {}
    print("frm  rot_err_deg  dir_err_deg  mag_ratio")
    for i in range(n_frames):
        R, tt = pose_at(i)
        gts[i] = (R, tt)
        img = scene.render(R, tt)
        sys.track_monocular(img, ts=i / FPS)
        fr = t.last_frame
        if fr is None or fr.R is None or not fr.tracked:
            continue
        poses[i] = (fr.R.copy(), fr.t.copy())
        if i - 1 not in poses:
            continue
        # relative motion cam_{i} <- cam_{i-1}
        R0e, t0e = poses[i - 1]
        R1e, t1e = poses[i]
        Rrel_e = R1e @ R0e.T
        trel_e = t1e - Rrel_e @ t0e
        R0g, t0g = gts[i - 1]
        R1g, t1g = gts[i]
        Rrel_g = R1g @ R0g.T
        trel_g = t1g - Rrel_g @ t0g
        dR = Rrel_e @ Rrel_g.T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        ne, ng = np.linalg.norm(trel_e), np.linalg.norm(trel_g)
        dir_err = np.degrees(np.arccos(np.clip(
            trel_e @ trel_g / max(ne * ng, 1e-12), -1, 1)))
        mag = ne / max(ng / SCALE, 1e-12)
        print(f"{i:3d}   {ang:9.4f}   {dir_err:9.2f}   {mag:7.3f}")


if __name__ == "__main__":
    import sys as _s
    main()
