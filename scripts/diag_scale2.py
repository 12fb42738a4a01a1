"""Per-frame map-scale tracking: after each frame, Horn-align the current
keyframe centers to their GT positions and log the fitted scale + events."""
import numpy as np

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.utils.datasets import RoomScene

FPS = 20.0


def pose_at(x, radius=0.6, forward=0.03, yaw_rate=0.003):
    c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x), forward * x])
    yaw = yaw_rate * x
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return R_wc.T, -R_wc.T @ c


def horn_scale(est, gt):
    """Fit gt ≈ s*R*est + t, return s (and residual rms)."""
    if len(est) < 3:
        return np.nan, np.nan
    me, mg = est.mean(0), gt.mean(0)
    E, G = est - me, gt - mg
    W = G.T @ E
    U, S, Vt = np.linalg.svd(W)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / max((E * E).sum(), 1e-12)
    res = G - s * (E @ R.T)
    return s, np.sqrt((res ** 2).mean())


def main(n_frames=int(__import__('os').environ.get('NFRAMES','40'))):
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5, n_clutter=int(__import__("os").environ.get("CLUTTER","0")))
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     enable_loop_closing=False)
    import os
    if os.environ.get("CVMINPX"):
        sys.tracker.p.cv_predict_min_px = float(os.environ["CVMINPX"])
    if os.environ.get("NO_ROT_EXTRAP"):
        t_ = sys.tracker
        def pp2(frame):
            lf = t_.last_frame
            Rv, tv = t_.velocity
            Rp = (Rv @ lf.R).astype(np.float32)
            tp = (Rv @ lf.t + tv).astype(np.float32)
            c_p = -Rp.T @ tp; c_l = -lf.R.T @ lf.t
            zmed = t_._last_matched_depth()
            px = float(t_.K[0]) * float(np.linalg.norm(c_p - c_l)) / max(zmed, 1e-6)
            if px < 4.0:
                frame.R = lf.R.copy(); frame.t = lf.t.copy()
            else:
                frame.R = Rp; frame.t = tp
        t_._predict_pose = pp2
    if os.environ.get("SEED_LAST"):
        t_ = sys.tracker
        orig_opt = t_._optimize_frame_pose
        seen = set()
        def opt(frame, in_map=None):
            lf = t_.last_frame
            if (id(frame) not in seen and lf is not None and lf.tracked
                    and lf.R is not None and frame is not lf):
                frame.R = lf.R.copy(); frame.t = lf.t.copy()
            seen.add(id(frame))
            return orig_opt(frame, in_map)
        t_._optimize_frame_pose = opt
    if os.environ.get("NO_CV"):
        def pp(frame):
            frame.R = t_.last_frame.R.copy(); frame.t = t_.last_frame.t.copy()
        t_ = sys.tracker
        t_._predict_pose = pp
    if os.environ.get("NO_KF_CULL"):
        sys.mapper.cull_keyframes = lambda *a, **k: None
    gt_all = {}
    prev_stats = {}
    print("frm  nKF  nMP   map_scale  align_rms  frame_err  events")
    for i in range(n_frames):
        R, t = pose_at(i)
        gt_all[i] = -R.T @ t
        img = scene.render(R, t)
        out = sys.track_monocular(img, ts=i / FPS)
        m = sys.map
        kfids = m.valid_kf_ids()
        est, gt = [], []
        for k in kfids:
            c = -m.kf_R[k].T @ m.kf_t[k]
            fi = int(m.kf_frame_id[k])
            if fi in gt_all:
                est.append(c); gt.append(gt_all[fi])
        s, rms = horn_scale(np.array(est), np.array(gt))
        st = dict(sys.tracker.stats) if hasattr(sys.tracker, 'stats') else {}
        ms = sys.mapper.stats
        ev = []
        for key in ("triangulated", "culled_mp", "ba_runs", "culled_kf"):
            d = ms.get(key, 0) - prev_stats.get(key, 0)
            if d:
                ev.append(f"{key}+{d}")
            prev_stats[key] = ms.get(key, 0)
        # current frame error after scale-align of the traj so far
        fr = sys.tracker.last_frame
        ferr = np.nan
        if fr is not None and not np.isnan(s):
            c = -fr.R.T @ fr.t
            # apply same alignment
            est_a = np.array(est); gt_a = np.array(gt)
            me, mg = est_a.mean(0), gt_a.mean(0)
            E, G = est_a - me, gt_a - mg
            W = G.T @ E
            U, S_, Vt = np.linalg.svd(W)
            D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
            Rh = U @ D @ Vt
            ferr = np.linalg.norm(s * Rh @ (c - me) + mg - gt_all[i])
        print(f"{i:3d}  {len(kfids):3d}  {m.n_mp_valid() if hasattr(m,'n_mp_valid') else (m.mp_valid.sum()):4d}"
              f"   {s:8.4f}  {rms:8.4f}   {ferr:8.4f}  {','.join(ev)}  {out.get('state','')}")


if __name__ == "__main__":
    main()
