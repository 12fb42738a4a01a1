"""Frame-by-frame tracking introspection on the failure window (frames 15-26).

Logs pose error vs GT after the motion-model stage and after local-map
optimization, plus match/inlier counts and the KF-policy inputs.
"""
import numpy as np

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models import tracking as trk
from orbslam3_jax.utils.datasets import RoomScene

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
    t = sys.tracker

    # --- instrumentation ------------------------------------------------
    state = {"i": 0, "gt_c": None, "scale": 5.83}
    orig_mm = t._track_motion_model
    orig_lm = t._track_local_map
    orig_need = t._need_new_keyframe

    def err(frame):
        if frame.R is None:
            return np.nan
        c = -frame.R.T @ frame.t
        # compare in est units: scale gt displacement into map units is hard;
        # instead report est-frame displacement from GT-scaled prediction later.
        return c

    def mm(frame):
        ok = orig_mm(frame)
        state["mm_pose"] = err(frame)
        state["mm_ok"] = ok
        state["mm_inl"] = getattr(t, "n_local_inliers", -1)
        return ok

    def lm(frame):
        ok = orig_lm(frame)
        state["lm_pose"] = err(frame)
        state["lm_ok"] = ok
        state["lm_inl"] = t.n_local_inliers
        state["n_matched"] = frame.n_matched()
        return ok

    def need(frame):
        m = t.map
        ref_mps = m.kf_feat_mp[t.ref_kf]
        ref_mps = ref_mps[ref_mps >= 0]
        ref_mps = ref_mps[m.mp_valid[ref_mps]]
        min_obs = 3 if m.n_kf > 2 else 2
        if len(ref_mps):
            ref_mps = ref_mps[m.obs_count(ref_mps) >= min_obs]
        state["n_ref"] = len(ref_mps)
        r = orig_need(frame)
        state["kf"] = r
        return r

    t._track_motion_model = mm
    t._track_local_map = lm
    t._need_new_keyframe = need

    est_c = {}
    gt_c = {}
    print("frm  mm_err_mm  lm_err_mm  lm_inl  n_match  n_ref  ratio   kf")
    for i in range(n_frames):
        R, tt = pose_at(i)
        gt_c[i] = -R.T @ tt
        img = scene.render(R, tt)
        state.update(mm_pose=None, lm_pose=None, lm_inl=-1, n_matched=-1,
                     n_ref=-1, kf=False, mm_ok=False, lm_ok=False)
        sys.track_monocular(img, ts=i / FPS)
        fr = t.last_frame
        if fr is not None and fr.R is not None:
            est_c[i] = -fr.R.T @ fr.t
        # per-frame displacement error in map units: compare est displacement
        # to GT displacement scaled by current map scale estimate
        if i - 1 in est_c and i in est_c and i >= 9:
            d_est = est_c[i] - est_c[i - 1]
            d_gt = gt_c[i] - gt_c[i - 1]
            # fit scale from early stable window once
            def perr(p):
                if p is None:
                    return np.nan
                return np.linalg.norm((p - est_c[i - 1]) - d_gt / state["scale"]) * 1000
            mm_e = perr(state["mm_pose"])
            lm_e = perr(state["lm_pose"])
            nr = state["n_ref"]
            nm = state["n_matched"]
            print(f"{i:3d}  {mm_e:8.2f}  {lm_e:8.2f}  {state['lm_inl']:5d}  "
                  f"{nm:6d}  {nr:5d}  {nm/max(nr,1):5.2f}  {state['kf']}")


if __name__ == "__main__":
    main()
