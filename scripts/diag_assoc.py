"""Association audit: during the drift window, evaluate each frame's matched
(map point, feature) pairs under the GT pose mapped into map coordinates.

If associations are correct, residuals under the GT-aligned pose stay small;
if matching slid to neighboring features, they show a coherent offset.
"""
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


def horn(est, gt, R_est_cw, R_gt_cw):
    """Fit est ≈ s·Ra·gt + t using KF ORIENTATIONS for Ra (centers alone
    leave roll about a near-planar trajectory unconstrained)."""
    # each KF: R_est_cw ≈ R_gt_cw @ Ra.T  →  Ra_i = R_est.T @ R_gt
    M = sum(Re.T @ Rg for Re, Rg in zip(R_est_cw, R_gt_cw))
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    Ra = U @ D @ Vt
    me, mg = est.mean(0), gt.mean(0)
    E, G = est - me, gt - mg
    RG = G @ Ra.T
    s = (E * RG).sum() / max((RG * RG).sum(), 1e-12)
    t = me - s * Ra @ mg
    return s, Ra, t


def main(n_frames=26):
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5)
    sys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                     enable_loop_closing=False)
    t = sys.tracker
    K = scene.K
    gts = {}
    align = None
    print("frm  nmatch  med_est_px  med_gt_px  frac_gt_inl  mean_off_gt(px)")
    for i in range(n_frames):
        R, tt = pose_at(i)
        gts[i] = (R, tt)
        img = scene.render(R, tt)
        sys.track_monocular(img, ts=i / FPS)
        fr = t.last_frame
        m = sys.map
        if fr is None or not fr.tracked or i < 10:
            continue
        if align is None and i == 14:
            # fit map<-world alignment from KF centers in the stable window
            kfids = m.valid_kf_ids()
            est, gt, Res, Rgs = [], [], [], []
            for k in kfids:
                fi = int(m.kf_frame_id[k])
                if fi in gts:
                    est.append(-m.kf_R[k].T @ m.kf_t[k])
                    Rg, tg = gts[fi]
                    gt.append(-Rg.T @ tg)
                    Res.append(m.kf_R[k].copy())
                    Rgs.append(Rg)
            align = horn(np.array(est), np.array(gt), Res, Rgs)
        if align is None:
            continue
        s, Ra, ta = align
        # GT pose in map coords: x_map = s*Ra*x_w + ta
        # cam <- world:  xc = Rg xw + tg  →  cam <- map: xc' scaled
        Rg, tg = gts[i]
        # x_w = Ra.T (x_map - ta)/s ; xc = Rg x_w + tg (GT units)
        # pixel projection is scale-invariant per similarity: use
        # R_cm = Rg Ra.T, t_cm = s*tg - R_cm ta  (map units, depth scaled)
        R_cm = Rg @ Ra.T
        t_cm = s * tg - R_cm @ ta
        sel = fr.feat_mp >= 0
        mp = fr.feat_mp[sel]
        uv = fr.xy[sel]
        P = m.mp_xyz[mp]
        def proj(Rm, tm):
            xc = P @ Rm.T + tm
            z = np.maximum(xc[:, 2], 1e-6)
            return np.stack([K[0] * xc[:, 0] / z + K[2],
                             K[1] * xc[:, 1] / z + K[3]], -1)
        r_est = np.linalg.norm(proj(fr.R, fr.t) - uv, axis=1)
        d_gt = proj(R_cm, t_cm) - uv
        r_gt = np.linalg.norm(d_gt, axis=1)
        # pose gap between the two sub-pixel-fitting poses
        c_est = -fr.R.T @ fr.t
        c_gtm = -R_cm.T @ t_cm
        dc = np.linalg.norm(c_est - c_gtm)
        dRm = fr.R @ R_cm.T
        dang = np.degrees(np.arccos(np.clip((np.trace(dRm.astype(np.float64)) - 1) / 2, -1, 1)))
        # angular spread of matched points in the est camera
        xc = P @ fr.R.T + fr.t
        xz = np.abs(xc[:, 0] / xc[:, 2])
        yz = np.abs(xc[:, 1] / xc[:, 2])
        zmed = np.median(xc[:, 2])
        dp = np.linalg.norm(proj(fr.R, fr.t) - proj(R_cm, t_cm), axis=1)
        # rotation angle via skew part (robust for small angles)
        sk = np.array([dRm[2,1]-dRm[1,2], dRm[0,2]-dRm[2,0], dRm[1,0]-dRm[0,1]], np.float64)/2
        dang2 = np.degrees(np.arcsin(np.clip(np.linalg.norm(sk),-1,1)))
        # artificial pure-translation displacement of est camera by (c_gtm-c_est)
        dvec = (c_gtm + 0.0) - c_est
        t_shift = -fr.R @ (c_est + dvec)
        dp_shift = np.linalg.norm(proj(fr.R, fr.t) - proj(fr.R, t_shift), axis=1)
        print(f"   dang2={dang2:.4f} deg   dproj_pure_translation med={np.median(dp_shift):.2f} p90={np.percentile(dp_shift,90):.2f}  dvec_cam={fr.R@dvec}")
        print(f"dproj med={np.median(dp):.2f} p90={np.percentile(dp,90):.2f} max={dp.max():.2f}")
        print(f"{i:3d}  {sel.sum():5d}   {np.median(r_est):6.2f}  "
              f"{np.median(r_gt):6.2f}   {(r_gt<2.45).mean():5.2f}  "
              f"dc={dc:7.4f} dang={dang:6.3f}  |x/z|med={np.median(xz):.2f} "
              f"|y/z|med={np.median(yz):.2f} zmed={zmed:.2f}")


if __name__ == "__main__":
    main()
