"""Instrumented reproduction of the bench 120-frame orbit accuracy collapse.

Prints map size / ATE-so-far / tracker state every 10 frames, plus cull
counters, to localize where the map degenerates (VERDICT r3 Weak #2).
Run: JAX_PLATFORMS=cpu python scripts/debug_bench_accuracy.py [n_frames]
"""
import os
import sys
import time

import numpy as np

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackingParams
from orbslam3_jax.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory


def main(n_frames=120, pipeline=True, kf_int=None, redundancy=0.9):
    if kf_int is None:
        kf_int = int(os.environ.get("DBG_KFINT", "5"))
    import time
    import jax
    print("backend:", jax.default_backend(), jax.devices())
    traj = os.environ.get("DBG_TRAJ", "orbit")
    mode = os.environ.get("DBG_MAPPING", "sync")
    print("traj:", traj, " mapping:", mode)
    scene = RoomScene(seed=1, n_clutter=4)
    if traj == "walk":
        from orbslam3_jax.utils.datasets import walk_trajectory
        poses = walk_trajectory(n_frames, period=280)
    else:
        poses = orbit_trajectory(n_frames, radius=1.0, forward=0.0)
    imgs = [scene.render(R, t) for (R, t) in poses]
    tp = TrackingParams(kf_interval_override=kf_int, pipeline=pipeline)
    if os.environ.get("DBG_NO_PRIOR"):
        tp.pose_prior_eps = 0.0
    if os.environ.get("DBG_NO_ANCHOR"):
        tp.cv_predict_min_px = 0.0
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=1024,
                      seed=0, mapping_mode=mode, tracking_params=tp,
                      kf_cull_redundancy=float(
                          os.environ.get("DBG_REDUNDANCY", "0.9")))
    gt = np.array([-R.T @ t for (R, t) in poses])
    dump_at = int(os.environ.get("DBG_DUMP_AT", "0"))
    t_loop0 = time.perf_counter()
    ev = os.environ.get("DBG_EVERY")
    ev_from = int(ev) if ev else None
    for i, (R, t) in enumerate(poses):
        if dump_at and i == dump_at:
            import faulthandler
            print(f"=== thread stacks at frame {i} ===", flush=True)
            faulthandler.dump_traceback()
        tf0 = time.perf_counter()
        info = slam.track_monocular(imgs[i], ts=float(i) / 20.0)
        if os.environ.get("DBG_COVERAGE") and i >= int(os.environ["DBG_COVERAGE"]):
            tr = slam.tracker
            tr.flush_pending()
            lf = tr.last_frame
            m = slam.map
            if lf is not None and lf.R is not None and os.environ.get(
                    "DBG_COVERAGE_GT"):
                # project through the GT pose mapped into the map frame via
                # the healthy-prefix similarity (est <- gt)
                from orbslam3_jax.utils.evaluation import horn_align
                ts_, R_wc_, t_wc_, lost_ = slam.export_trajectory()
                sel_ = ~lost_ & (ts_ < 12.0)
                gi_ = np.rint(ts_[sel_] * 20.0).astype(int)
                R_al, t_al, s_al = horn_align(gt[gi_], t_wc_[sel_],
                                              with_scale=True)
                R_gt_cw, t_gt_cw = poses[i]
                R_use = (R_gt_cw @ R_al.T).astype(np.float32)
                # xc_meters = R_gt·R_alᵀ·(x_map − t_al)/s + t_gt
                ids = m.valid_mp_ids()
                xc = ((m.mp_xyz[ids] - t_al) @ R_use.T) / s_al + t_gt_cw
                c_map = s_al * (R_al @ (-R_gt_cw.T @ t_gt_cw)) + t_al
            else:
                ids = m.valid_mp_ids()
                xc = m.mp_xyz[ids] @ lf.R.T + lf.t
                c_map = -lf.R.T @ lf.t
            z = xc[:, 2]
            fx, fy, cx, cy = scene.K
            u = fx * xc[:, 0] / np.maximum(z, 1e-6) + cx
            v = fy * xc[:, 1] / np.maximum(z, 1e-6) + cy
            infr = (z > 0.1) & (u > 0) & (u < scene.w) & (v > 0) & (v < scene.h)
            dist = np.linalg.norm(m.mp_xyz[ids] - c_map, axis=1)
            band = (dist >= m.mp_min_dist[ids]) & (dist <= m.mp_max_dist[ids])
            # nearest valid feature within 3px
            fxy = lf.xy[lf.valid]
            fdesc = lf.desc[lf.valid]
            sel = np.nonzero(infr)[0]
            n_geom = n_desc = 0
            pd = np.unpackbits(m.mp_desc[ids].view(np.uint8), axis=1)
            fd = np.unpackbits(fdesc.view(np.uint8), axis=1)
            for s_ in sel:
                d2 = np.abs(fxy[:, 0] - u[s_]) + np.abs(fxy[:, 1] - v[s_])
                near = np.nonzero(d2 < 6.0)[0]
                if len(near) == 0:
                    continue
                n_geom += 1
                hd = (pd[s_][None, :] != fd[near]).sum(1)
                if hd.min() <= 60:
                    n_desc += 1
            c_est = -lf.R.T @ lf.t
            dc = float(np.linalg.norm(c_est - c_map))
            dR = lf.R @ (poses[i][0] @ (R_al.T if os.environ.get(
                "DBG_COVERAGE_GT") else np.eye(3))).T
            ang = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            # yaw/pitch/roll of est vs gt world-to-cam
            def ypr(Rm):
                return (np.degrees(np.arctan2(-Rm[2, 0], Rm[2, 2])),
                        np.degrees(np.arcsin(np.clip(Rm[2, 1], -1, 1))),
                        np.degrees(np.arctan2(-Rm[0, 1], Rm[1, 1])))
            ye, pe, re_ = ypr(lf.R)
            yg, pg, rg = ypr(poses[i][0])
            print(f"  cov f{i}: frustum={int(infr.sum())} "
                  f"band={int((infr & band).sum())} geom3px={n_geom} "
                  f"desc={n_desc} tracked={lf.n_matched()} "
                  f"dc={dc:.4f} ang={np.degrees(ang):.2f}deg "
                  f"ypr_est=({ye:.1f},{pe:.1f},{re_:.1f}) "
                  f"ypr_gt=({yg:.1f},{pg:.1f},{rg:.1f})", flush=True)
        if ev_from is not None and i >= ev_from:
            tr = slam.tracker
            tr.flush_pending()
            lf = tr.last_frame
            extra = ""
            if lf is not None and lf.R is not None:
                mp = lf.feat_mp[lf.feat_mp >= 0]
                old_frac = (float((mp < 500).mean()) if len(mp) else -1)
                c = -lf.R.T @ lf.t
                extra = (f" ref_kf={tr.ref_kf} fused={getattr(lf, '_fused_done', False)}"
                         f" nmp={len(mp)} frac_lowid={old_frac:.2f}"
                         f" c=({c[0]:.2f},{c[1]:.2f},{c[2]:.2f})")
            print(f"  f{i:4d} {time.perf_counter()-tf0:7.3f}s {info}{extra}",
                  flush=True)
        if (i + 1) % 10 == 0:
            slam.tracker.flush_pending()
            st = slam.stats()
            ts, R_wc, t_wc, lost = slam.export_trajectory()
            sel = ~lost
            ate = None
            if sel.sum() > 5:
                try:
                    ate, n_assoc = evaluate_trajectory(
                        np.arange(i + 1) / 20.0, gt[: i + 1], ts[sel],
                        t_wc[sel], with_scale=True)
                except Exception as e:
                    ate = f"err:{e!r}"
            q = (len(slam.runtime.kf_queue)
                 if slam.runtime is not None else -1)
            print(f"f{i+1:4d} state={slam.state.name:6s} "
                  f"kf={st['n_keyframes']:3d} mp={st['n_map_points']:5d} "
                  f"culled_kf={st.get('culled_kf', 0):3d} "
                  f"culled_mp={st.get('culled_mp', 0):5d} "
                  f"lost={int(lost.sum()):3d} q={q} "
                  f"merr={st.get('mapper_errors', 0)}"
                  f"{' LAST:' + str(st.get('last_mapper_error'))[:120] if st.get('mapper_errors') else ''} "
                  f"ate={ate}")
    slam.tracker.flush_pending()
    wall = time.perf_counter() - t_loop0
    print(f"wall: {wall:.1f}s  fps={n_frames / wall:.2f}")
    # per-frame error profile after similarity alignment
    try:
        from orbslam3_jax.utils.evaluation import horn_align
        ts, R_wc, t_wc, lost = slam.export_trajectory()
        sel = ~lost
        gi = np.rint(ts[sel] * 20.0).astype(int)
        gi = np.clip(gi, 0, n_frames - 1)
        R_al, t_al, s_al = horn_align(t_wc[sel], gt[gi], with_scale=True)
        aligned = (s_al * (R_al @ t_wc[sel].T)).T + t_al
        err = np.linalg.norm(aligned - gt[gi], axis=1)
        worst = np.argsort(-err)[:12]
        print("scale:", round(s_al, 4), "worst frames:",
              [(int(gi[w]), round(float(err[w]), 3)) for w in worst])
        # per-segment scale profile: est displacement / gt displacement over
        # 10-frame windows — exposes mono scale drift along the run
        d_est = np.linalg.norm(np.diff(t_wc[sel], axis=0), axis=1)
        d_gt = np.linalg.norm(np.diff(gt[gi], axis=0), axis=1)
        n_w = len(d_est) // 10
        prof = [round(float(d_est[w * 10:(w + 1) * 10].sum()
                            / max(d_gt[w * 10:(w + 1) * 10].sum(), 1e-9)), 4)
                for w in range(n_w)]
        print("segment scale (est/gt, 10-frame windows):", prof)
    except Exception as e:
        print("err profile failed:", repr(e))
    lc = {k: v for k, v in slam.stats().items() if k.startswith(("loops", "lc"))}
    print("loop stats:", lc)
    print("kf ids:", slam.map.valid_kf_ids())
    st = slam.stats().get("stage_times", {})
    print("stages:", {k: round(v.get("median_ms", 0), 1)
                      for k, v in st.items()})


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    main(n)
