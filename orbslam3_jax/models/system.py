"""System facade: wires tracking + local mapping (+ later loop closing, atlas).

The reference ``System`` (reference src/System.cc:41-181 ctor spawning
LocalMapping/LoopClosing/Viewer threads, TrackMonocular :313, Shutdown :421,
trajectory savers :457-750). Here the pipeline runs in one host thread driving
asynchronous device dispatch; `mapping_mode='sync'` runs the mapper inline per
keyframe (deterministic, test-friendly), `'async'` defers it (future rounds).
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..ops import features as feat_ops
from .local_mapping import LocalMapper
from .map import MapConfig, MapState
from .tracking import Tracker, TrackingParams, TrackState


# Persistent-compile-cache directory on the GPU when JAX_COMPILATION_CACHE_DIR
# is not set: a fixed path inside the checkout (listed in .gitignore), never
# one derived from a pid, a time or a temp directory, so the next process
# finds what this one compiled.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compilation_cache_dir(backend: str, env=os.environ) -> str | None:
    """Where compiled executables persist across processes.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins. Else
    the GPU backend caches under ``CACHE_DIR``; the CPU backend caches
    nothing, since its executables embed host-feature tuning flags that can
    mis-load on another host (SIGILL risk)."""
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    return CACHE_DIR if backend == "gpu" else None


def enable_compilation_cache():
    """Turn on the persistent compilation cache (idempotent), so the
    pipeline's kernels compile once per checkout instead of once per
    process."""
    import jax
    if jax.config.jax_compilation_cache_dir is not None:
        return          # set by JAX_COMPILATION_CACHE_DIR or by the caller
    path = compilation_cache_dir(jax.default_backend())
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


class SlamSystem:
    @staticmethod
    def set_verbosity(level: int) -> None:
        """Reference Verbose::SetTh (include/System.h:47-73; QUIET at startup
        per src/System.cc:179). Levels in orbslam3_jax.utils.verbose."""
        from ..utils import verbose
        verbose.set_verbosity(level)

    def __init__(self, K, D, wh, n_features: int = 1024,
                 tracking_params: TrackingParams | None = None,
                 map_cfg: MapConfig | None = None, seed: int = 0,
                 bf: float = 0.0, th_depth: float = 0.0,
                 enable_loop_closing: bool = True, cam_type: int = 0,
                 mapping_mode: str = "sync",
                 kf_cull_redundancy: float = 0.9,
                 use_viewer: bool = False, viewer_port: int = 8642):
        enable_compilation_cache()
        self.orb_cfg = feat_ops.OrbConfig(n_features=n_features)
        cap = self.orb_cfg.total_capacity
        self.map_cfg = map_cfg or MapConfig(n_features=cap)
        if self.map_cfg.n_features != cap:
            self.map_cfg.n_features = cap
        from .atlas import Atlas
        from ..utils.timing import StageTimer
        # one pipeline-wide stage timer (reference REGISTER_TIMES,
        # include/Config.h:4; PrintTimeStats at shutdown src/System.cc:450-452)
        self.timer = StageTimer()
        self.atlas = Atlas(self.map_cfg)
        self._K = np.asarray(K, np.float32)
        self._wh = wh
        self._bf = float(bf)
        self._enable_lc = enable_loop_closing
        self._kf_cull_redundancy = float(kf_cull_redundancy)
        self.cam_type = int(cam_type)
        self.tracker = Tracker(K, D, wh, self.orb_cfg, self.atlas.current,
                               params=tracking_params, seed=seed,
                               bf=bf, th_depth=th_depth, cam_type=cam_type)
        # async runtime (reference thread architecture, src/System.cc:135-164)
        self.runtime = None
        if mapping_mode == "async":
            from .async_runtime import AsyncRuntime
            self.runtime = AsyncRuntime(self)
            self.tracker.mapper_accepting = self.runtime.accepting
        self._bind_map(self.atlas.current)
        self.tracker.on_tracking_lost = self._on_tracking_lost
        self.tracker.try_cross_map_reloc = self._try_cross_map_reloc
        self.frame_times: list[float] = []
        self.frame_spans: list[tuple] = []   # (t0, t1) perf_counter, per frame
        # live viewer thread (reference bUseViewer, src/System.cc:157-161)
        self.viewer = None
        if use_viewer:
            from .viewer import LiveViewer
            self.viewer = LiveViewer(self, port=viewer_port)

    @property
    def map(self) -> 'MapState':
        return self.atlas.current

    def _bind_map(self, m):
        """(Re)bind mapper/loop-closer/tracker to the active atlas map."""
        self.tracker.map = m
        self.tracker.timer = self.timer
        prev_mapper_stats = (self.mapper.stats
                             if getattr(self, "mapper", None) is not None
                             else None)
        prev_lc_stats = (self.loop_closer.stats
                         if getattr(self, "loop_closer", None) is not None
                         else None)
        self.mapper = LocalMapper(m, self._K, self.orb_cfg, wh=self._wh,
                                  cam_type=self.cam_type)
        if prev_mapper_stats is not None:
            # counters are system-lifetime (reference LocalMapping telemetry
            # src/LocalMapping.cc:190-209 outlives map switches) — a map
            # spawn/merge must not zero them
            self.mapper.stats.update(prev_mapper_stats)
        self.mapper.timer = self.timer
        self.mapper.kf_cull_redundancy = self._kf_cull_redundancy
        self.mapper.bf = self._bf
        # async mode: chunk the mapper's BA into short device dispatches so
        # concurrent tracking kernels interleave on the single in-order
        # device queue (reference: tracking never waits on LocalMapping's BA,
        # src/LocalMapping.cc:153-187); sync mode keeps the monolithic
        # dispatch (deterministic, marginally cheaper)
        self.mapper.ba_chunk = 3 if self.runtime is not None else 0
        self.mapper.preserve_temporal_chain = getattr(
            self.tracker, "imu_enabled", False)
        self.mapper.inertial = self.tracker
        self.mapper.rig = getattr(self.tracker, "rig", None)
        self.loop_closer = None
        if self._enable_lc:
            from .loop_closing import LoopCloser
            # the reference A.5 gates (20/15/20/50/80, src/LoopClosing.cc:
            # 734-738) are absolute counts tuned for its 1000+-feature
            # budgets; scale them with the configured budget (floored at
            # 40% so small rigs still verify strictly enough)
            gs = max(min(1.0, self.orb_cfg.n_features / 1000.0), 0.4)
            self.loop_closer = LoopCloser(
                m, self._K, self._wh, fix_scale=self._bf > 0,
                cam_type=self.cam_type,
                n_bow_matches=int(round(20 * gs)),
                n_bow_inliers=int(round(15 * gs)),
                n_sim3_inliers=int(round(20 * gs)),
                n_proj_matches=int(round(50 * gs)),
                n_proj_opt_matches=int(round(80 * gs)))
            self.loop_closer.timer = self.timer
            if prev_lc_stats is not None:
                self.loop_closer.stats.update(prev_lc_stats)
            # SearchAndFuse hook (reference src/LoopClosing.cc:1462 uses
            # ORBmatcher::Fuse — same kernel as the mapper's fuse)
            self.loop_closer.fuse_fn = (
                lambda mp_ids, kf: self.mapper._fuse_into(
                    np.asarray(mp_ids), int(kf), 4096))
            self.loop_closer.is_inertial = (
                lambda: getattr(self.tracker, "imu_initialized", False))
            # BoW inverted-file relocalization candidates (reference
            # KeyFrameDatabase::DetectRelocalizationCandidates)
            self.tracker.reloc_candidates_fn = (
                self.loop_closer.detect_relocalization_candidates)
            # cross-map merge detection lives in the loop closer (reference
            # DetectNBestCandidates' merge split); execution stays here
            self.loop_closer.stored_maps_fn = self.atlas.stored_maps
            self.loop_closer.merge_fn = self._merge_with

        self.mapper.on_poses_corrected = self._on_world_corrected
        self.mapper.on_bad_imu = self._on_bad_imu
        if self.runtime is not None:
            m.on_remap["runtime"] = (
                lambda kf_remap, mp_remap, _m=m:
                    self.runtime.on_map_remap(_m, kf_remap))

        def on_kf(kf_id, initial=False):
            if self.runtime is not None and not initial:
                # async: hand to the mapper thread (reference InsertKeyFrame
                # queue push, src/LocalMapping.cc:342)
                self.runtime.insert_keyframe(kf_id, initial)
                return
            # sync (or the bootstrap BA, which tracking needs immediately);
            # the mapper may compact the pools — use the remapped id
            kf_id = self.mapper.process_keyframe(kf_id, initial=initial)
            if self.loop_closer is not None and not initial:
                if self.loop_closer.process_keyframe(kf_id):
                    # loop corrected → full BA (reference RunGlobalBundleAdjustment
                    # after CorrectLoop, src/LoopClosing.cc:2587). On an
                    # IMU-initialized map the reference runs FullInertialBA(7)
                    # instead of visual GBA (:2591-2601) — visual-only GBA
                    # would move poses/points with no gravity/velocity/bias/
                    # preintegration terms and desynchronize the per-KF
                    # velocities the tracker predicts with.
                    self.run_post_loop_gba(kf_id)
            if len(self.atlas.maps) > 1 and self.loop_closer is None:
                # merge detection normally rides the loop closer's database
                # query (LoopCloser._try_merge); brute-force fallback only
                # when loop closing is disabled
                self._check_map_merge(kf_id)

        self.tracker.on_new_keyframe = on_kf

    def run_post_loop_gba(self, kf_id: int, abort_check=None,
                          propagate: bool = False) -> bool:
        """Post-loop-correction global consistency pass: FullInertialBA(7)
        on IMU-initialized maps (reference src/LoopClosing.cc:2591-2601),
        visual GBA otherwise."""
        if getattr(self.tracker, "imu_initialized", False):
            self.mapper.full_inertial_ba(kf_id, iters=7,
                                         prior_g=0.0, prior_a=0.0)
            return True
        return self.mapper.global_ba(abort_check=abort_check,
                                     propagate=propagate)

    def _on_bad_imu(self):
        """Insufficient motion after IMU init (reference mbBadImu,
        src/LocalMapping.cc:164-172): the inertial estimates are unusable —
        reset the active map rather than diverge (src/Tracking.cc:1805).
        Runs in the mapper's context, so the reset is inline (calling
        reset_active_map's wait_idle from the mapper thread would deadlock);
        stale queued keyframes are dropped by the map-identity check."""
        from .map import MapState
        tr = self.tracker
        tr.imu_initialized = False
        tr.viba1_done = False
        tr.viba2_done = False
        tr.velocity_w = None
        tr.freeze_trajectory(mark_lost=True)
        cur = self.atlas.current
        idx = self.atlas.current_idx
        self.atlas.maps[idx] = MapState(self.map_cfg, map_id=cur.map_id)
        self._bind_map(self.atlas.maps[idx])
        tr.reset_for_new_map(self.atlas.maps[idx])

    def _on_world_corrected(self, R_rel, t_rel):
        """After a propagated background GBA: shift the tracker's live frame by
        the anchor correction T_f_new = T_f_old ∘ T_rel (the reference instead
        lets tracking re-match against the corrected map; the explicit shift
        avoids a one-frame tracking glitch). Runs under the map lock."""
        lf = self.tracker.last_frame
        if lf is not None and lf.R is not None:
            R_old = lf.R.copy()
            lf.R = (R_old @ R_rel).astype(np.float32)
            lf.t = (R_old @ t_rel + lf.t).astype(np.float32)
        if self.tracker.velocity_w is not None:
            # T_rel maps new world → old world; rotate velocity into new world
            self.tracker.velocity_w = (
                R_rel.T @ self.tracker.velocity_w).astype(np.float32)

    def wait_idle(self, timeout: float = 300.0) -> bool:
        """Drain the async pipeline (no-op in sync mode)."""
        if self.runtime is None:
            return True
        return self.runtime.wait_idle(timeout)

    def shutdown(self, timeout: float = 300.0, print_times: bool = True):
        """Join the mapper/loop/GBA threads (reference System::Shutdown
        src/System.cc:421-453) and print the per-stage timing table (the
        reference's PrintTimeStats, src/System.cc:450-452)."""
        self.tracker.flush_pending()
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
        if self.runtime is not None:
            self.runtime.shutdown(timeout)
            self.runtime = None
        if print_times and self.timer.samples:
            from ..utils import verbose
            if verbose.get_verbosity() >= verbose.NORMAL:
                self.timer.print_stats()

    def print_time_stats(self, file=None):
        """Reference Tracking::PrintTimeStats (src/Tracking.cc:268)."""
        self.timer.print_stats(file=file)

    def save_time_stats(self, path: str):
        """Reference ExecTimeMean.txt (README.md:212-213)."""
        self.timer.save(path)

    def _on_tracking_lost(self):
        """Sustained loss: spawn a fresh sub-map (reference CreateMapInAtlas)
        unless the current map is too small to keep (reference resets it)."""
        cur = self.atlas.current
        # entries referencing the stored/wiped map can no longer follow its
        # keyframes — freeze them as absolute poses (lost if the map is wiped)
        self.tracker.freeze_trajectory(mark_lost=cur.n_kf < 10)
        if cur.n_kf >= 10:
            new_map = self.atlas.create_new_map()
        else:
            # reset-in-place: wipe the young map
            idx = self.atlas.current_idx
            from .map import MapState
            self.atlas.maps[idx] = MapState(self.map_cfg, map_id=cur.map_id)
            new_map = self.atlas.maps[idx]
        self._bind_map(new_map)
        self.tracker.reset_for_new_map(new_map)

    def _check_map_merge(self, kf_id: int) -> bool:
        """Fallback cross-map place recognition when no loop closer is bound
        (loop closing disabled): verify the new KF against stored maps' most
        recent keyframes. With a loop closer, merge detection instead runs as
        a BoW database query against WHOLE stored maps inside the
        loop-closing thread (LoopCloser._try_merge — reference
        NewDetectCommonRegions merge branch, src/LoopClosing.cc:592)."""
        from .loop_closing import LoopCloser
        cur = self.atlas.current
        closer = self.loop_closer
        if closer is None:
            closer = LoopCloser(cur, self._K, self._wh, fix_scale=self._bf > 0)
        for old in self.atlas.stored_maps():
            for k2 in old.valid_kf_ids()[::-1][:10]:
                with cur.lock, old.lock:
                    ok, S21 = closer._verify_candidate(kf_id, int(k2),
                                                       map1=cur, map2=old)
                if not ok:
                    continue
                if self._merge_with(kf_id, old, int(k2), S21):
                    return True
        return False

    def _merge_with(self, kf_id: int, old, k2: int, S21,
                    cur_map=None, cur_epoch=None) -> bool:
        """Execute an Atlas merge given a verified Sim3 between current-map
        ``kf_id`` and stored-map ``k2``.

        Initial correction: the reference's MergeLocal window propagation
        (src/LoopClosing.cc:1772-1853) computes each window keyframe's
        corrected pose as Siw_corr = (Siw·Twc)·Scw_merge, which factors into
        Siw ∘ (Swc·Scw_merge) — i.e. ONE world Sim3 applied to every
        keyframe (and, through their reference keyframes, every map point).
        The whole-map rigid+scale alignment below is that transform exactly.
        The part that genuinely differs per keyframe is downstream: the
        welding BA moves the weld window, and the essential graph on the
        remainder (reference :2141) measures its edges against the PRE-weld
        poses so the seam correction distributes along the trajectory — see
        _weld.

        ``cur_map``/``cur_epoch`` identify the map (and its compaction epoch)
        the Sim3 was verified against in the loop-closing thread; the merge is
        aborted if the tracker has since spawned a new Atlas map or the pool
        was compacted (kf_id would index a remapped slot — advisor r4)."""
        cur = self.atlas.current
        if cur_map is not None and cur_map is not cur:
            return False
        with cur.lock, old.lock:
            if cur_epoch is not None and cur.remap_epoch != cur_epoch:
                return False
            if not cur.kf_valid[kf_id] or not old.kf_valid[k2]:
                return False
            # S21: x_kf2 = s R x_kf1 + t (camera frames). World
            # alignment: W_old = T_kf2⁻¹ ∘ S21 ∘ T_kf1 (W_cur)
            s, R21, t21 = S21
            R1, t1 = cur.kf_R[kf_id], cur.kf_t[kf_id]
            R2, t2 = old.kf_R[int(k2)], old.kf_t[int(k2)]
            R_a = R2.T @ R21 @ R1
            t_a = R2.T @ (s * (R21 @ t1) + t21 - t2)
            self.atlas.merge_current_into(old, R_a.astype(np.float32),
                                          t_a.astype(np.float32),
                                          s_align=float(s))
            kf_map = self.atlas.last_merge_kf_map
            self.tracker.remap_trajectory_for_merge(kf_map)
            self.tracker.rotate_world_state_for_merge(R_a, float(s))
            self._bind_map(self.atlas.current)
            self.tracker.map = self.atlas.current
            # remap the live frame pose into the merged world
            lf = self.tracker.last_frame
            if lf is not None and lf.R is not None:
                R_new = lf.R @ R_a.T
                t_new = float(s) * lf.t - R_new @ t_a
                lf.R, lf.t = (R_new.astype(np.float32),
                              t_new.astype(np.float32))
            self.tracker.ref_kf = int(old.valid_kf_ids()[-1])
            # welding pass (reference MergeLocal :2028: fuse duplicated
            # landmarks across the weld, then a local welding BA around
            # the seam)
            nk = kf_map.get(int(kf_id))
            if nk is not None:
                self._weld(nk, int(k2))
        return True

    def _weld(self, nk: int, k2: int, cap: int = 4096):
        """Fuse duplicated landmarks between the migrated keyframe ``nk`` and
        the matched old-map region around ``k2``, then run a welding local BA
        (reference MergeLocal: SearchAndFuse on the welding windows + local
        BA, src/LoopClosing.cc:1885-2060)."""
        m = self.atlas.current
        mapper = self.mapper
        group2 = np.concatenate([[k2], m.best_covisible(k2, 5, min_weight=15)])
        pts2 = m.local_map_points(group2.astype(np.int32))
        mapper._fuse_into(pts2, nk, cap)
        row = m.kf_feat_mp[nk]
        pts_nk = np.unique(row[row >= 0])
        for t in group2:
            mapper._fuse_into(pts_nk, int(t), cap)
        m.refresh_map_points(pts_nk)
        # snapshot the pre-weld-BA poses: the essential graph below measures
        # its relative edges from these (the reference's NonCorrected poses,
        # src/Optimizer.cc:3019) so the weld BA's seam correction propagates
        # smoothly into the rest of the migrated map instead of the graph
        # solving an already-zero-residual problem
        meas = (m.kf_R.copy(), m.kf_t.copy())
        if getattr(self.tracker, "imu_initialized", False):
            # inertial weld: the joint pose/velocity/bias/landmark window BA
            # (reference MergeInertialBA, src/Optimizer.cc:6539, called from
            # MergeLocal2 :2435) — a visual-only weld BA would move the weld
            # poses off their preintegration chain
            mapper.local_inertial_ba(nk)
        else:
            mapper.local_ba(nk)
        # distribute the residual merge stress over the rest of the map
        # (reference MergeLocal: OptimizeEssentialGraph on keyframes outside
        # the welding window, src/LoopClosing.cc:2141), welding window fixed
        if self.loop_closer is not None and m.kf_valid[: m.n_kf].sum() > 4:
            fixed = [nk] + [int(g) for g in group2]
            try:
                self.loop_closer.optimize_essential_graph(fixed, meas=meas)
            except Exception as e:
                from ..utils import verbose
                verbose.print_mess(f"merge essential graph failed: {e!r}",
                                   verbose.NORMAL)

    def _try_cross_map_reloc(self, frame) -> bool:
        """Relocalize into a stored map; success merges the current map into it
        (reference merge branch, MergeLocal2-style rigid alignment)."""
        tr = self.tracker
        # approximate pose of this frame in the CURRENT map (last tracked)
        R_cur = t_cur = None
        if tr.last_frame is not None and tr.last_frame.R is not None:
            R_cur, t_cur = tr.last_frame.R.copy(), tr.last_frame.t.copy()
        for old in self.atlas.stored_maps():
            with old.lock:   # caller already holds the current map's lock
                if not tr._relocalize(frame, in_map=old):
                    continue
                cur = self.atlas.current
                if cur.n_kf >= 2 and R_cur is not None:
                    # alignment world_old ← world_cur from the dual pose:
                    # R_a = R_oldᵀ R_cur, t_a = R_oldᵀ (t_cur − t_old)
                    R_a = frame.R.T @ R_cur
                    t_a = frame.R.T @ (t_cur - frame.t)
                    self.atlas.merge_current_into(old, R_a.astype(np.float32),
                                                  t_a.astype(np.float32))
                    tr.remap_trajectory_for_merge(self.atlas.last_merge_kf_map)
                    tr.rotate_world_state_for_merge(R_a)
                else:
                    tr.freeze_trajectory()
                    self.atlas.current_idx = self.atlas.maps.index(old)
                self._bind_map(self.atlas.current)
                tr.map = self.atlas.current
                tr.state = TrackState.OK
                return True
        return False

    def track_monocular(self, img: np.ndarray, ts: float) -> dict:
        t0 = time.perf_counter()
        info = self.tracker.process_frame(img, ts)
        t1 = time.perf_counter()
        self.frame_times.append(t1 - t0)
        self.frame_spans.append((t0, t1))
        return info

    def enable_imu(self, freq: float = 200.0, noise=(1.7e-4, 2e-3, 1e-5, 1e-4)):
        """Switch to visual-inertial mode (reference IMU_MONOCULAR/IMU_STEREO)."""
        self.tracker.enable_imu(freq=freq, noise=noise)
        self.mapper.preserve_temporal_chain = True

    def track_monocular_inertial(self, img: np.ndarray, ts: float,
                                 imu_ts, imu_gyro, imu_acc) -> dict:
        """Monocular-inertial step: queue IMU samples since the last frame,
        then track (reference System::TrackMonocular with vImuMeas)."""
        self.tracker.grab_imu(imu_ts, imu_gyro, imu_acc)
        return self.track_monocular(img, ts)

    def track_stereo_inertial(self, img_l, img_r, ts: float,
                              imu_ts, imu_gyro, imu_acc) -> dict:
        self.tracker.grab_imu(imu_ts, imu_gyro, imu_acc)
        return self.track_stereo(img_l, img_r, ts)

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray, ts: float) -> dict:
        t0 = time.perf_counter()
        info = self.tracker.process_stereo_frame(img_l, img_r, ts)
        self.frame_times.append(time.perf_counter() - t0)
        return info

    def set_fisheye_rig(self, cam_r, R_rl, t_rl, lap_l=(0.0, 1e9),
                        lap_r=(0.0, 1e9)):
        """Two-camera fisheye rig (reference Camera2.* + Tlr YAML keys)."""
        self.tracker.set_fisheye_rig(cam_r, R_rl, t_rl, lap_l, lap_r)
        self._bf = self.tracker.bf
        self.mapper.bf = self.tracker.bf
        self.mapper.rig = self.tracker.rig

    def track_stereo_fisheye(self, img_l: np.ndarray, img_r: np.ndarray,
                             ts: float) -> dict:
        """Two-camera fisheye step (reference TrackStereo with KB8 cameras)."""
        t0 = time.perf_counter()
        info = self.tracker.process_fisheye_stereo_frame(img_l, img_r, ts)
        self.frame_times.append(time.perf_counter() - t0)
        return info

    def track_rgbd(self, img: np.ndarray, depth_map: np.ndarray, ts: float) -> dict:
        """RGB-D: depth sampled at keypoints → virtual right coords (reference
        GrabImageRGBD src/Tracking.cc:1330 + ComputeStereoFromRGBD)."""
        t0 = time.perf_counter()
        info = self.tracker.process_rgbd_frame(img, depth_map, ts)
        self.frame_times.append(time.perf_counter() - t0)
        return info

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def export_trajectory(self):
        self.tracker.flush_pending()
        return self.tracker.export_trajectory()

    def save_trajectory_tum(self, path: str):
        """TUM format: ts tx ty tz qx qy qz qw (reference SaveTrajectoryTUM
        src/System.cc:457)."""
        import jax.numpy as jnp
        from ..ops import lie
        ts, R_wc, t_wc, lost = self.export_trajectory()
        q = np.asarray(lie.quat_from_mat(jnp.asarray(R_wc)))
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]:.6f} " + " ".join(f"{v:.7f}" for v in t_wc[i])
                        + " " + " ".join(f"{v:.7f}" for v in q[i]) + "\n")

    def save_trajectory_euroc(self, path: str):
        """EuRoC format: ts_ns tx ty tz qw qx qy qz (reference
        SaveTrajectoryEuRoC src/System.cc:550)."""
        import jax.numpy as jnp
        from ..ops import lie
        ts, R_wc, t_wc, lost = self.export_trajectory()
        q = np.asarray(lie.quat_from_mat(jnp.asarray(R_wc)))  # (x,y,z,w)
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]*1e9:.0f} " + " ".join(f"{v:.9f}" for v in t_wc[i])
                        + f" {q[i,3]:.9f} {q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f}\n")

    def _keyframe_poses(self):
        """(ts, R_wc, t_wc) per valid keyframe of the active map."""
        self.tracker.flush_pending()
        m = self.map
        with m.lock:
            ids = m.valid_kf_ids()
            ts = m.kf_ts[ids].copy()
            R_cw = m.kf_R[ids].copy()
            t_cw = m.kf_t[ids].copy()
        R_wc = R_cw.transpose(0, 2, 1)
        t_wc = -np.einsum("nij,nj->ni", R_wc, t_cw)
        return ts, R_wc, t_wc

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe poses, TUM format (reference SaveKeyFrameTrajectoryTUM
        src/System.cc:517: ts tx ty tz qx qy qz qw per keyframe)."""
        import jax.numpy as jnp
        from ..ops import lie
        ts, R_wc, t_wc = self._keyframe_poses()
        q = np.asarray(lie.quat_from_mat(jnp.asarray(R_wc)))
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]:.6f} " + " ".join(f"{v:.7f}" for v in t_wc[i])
                        + " " + " ".join(f"{v:.7f}" for v in q[i]) + "\n")

    def save_keyframe_trajectory_euroc(self, path: str):
        """Keyframe poses, EuRoC format (reference SaveKeyFrameTrajectoryEuRoC
        src/System.cc:649: ts_ns tx ty tz qw qx qy qz per keyframe)."""
        import jax.numpy as jnp
        from ..ops import lie
        ts, R_wc, t_wc = self._keyframe_poses()
        q = np.asarray(lie.quat_from_mat(jnp.asarray(R_wc)))  # (x,y,z,w)
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]*1e9:.0f} "
                        + " ".join(f"{v:.9f}" for v in t_wc[i])
                        + f" {q[i,3]:.9f} {q[i,0]:.9f} {q[i,1]:.9f}"
                        f" {q[i,2]:.9f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 12 values of the 3x4 [R|t] world←camera matrix per line
        (reference SaveTrajectoryKITTI src/System.cc:700)."""
        ts, R_wc, t_wc, lost = self.export_trajectory()
        with open(path, "w") as f:
            for i in range(len(ts)):
                M = np.concatenate([R_wc[i], t_wc[i][:, None]], axis=1)
                f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")

    # -- reference System API parity (src/System.cc:382-419, 752-796) -------
    def activate_localization_mode(self):
        """Freeze the map; tracking-only (reference ActivateLocalizationMode
        src/System.cc:382 — pauses LocalMapping and sets mbOnlyTracking)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """Resume mapping (reference DeactivateLocalizationMode
        src/System.cc:390)."""
        self.tracker.only_tracking = False

    def reset(self):
        """Full system reset: wipe every map in the Atlas (reference
        System::Reset → Tracking::Reset, src/System.cc:411)."""
        from .atlas import Atlas
        self.wait_idle()
        self.atlas = Atlas(self.map_cfg)
        self._bind_map(self.atlas.current)
        self.tracker.reset_for_new_map(self.atlas.current)
        self.tracker.trajectory.clear()

    def reset_active_map(self):
        """Wipe only the active map (reference System::ResetActiveMap →
        Tracking::ResetActiveMap, src/System.cc:416)."""
        from .map import MapState
        self.wait_idle()
        self.tracker.freeze_trajectory(mark_lost=True)
        cur = self.atlas.current
        idx = self.atlas.current_idx
        self.atlas.maps[idx] = MapState(self.map_cfg, map_id=cur.map_id)
        self._bind_map(self.atlas.maps[idx])
        self.tracker.reset_for_new_map(self.atlas.maps[idx])

    def get_tracking_state(self) -> TrackState:
        """Reference GetTrackingState (src/System.cc:752)."""
        self.tracker.flush_pending()
        return self.tracker.state

    def get_tracked_map_points(self) -> np.ndarray:
        """Map-point ids matched in the current frame (reference
        GetTrackedMapPoints src/System.cc:758)."""
        lf = self.tracker.last_frame
        if lf is None:
            return np.zeros(0, np.int64)
        mp = lf.feat_mp[lf.feat_mp >= 0]
        return mp[self.map.mp_valid[mp]]

    def get_tracked_keypoints(self) -> np.ndarray:
        """(N,2) keypoints of the current frame (reference
        GetTrackedKeyPointsUn src/System.cc:764)."""
        lf = self.tracker.last_frame
        if lf is None:
            return np.zeros((0, 2), np.float32)
        return lf.xy[lf.valid]

    def save_map(self, dir_path: str):
        """Persist the whole Atlas (reference SaveMap — scaffolded-only in
        V0.4, include/System.h:172-174; a real feature here)."""
        from ..utils import serialization
        self.wait_idle()
        serialization.save_atlas(self.atlas, dir_path)

    def load_map(self, dir_path: str):
        """Restore an Atlas checkpoint and re-bind the pipeline to it."""
        from ..utils import serialization
        self.atlas = serialization.load_atlas(dir_path, self.map_cfg)
        self._bind_map(self.atlas.current)
        self.tracker.reset_for_new_map(self.atlas.current)

    def stats(self) -> dict:
        self.tracker.flush_pending()
        ft = np.array(self.frame_times) if self.frame_times else np.zeros(1)
        out = {
            "n_frames": len(self.frame_times),
            "n_keyframes": int(self.map.kf_valid.sum()),
            "n_map_points": int(self.map.mp_valid.sum()),
            "mean_frame_ms": float(ft.mean() * 1e3),
            "median_frame_ms": float(np.median(ft) * 1e3),
            "fps": float(1.0 / max(ft.mean(), 1e-9)),
            **self.mapper.stats,
        }
        if self.loop_closer is not None:
            out.update(self.loop_closer.stats)
        out["stage_times"] = self.timer.stats()
        return out
