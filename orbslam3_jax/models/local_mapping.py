"""Local mapping: keyframe processing, triangulation, local BA, culling.

Rebuilds the reference ``LocalMapping`` thread (reference src/LocalMapping.cc:77-339
Run() loop: ProcessNewKeyFrame → MapPointCulling → CreateNewMapPoints →
SearchInNeighbors → LocalBundleAdjustment → KeyFrameCulling) as a host driver
over batched kernels. In this framework the mapper can run synchronously
(called per new keyframe) or asynchronously (see system.py); the algorithms are
identical — the reference's queue/mutex machinery (src/LocalMapping.cc:342-346)
is unnecessary because map mutation happens in one host thread and device
kernels consume immutable snapshots.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import ba as ba_ops
from ..utils.timing import StageTimer
from . import kernels
from .map import MapState


class LocalMapper:
    def __init__(self, map_state: MapState, K: np.ndarray, orb_cfg,
                 wh=(752, 480), ba_window: int = 16, ba_max_fixed: int = 8,
                 ba_point_cap: int = 4096, ba_obs_cap: int = 16384,
                 cam_type: int = 0):
        self.map = map_state
        self.K = np.asarray(K, np.float32)
        self.wh = np.asarray(wh, np.float32)
        self.orb_cfg = orb_cfg
        self.bf = 0.0  # set by the system for stereo/RGB-D rigs
        self.ba_window = ba_window
        self.ba_max_fixed = ba_max_fixed
        self.ba_point_cap = ba_point_cap
        self.ba_obs_cap = ba_obs_cap
        self.cam_type = int(cam_type)
        self.tri_match = kernels.triangulation_matcher(
            self.cam_type, orb_cfg.n_levels, orb_cfg.scale)
        self._ba_jit = None
        self.recent_mp: list[tuple[int, np.ndarray]] = []  # (created_at_kf, ids)
        self.stats = {"triangulated": 0, "culled_mp": 0, "ba_runs": 0}
        # async hook: called with the anchor SE3 correction after a
        # propagated global BA so the tracker can shift its live frame
        self.on_poses_corrected = None
        # inertial: Tracker backref (owns biases/preintegrations); set by the
        # system for VI rigs. The staging logic itself runs here — in the
        # reference it is the LocalMapping thread that drives InitializeIMU /
        # VIBA1 / VIBA2 / ScaleRefinement (src/LocalMapping.cc:211-288)
        self.inertial = None
        self.vi_window = 10
        self._vi_jit = {}
        # two-camera rig (dict with cam_r/R_rl/t_rl) — adds ToBody residuals
        self.rig = None
        # keyframe-cull redundancy threshold (reference 0.9,
        # src/LocalMapping.cc:1218); configurable — clean synthetic imagery
        # re-matches so well that the reference value empties the map
        self.kf_cull_redundancy = 0.9
        self.timer = StageTimer()   # shared pipeline timer (system-injected)
        # bad-IMU hook (reference mbBadImu → Tracking resets the active map)
        self.on_bad_imu = None
        map_state.on_remap["mapper"] = self._on_map_remap

    def _on_map_remap(self, kf_remap: np.ndarray, mp_remap: np.ndarray):
        """Map pools compacted/grown: remap held ids (under the map lock)."""
        out = []
        for created_kf, ids in self.recent_mp:
            ids = mp_remap[ids]
            ids = ids[ids >= 0]
            ck = int(kf_remap[created_kf])
            if ck < 0:
                # creator culled: its compacted position preserves the age
                ck = int(np.searchsorted(np.nonzero(kf_remap >= 0)[0],
                                         created_kf))
            if len(ids):
                out.append((ck, ids.astype(np.int32)))
        self.recent_mp = out

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, initial: bool = False,
                         abort_check=None) -> int:
        """One mapper round (reference LocalMapping::Run body,
        src/LocalMapping.cc:77-339). ``abort_check`` implements the
        reference's run-BA-only-when-idle rule (:153: LBA runs only if the
        keyframe queue is empty and no stop was requested). Returns the
        keyframe's id, remapped if the mapper compacted the pools."""
        m = self.map
        with m.lock:
            kf_id = m.maybe_compact(kf_id)
            with self.timer.stage("5.kf_insert"):
                m.refresh_map_points(
                    np.unique(m.kf_feat_mp[kf_id][m.kf_feat_mp[kf_id] >= 0]))
                # spanning-tree parent = most-covisible earlier keyframe
                # (reference KeyFrame::UpdateConnections first-connection
                # parent assignment, src/KeyFrame.cc:515-523)
                if m.kf_parent[kf_id] < 0:
                    covis = m.covisibility_row(kf_id)
                    covis[kf_id:] = 0     # parents precede their children
                    if covis.max() >= 15:
                        m.kf_parent[kf_id] = int(np.argmax(covis))
                    else:
                        earlier = [int(v) for v in m.valid_kf_ids()
                                   if v < kf_id]
                        if earlier:
                            m.kf_parent[kf_id] = earlier[-1]
            if initial:
                # initial map: global BA over the 2 bootstrap KFs (reference
                # CreateInitialMapMonocular runs GlobalBundleAdjustemnt(20))
                self.local_ba(kf_id, iters=(10, 20))
                self._renormalize_initial_scale(kf_id)
                return kf_id
            with self.timer.stage("6.mp_culling"):
                self.cull_map_points(kf_id)
        # triangulation + fuse manage their own locking: they gather and
        # dispatch under the map lock but block on the device PULL outside
        # it, so the tracker (locked_current on the same per-map lock) is
        # never stalled behind a mapper device round trip — the reference's
        # Tracking-never-blocks-on-mapping contract (src/Tracking.cc:3626,
        # src/LocalMapping.cc:153-187). Pool indices stay stable meanwhile:
        # compaction runs only in this thread (maybe_compact above).
        with self.timer.stage("7.mp_creation"):
            self.create_new_map_points(kf_id)
        with self.timer.stage("8.fuse"):
            self.search_in_neighbors(kf_id)
        if abort_check is None or not abort_check():
            with self.timer.stage("9.local_ba"):
                if (self.inertial is not None and self.inertial.imu_initialized):
                    # reference: LocalInertialBA replaces LocalBundleAdjustment
                    # once the map is IMU-initialized (src/LocalMapping.cc:153-187)
                    self.local_inertial_ba(kf_id)
                else:
                    self.local_ba(kf_id)
            with m.lock, self.timer.stage("10.kf_culling"):
                self.cull_keyframes(kf_id)
        if self.inertial is not None and self.inertial.imu_enabled:
            with m.lock:
                self._inertial_stage(kf_id)
        return kf_id

    def _renormalize_initial_scale(self, kf_id: int):
        """After init BA, re-fix median depth to 1 (the BA may drift the gauge
        scale since only pose 0 is fixed)."""
        m = self.map
        mps = m.valid_mp_ids()
        if len(mps) == 0:
            return
        depths = (m.mp_xyz[mps] @ m.kf_R[0].T + m.kf_t[0])[:, 2]
        med = np.median(depths)
        if med <= 1e-6:
            return
        m.mp_xyz[mps] /= med
        for k in range(m.n_kf):
            m.kf_t[k] /= med
        m.touch()

    # ------------------------------------------------------------------
    def cull_map_points(self, kf_id: int):
        """Reference MapPointCulling (src/LocalMapping.cc:430-471): cull recent
        points with found/visible < 0.25 or too few observations 2 KFs after
        creation; release from probation after 3 KFs."""
        m = self.map
        survivors = []
        to_cull = []
        for created_kf, ids in self.recent_mp:
            ids = ids[m.mp_valid[ids]]
            if len(ids) == 0:
                continue
            age = kf_id - created_kf
            ratio = m.mp_found[ids] / np.maximum(m.mp_visible[ids], 1)
            bad = ratio < 0.25
            if age >= 2:
                bad |= m.obs_count(ids) <= 2
            to_cull.append(ids[bad])
            keep = ids[~bad]
            if age < 3 and len(keep):
                survivors.append((created_kf, keep))
        self.recent_mp = survivors
        if to_cull:
            allc = np.concatenate(to_cull)
            m.remove_map_points(allc)
            self.stats["culled_mp"] += len(allc)

    # ------------------------------------------------------------------
    def create_new_map_points(self, kf_id: int, n_neighbors: int = 10):
        """Reference CreateNewMapPoints (src/LocalMapping.cc:487): epipolar
        search + triangulation against best covisible KFs — ALL neighbors in
        ONE dispatch + ONE packed download (not one round trip per
        neighbor)."""
        from .device_map import kf_pool_for
        m = self.map
        with m.lock:
            out_dev = self._dispatch_triangulation(kf_id, n_neighbors)
        if out_dev is None:
            return
        out_dev, nb_ids, c1, cap_new = out_dev
        # block on the device round trip OUTSIDE the map lock (tracker must
        # not wait behind it); indices stay valid — compaction is same-thread
        out = np.asarray(out_dev)
        with m.lock:
            self._apply_triangulation(kf_id, out, nb_ids, c1, cap_new)

    def _dispatch_triangulation(self, kf_id: int, n_neighbors: int):
        from .device_map import kf_pool_for
        m = self.map
        neighbors = m.best_covisible(kf_id, n_neighbors, min_weight=15)
        if len(neighbors) == 0 and m.n_kf >= 2:
            neighbors = np.array([kf_id - 1], np.int32)
        R1, t1 = m.kf_R[kf_id], m.kf_t[kf_id]
        c1 = -R1.T @ t1
        un1 = m.kf_feat_valid[kf_id] & (m.kf_feat_mp[kf_id] < 0)
        if un1.sum() < 10:
            return None
        keep = []
        for k2 in neighbors:
            k2 = int(k2)
            R2, t2 = m.kf_R[k2], m.kf_t[k2]
            c2 = -R2.T @ t2
            baseline = np.linalg.norm(c1 - c2)
            # baseline/median-depth check (reference :520-540 area)
            mps2 = m.kf_feat_mp[k2]
            mps2 = mps2[mps2 >= 0]
            if len(mps2):
                depths = (m.mp_xyz[mps2] @ R2.T + t2)[:, 2]
                med = np.median(depths[depths > 0]) if (depths > 0).any() else 1.0
                if baseline / max(med, 1e-9) < 0.01:
                    continue
            elif baseline < 1e-6:
                continue
            un2 = m.kf_feat_valid[k2] & (m.kf_feat_mp[k2] < 0)
            if un2.sum() < 10:
                continue
            keep.append((k2, un2))
        if not keep:
            return None
        B = 16 if len(keep) > 8 else 8
        N = m.cfg.n_features
        nb_ids = np.full(B, -1, np.int32)
        un2_all = np.zeros((B, N), bool)
        for i, (k2, un2) in enumerate(keep):
            nb_ids[i] = k2
            un2_all[i] = un2
        poses2 = np.zeros((B, 12), np.float32)
        poses2[: len(keep), 0:9] = m.kf_R[nb_ids[: len(keep)]].reshape(-1, 9)
        poses2[: len(keep), 9:12] = m.kf_t[nb_ids[: len(keep)]]
        pose1 = np.concatenate([R1.reshape(-1), t1]).astype(np.float32)
        pool_xy, pool_desc, pool_oct = kf_pool_for(m).sync(
            m, [kf_id] + [k for k, _ in keep])
        cap_new = 2048
        fn = kernels.triangulation_batched(
            self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
            tuple(float(v) for v in self.K), cap_new=cap_new,
            max_dist=50, sigma_n=1.0 / float(self.K[0]))
        out_dev = fn(
            jnp.asarray(pose1),
            pool_xy[kf_id], pool_desc[kf_id], pool_oct[kf_id],
            jnp.asarray(un1), jnp.asarray(nb_ids),
            jnp.asarray(nb_ids >= 0), jnp.asarray(poses2),
            jnp.asarray(un2_all), pool_xy, pool_desc, pool_oct)
        return out_dev, nb_ids, c1, cap_new

    def _apply_triangulation(self, kf_id: int, out, nb_ids, c1, cap_new):
        m = self.map
        count = int(out[0])
        if count == 0:
            return
        f1 = out[1: 1 + cap_new][:count]
        f2 = out[1 + cap_new: 1 + 2 * cap_new][:count]
        b = out[1 + 2 * cap_new: 1 + 3 * cap_new][:count]
        xw = np.stack([
            out[1 + 3 * cap_new: 1 + 4 * cap_new][:count].view(np.float32),
            out[1 + 4 * cap_new: 1 + 5 * cap_new][:count].view(np.float32),
            out[1 + 5 * cap_new: 1 + 6 * cap_new][:count].view(np.float32),
        ], axis=1)
        # a feature may triangulate against several neighbors — keep the first
        # (neighbors are covisibility-ranked; the sequential reference loop
        # implicitly does the same because later pairs see it as matched)
        _, first = np.unique(f1, return_index=True)
        first = np.sort(first)
        f1, f2, b, xw = f1[first], f2[first], b[first], xw[first]
        good = np.isfinite(xw).all(axis=1)
        f1, f2, b, xw = f1[good], f2[good], b[good], xw[good]
        if len(f1) == 0:
            return
        k2_arr = nb_ids[b]
        dirs = xw - c1
        dist = np.linalg.norm(dirs, axis=1)
        normals = dirs / np.maximum(dist[:, None], 1e-9)
        sf = m.scale_factors
        lvl = m.kf_feat_octave[kf_id, f1]
        maxd = dist * sf[lvl]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xw.astype(np.float32),
                               m.kf_feat_desc[kf_id, f1], kf_id,
                               normals, mind, maxd, first_kf=kf_id)
        m.kf_feat_mp[kf_id, f1] = ids
        m.kf_feat_mp[k2_arr, f2] = ids
        # seed counters so culling's found-ratio starts neutral
        m.mp_visible[ids] = 1
        m.mp_found[ids] = 1
        self.recent_mp.append((kf_id, ids))
        self.stats["triangulated"] += len(ids)

    # ------------------------------------------------------------------
    def search_in_neighbors(self, kf_id: int, n_neighbors: int = 10, cap: int = 4096):
        """Fuse duplicated landmarks & add missing observations (reference
        SearchInNeighbors src/LocalMapping.cc:925 + ORBmatcher::Fuse :1823):
        project the new KF's points into its covisible neighbors (and the
        union of neighbor points into the new KF); a projected point matching
        an existing feature either merges with that feature's point (keep the
        more-observed one) or claims the free feature as a new observation."""
        m = self.map
        if not hasattr(self, "_fuse_match"):
            self._fuse_match = kernels.projection_matcher(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale)
        from .device_map import kf_pool_for, mirror_for
        with m.lock:
            neighbors = [int(k) for k in
                         m.best_covisible(kf_id, n_neighbors, min_weight=15)]
            if not neighbors:
                return
            kf_mps = m.kf_feat_mp[kf_id]
            kf_mps = np.unique(kf_mps[kf_mps >= 0])
            kf_mps = kf_mps[m.mp_valid[kf_mps]]
            # both directions in ONE dispatch: targets = neighbors (receiving
            # this KF's points) + this KF (receiving the union of neighbor
            # points)
            neigh_mps = m.local_map_points(np.asarray(neighbors, np.int32))
            targets = neighbors + [kf_id]
            T = 16 if len(targets) > 12 else 12
            C = cap
            tgt_ids = np.full(T, -1, np.int32)
            tgt_ids[: len(targets)] = targets
            tgt_poses = np.zeros((T, 12), np.float32)
            tgt_poses[: len(targets), 0:9] = m.kf_R[targets].reshape(-1, 9)
            tgt_poses[: len(targets), 9:12] = m.kf_t[targets]
            N = m.cfg.n_features
            tgt_fvalid = np.zeros((T, N), bool)
            tgt_fvalid[: len(targets)] = m.kf_feat_valid[targets]
            cand_ids = np.full((T, C), -1, np.int32)
            for i in range(len(neighbors)):
                cand_ids[i, : min(len(kf_mps), C)] = kf_mps[:C]
            cand_ids[len(targets) - 1, : min(len(neigh_mps), C)] = neigh_mps[:C]
            fn = kernels.fuse_batched(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
                tuple(float(v) for v in self.K),
                (float(self.wh[0]), float(self.wh[1])), cap_cand=C)
            mpf, mpu = mirror_for(m).sync(m)
            pool_xy, pool_desc, pool_oct = kf_pool_for(m).sync(m, targets)
            cap_out = 4096
            out_dev = fn(
                jnp.asarray(tgt_ids), jnp.asarray(tgt_poses),
                jnp.asarray(tgt_fvalid), jnp.asarray(cand_ids), mpf, mpu,
                pool_xy, pool_desc, pool_oct)
        # device round trip outside the lock (see process_keyframe)
        out = np.asarray(out_dev)
        with m.lock:
            count = int(out[0])
            if count:
                t_i = out[1: 1 + cap_out][:count]
                c_i = out[1 + cap_out: 1 + 2 * cap_out][:count]
                f_i = out[1 + 2 * cap_out: 1 + 3 * cap_out][:count]
                self._apply_fuse_matches(tgt_ids[t_i], cand_ids[t_i, c_i], f_i)
            m.refresh_map_points(kf_mps)

    def _apply_fuse_matches(self, tgt_kf: np.ndarray, mp_src: np.ndarray,
                            feat_tgt: np.ndarray):
        """Merge/claim bookkeeping for batched fuse matches (reference
        MapPoint::Replace semantics: keep the more-observed point)."""
        m = self.map
        obs_cnt = m.obs_count()
        replaced: dict[int, int] = {}
        rep_old: list[int] = []
        rep_new: list[int] = []
        for mp, t, ft in zip(mp_src, tgt_kf, feat_tgt):
            mp = int(mp)
            mp = replaced.get(mp, mp)
            if mp < 0 or not m.mp_valid[mp]:
                continue
            existing = int(m.kf_feat_mp[t, ft])
            existing = replaced.get(existing, existing)
            if existing == mp:
                continue
            if existing < 0 or not m.mp_valid[existing]:
                m.kf_feat_mp[t, ft] = mp
                continue
            # merge: keep the more-observed point (reference MapPoint::Replace)
            if obs_cnt[mp] >= obs_cnt[existing]:
                old, new = existing, mp
            else:
                old, new = mp, existing
            if replaced.get(old, old) != old:
                continue
            replaced[old] = new
            rep_old.append(old)
            rep_new.append(new)
        if rep_old:
            m.replace_map_points(np.asarray(rep_old, np.int64),
                                 np.asarray(rep_new, np.int64))

    def _fuse_into(self, mp_ids: np.ndarray, target_kf: int, cap: int):
        import jax.numpy as jnp
        m = self.map
        if not hasattr(self, "_fuse_match"):
            self._fuse_match = kernels.projection_matcher(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale)
        mp_ids = mp_ids[m.mp_valid[mp_ids]][:cap]
        if len(mp_ids) == 0:
            return
        n = len(mp_ids)
        pad = cap - n
        def pk(a, fill=0.0):
            out = a[mp_ids]
            if pad:
                out = np.concatenate([out, np.full((pad,) + out.shape[1:], fill, out.dtype)])
            return out
        valid = np.zeros(cap, bool)
        valid[:n] = True
        idx, ok, uv, lvl, frustum = self._fuse_match(
            jnp.asarray(pk(m.mp_xyz)), jnp.asarray(pk(m.mp_desc)),
            jnp.asarray(pk(m.mp_normal)), jnp.asarray(pk(m.mp_min_dist)),
            jnp.asarray(pk(m.mp_max_dist, 1.0)), jnp.asarray(valid),
            jnp.asarray(m.kf_R[target_kf]), jnp.asarray(m.kf_t[target_kf]),
            jnp.asarray(self.K), jnp.asarray(m.kf_feat_xy[target_kf]),
            jnp.asarray(m.kf_feat_desc[target_kf]),
            jnp.asarray(m.kf_feat_octave[target_kf]),
            jnp.asarray(m.kf_feat_valid[target_kf]), jnp.asarray(self.wh),
            jnp.asarray(3.0, jnp.float32),   # fuse radius 3*scale (reference Fuse th=3)
            jnp.asarray(1.0, jnp.float32),   # no ratio test in Fuse
            jnp.asarray(50, jnp.int32),      # TH_LOW
            jnp.asarray(0.5, jnp.float32))
        okn = np.asarray(ok)[:n]
        idxn = np.asarray(idx)[:n]
        src = np.nonzero(okn)[0]
        if len(src) == 0:
            return
        mp_src = mp_ids[src]
        feat_tgt = idxn[src]
        cur = m.kf_feat_mp[target_kf, feat_tgt]
        obs_cnt = m.obs_count()
        for mp, ft, existing in zip(mp_src, feat_tgt, cur):
            if existing == mp:
                continue
            if existing < 0:
                m.kf_feat_mp[target_kf, ft] = mp
            else:
                if not m.mp_valid[existing]:
                    m.kf_feat_mp[target_kf, ft] = mp
                    continue
                # merge: keep the more-observed point (reference MapPoint::Replace)
                if obs_cnt[mp] >= obs_cnt[existing]:
                    m.replace_map_points(np.asarray([existing]), np.asarray([mp]))
                else:
                    m.replace_map_points(np.asarray([mp]), np.asarray([existing]))

    # ------------------------------------------------------------------
    def cull_keyframes(self, kf_id: int, redundancy: float | None = None,
                       max_cull_per_run: int = 20):
        """Redundant-keyframe culling (reference KeyFrameCulling
        src/LocalMapping.cc:1218: a covisible KF ≥90% of whose ≥3-observer map
        points are observed by ≥3 other keyframes at the same or finer scale
        is removed; first two keyframes always kept). The redundancy counts
        run in one native C++ kernel over ALL covisible candidates — the
        reference iterates its full vpLocalKeyFrames list too; the old top-20/
        2-per-round cap could not keep up with the insertion cadence. Inertial
        maps follow the reference's temporal-chain protections (:1296-1390):
        culling must not open a gap > 0.5 s (3 s once VIBA2 has run), and the
        culled keyframe's preintegration merges into its successor's
        (IMU::Preintegrated::MergePrevious)."""
        from .. import native
        if redundancy is None:
            redundancy = self.kf_cull_redundancy
        m = self.map
        tr = self.inertial
        inertial = (tr is not None and tr.imu_enabled
                    and getattr(self, "preserve_temporal_chain", True))
        # reference: in inertial mode nothing is culled while the map holds
        # ≤ Nd=21 keyframes (src/LocalMapping.cc:1234,1356-1360) — the IMU
        # init needs the dense temporal chain
        if inertial and len(m.valid_kf_ids()) <= 21:
            return
        th_depth = float(getattr(tr, "th_depth", 0.0) or 0.0) if self.bf > 0 else 0.0

        def redundancy_counts(cands):
            red_tot = native.kf_redundancy(
                m.kf_feat_mp[: m.n_kf], m.kf_valid[: m.n_kf],
                m.kf_feat_octave[: m.n_kf], m.kf_feat_depth[: m.n_kf],
                th_depth, cands, m.cfg.max_map_points)
            if red_tot is not None:
                return red_tot
            # numpy fallback: scale-unaware approximation. Denominator counts
            # ALL good tracked points (reference nMPs); only the redundancy
            # numerator requires >3 observations (nObs > thObs gate).
            obs = m.obs_count()
            red = np.zeros(len(cands), np.int32)
            tot = np.zeros(len(cands), np.int32)
            for i, k in enumerate(cands):
                row = m.kf_feat_mp[k]
                mps = row[row >= 0]
                mps = mps[m.mp_valid[mps]]
                tot[i] = len(mps)
                red[i] = int((obs[mps] > 3).sum())
            return red, tot

        n_culled = 0
        # cull worst-first, recomputing after each removal (a removal lowers
        # its neighbors' redundancy — precomputed counts would over-cull
        # mutually-supported pairs; the counting kernel is cheap enough)
        while n_culled < max_cull_per_run:
            candidates = np.asarray(
                [int(k) for k in m.best_covisible(kf_id, m.n_kf, min_weight=15)
                 if k > 1 and k != kf_id and m.kf_valid[k]], np.int32)
            if len(candidates) == 0:
                return
            red, tot = redundancy_counts(candidates)
            frac = red / np.maximum(tot, 1)
            frac[tot < 20] = 0.0
            order = np.argsort(-frac)
            culled_this_round = False
            for i in order:
                k = int(candidates[i])
                if tot[i] < 20 or red[i] <= redundancy * tot[i]:
                    break   # sorted: nothing further qualifies
                if self._cull_one_keyframe(k, inertial, tr):
                    n_culled += 1
                    culled_this_round = True
                    break
            if not culled_this_round:
                return

    def _cull_one_keyframe(self, k: int, inertial: bool, tr) -> bool:
        """Apply the temporal-chain guards and remove keyframe ``k``."""
        m = self.map
        if inertial:
            valid = m.valid_kf_ids()
            pos = np.searchsorted(valid, k)
            if pos == 0 or pos >= len(valid) - 1:
                return False
            # never break the head of the temporal chain (reference
            # pKF->mnId > mnId-2 guard, src/LocalMapping.cc:1362)
            if pos >= len(valid) - 3:
                return False
            prev_k = int(valid[pos - 1])
            next_k = int(valid[pos + 1])
            gap = float(m.kf_ts[next_k] - m.kf_ts[prev_k])
            limit = 3.0 if tr.viba2_done else 0.5
            if gap > limit:
                return False
            # merge the preintegration chain across the culled keyframe
            pk = tr.kf_preints.get(k)
            pn = tr.kf_preints.get(next_k)
            if pk is not None and pn is not None:
                from ..ops import imu as imu_ops
                tr.kf_preints[next_k] = imu_ops.compose(pk, pn)
            tr.kf_preints.pop(k, None)
        if tr is not None:
            tr.reanchor_trajectory(k)
        m.remove_keyframe(k)
        self.stats["culled_kf"] = self.stats.get("culled_kf", 0) + 1
        return True

    # ------------------------------------------------------------------
    def local_ba(self, kf_id: int, iters: tuple[int, int] = (5, 10),
                 fix_all_poses: bool = False):
        """Reference LocalBundleAdjustment (src/Optimizer.cc:1858): window =
        KF + covisibles; fixed = other observers (min 2); two-phase schedule.
        The problem is gathered and written back under the map lock; the
        device solve runs on the gathered (immutable) snapshot outside it.
        ``fix_all_poses`` turns it into structure-only refinement (used as the
        landmark half of the alternating local inertial BA)."""
        m = self.map
        with m.lock:
            prob_data = self._gather_local_ba(kf_id, fix_all_poses)
        if prob_data is None:
            return
        prob, all_kfs, fixed_mask, pts, o_src_kf, o_src_feat, n_obs = prob_data
        res = self._run_ba(prob, iters)
        # ONE packed device→host pull instead of four
        Kb = int(prob.R.shape[0])
        Pb = int(prob.pts.shape[0])
        Ob = int(prob.obs_kf.shape[0])
        buf = np.asarray(kernels.ba_result_packer()(
            res.R, res.t, res.pts, res.obs_inlier))
        Rn = buf[0: Kb * 9].view(np.float32).reshape(Kb, 3, 3)[: len(all_kfs)]
        tn = buf[Kb * 9: Kb * 12].view(np.float32).reshape(Kb, 3)[: len(all_kfs)]
        ptsn = buf[Kb * 12: Kb * 12 + Pb * 3].view(np.float32).reshape(Pb, 3)
        inl = kernels.unpack_bits_host(buf[Kb * 12 + Pb * 3:], Ob)[: n_obs]
        with m.lock:
            # write back
            for i, k in enumerate(all_kfs):
                if not fixed_mask[i] and m.kf_valid[k]:
                    m.kf_R[k] = Rn[i]
                    m.kf_t[k] = tn[i]
            keep = m.mp_valid[pts]
            m.mp_xyz[pts[keep]] = ptsn[: len(pts)][keep]
            m.touch()
            # erase outlier observations (reference :2270 area); second-camera
            # rows carry src_feat = -1 and never erase the left observation
            bad = ~inl & (o_src_feat >= 0)
            if bad.any():
                m.kf_feat_mp[o_src_kf[bad], o_src_feat[bad]] = -1
        self.stats["ba_runs"] += 1

    def _gather_local_ba(self, kf_id: int, fix_all_poses: bool = False):
        m = self.map
        window = [kf_id] + [int(k) for k in m.best_covisible(kf_id, self.ba_window - 1, min_weight=15)]
        window = list(dict.fromkeys(window))
        pts = m.local_map_points(np.asarray(window, np.int32))[: self.ba_point_cap]
        if len(pts) < 20 or len(window) < 2:
            return None
        kf_idx, feat_idx = m.observations_of(pts)
        obs_mp_global = m.kf_feat_mp[kf_idx, feat_idx]
        # fixed KFs: observers outside the window (cap), else fix the oldest in window
        outside = np.setdiff1d(np.unique(kf_idx), np.asarray(window))
        fixed_kfs = [int(k) for k in outside[: self.ba_max_fixed]]
        all_kfs = window + fixed_kfs
        fixed_mask = np.zeros(len(all_kfs), bool)
        fixed_mask[len(window):] = True
        # the reference guarantees >= 2 fixed cameras (src/Optimizer.cc:1929-1964):
        # with fewer, monocular BA has a free scale gauge and LM wanders along
        # the zero-cost scale direction
        n_need = 2 - int(fixed_mask.sum())
        if n_need > 0:
            order = np.argsort([m.kf_frame_id[k] for k in all_kfs])
            for idx in order:
                if n_need == 0:
                    break
                if not fixed_mask[idx]:
                    fixed_mask[idx] = True
                    n_need -= 1
        if fix_all_poses:
            fixed_mask[:] = True

        kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
        kf_lut[np.asarray(all_kfs)] = np.arange(len(all_kfs))
        mp_lut = np.full(m.cfg.max_map_points, -1, np.int32)
        mp_lut[pts] = np.arange(len(pts))

        sel = (kf_lut[kf_idx] >= 0) & (mp_lut[obs_mp_global] >= 0)
        o_kf = kf_lut[kf_idx[sel]]
        o_mp = mp_lut[obs_mp_global[sel]]
        o_uv = m.kf_feat_xy[kf_idx[sel], feat_idx[sel]]
        o_ur = m.kf_feat_ur[kf_idx[sel], feat_idx[sel]]
        o_is2 = m.inv_level_sigma2[m.kf_feat_octave[kf_idx[sel], feat_idx[sel]]]
        o_src_kf = kf_idx[sel]
        o_src_feat = feat_idx[sel]
        o_cam = np.zeros(len(o_kf), np.int32)
        if self.rig is not None:
            # second-camera (ToBody) rows for stereo-matched features
            uvr = m.kf_feat_uvr[kf_idx[sel], feat_idx[sel]]
            has_r = uvr[:, 0] >= 0
            o_kf = np.concatenate([o_kf, o_kf[has_r]])
            o_mp = np.concatenate([o_mp, o_mp[has_r]])
            o_uv = np.concatenate([o_uv, uvr[has_r]])
            o_ur = np.concatenate([o_ur, np.full(has_r.sum(), -1.0, np.float32)])
            o_is2 = np.concatenate([o_is2, o_is2[has_r]])
            # right rows must not clear the (left) observation on outlier
            o_src_kf = np.concatenate([o_src_kf, o_src_kf[has_r]])
            o_src_feat = np.concatenate([o_src_feat,
                                         np.full(has_r.sum(), -1, np.int64)])
            o_cam = np.concatenate([o_cam, np.ones(has_r.sum(), np.int32)])

        # pad to static buckets
        Kb = self._bucket(len(all_kfs), [4, 8, 12, 16, 24, 32])
        Pb = self._bucket(len(pts), [256, 512, 1024, 2048, 4096])
        Ob = self._bucket(len(o_kf), [1024, 2048, 4096, 8192, 16384, 32768])
        if Kb is None or Pb is None or Ob is None:
            return None

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        eye_pad = np.zeros((Kb, 3, 3), np.float32)
        eye_pad[:] = np.eye(3)
        eye_pad[: len(all_kfs)] = m.kf_R[all_kfs]
        prob = ba_ops.BAProblem(
            R=jnp.asarray(eye_pad),
            t=jnp.asarray(pad(m.kf_t[all_kfs], Kb)),
            pts=jnp.asarray(pad(m.mp_xyz[pts], Pb)),
            obs_kf=jnp.asarray(pad(o_kf.astype(np.int32), Ob)),
            obs_mp=jnp.asarray(pad(o_mp.astype(np.int32), Ob)),
            obs_uv=jnp.asarray(pad(o_uv.astype(np.float32), Ob)),
            obs_inv_sigma2=jnp.asarray(pad(o_is2.astype(np.float32), Ob, 1.0)),
            obs_valid=jnp.asarray(pad(np.ones(len(o_kf), bool), Ob, False)),
            fixed_pose=jnp.asarray(pad(fixed_mask, Kb, True)),
            obs_ur=jnp.asarray(pad(o_ur.astype(np.float32), Ob, -1.0)),
            bf=jnp.asarray(self.bf, jnp.float32),
            **self._rig_fields(o_cam, Ob),
        )
        return prob, all_kfs, fixed_mask, pts, o_src_kf, o_src_feat, len(o_kf)

    def _rig_fields(self, o_cam, Ob):
        """Second-camera BAProblem fields (empty for single-camera rigs)."""
        if self.rig is None:
            return {}
        out = np.zeros(Ob, np.int32)
        out[: len(o_cam)] = o_cam
        return dict(
            obs_cam=jnp.asarray(out),
            cam_params2=jnp.asarray(self.rig["cam_r"], jnp.float32),
            R_rl=jnp.asarray(self.rig["R_rl"], jnp.float32),
            t_rl=jnp.asarray(self.rig["t_rl"], jnp.float32),
        )

    def global_ba(self, iters: tuple[int, int] = (4, 6), abort_check=None,
                  propagate: bool = False) -> bool:
        """Full-map BA (reference GlobalBundleAdjustemnt, 10 iterations at loop
        closure, src/LoopClosing.cc:2598). Runs in bounded device chunks so a
        background runner can abort between them (the reference's mbStopGBA
        polled per g2o iteration); with ``propagate=True``, keyframes and map
        points created while the BA ran are corrected through their
        reference keyframe (the reference's spanning-tree propagation,
        src/LoopClosing.cc:2640-2830). Returns True if results were applied."""
        m = self.map
        with m.lock:
            kfs = [int(k) for k in m.valid_kf_ids()]
            if len(kfs) < 3:
                return False
            snap_epoch = m.remap_epoch
            snap_n_kf = m.n_kf
            snap_n_mp = m.n_mp
            old_R = m.kf_R.copy()
            old_t = m.kf_t.copy()
            pts = m.valid_mp_ids()[: self.ba_point_cap]
            kf_idx, feat_idx = m.observations_of(pts)
            obs_mp_global = m.kf_feat_mp[kf_idx, feat_idx]
            kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
            kf_lut[np.asarray(kfs)] = np.arange(len(kfs))
            mp_lut = np.full(m.cfg.max_map_points, -1, np.int32)
            mp_lut[pts] = np.arange(len(pts))
            sel = (kf_lut[kf_idx] >= 0) & (mp_lut[obs_mp_global] >= 0)
            o_kf = kf_lut[kf_idx[sel]]
            o_mp = mp_lut[obs_mp_global[sel]]
            o_uv = m.kf_feat_xy[kf_idx[sel], feat_idx[sel]]
            o_ur = m.kf_feat_ur[kf_idx[sel], feat_idx[sel]]
            o_is2 = m.inv_level_sigma2[m.kf_feat_octave[kf_idx[sel], feat_idx[sel]]]
            o_cam = np.zeros(len(o_kf), np.int32)
            if self.rig is not None:
                uvr = m.kf_feat_uvr[kf_idx[sel], feat_idx[sel]]
                has_r = uvr[:, 0] >= 0
                o_kf = np.concatenate([o_kf, o_kf[has_r]])
                o_mp = np.concatenate([o_mp, o_mp[has_r]])
                o_uv = np.concatenate([o_uv, uvr[has_r]])
                o_ur = np.concatenate([o_ur,
                                       np.full(has_r.sum(), -1.0, np.float32)])
                o_is2 = np.concatenate([o_is2, o_is2[has_r]])
                o_cam = np.concatenate([o_cam,
                                        np.ones(has_r.sum(), np.int32)])

        Kb = self._bucket(len(kfs), [16, 32, 64, 96, 128, 192, 256, 384, 512])
        Pb = self._bucket(len(pts), [1024, 2048, 4096])
        Ob = self._bucket(len(o_kf), [4096, 8192, 16384, 32768, 65536])
        if Kb is None or Pb is None or Ob is None:
            return False

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        eye_pad = np.zeros((Kb, 3, 3), np.float32)
        eye_pad[:] = np.eye(3)
        eye_pad[: len(kfs)] = old_R[kfs]
        fixed_mask = np.zeros(len(kfs), bool)
        fixed_mask[:2] = True
        prob = ba_ops.BAProblem(
            R=jnp.asarray(eye_pad),
            t=jnp.asarray(pad(old_t[kfs], Kb)),
            pts=jnp.asarray(pad(m.mp_xyz[pts], Pb)),
            obs_kf=jnp.asarray(pad(o_kf.astype(np.int32), Ob)),
            obs_mp=jnp.asarray(pad(o_mp.astype(np.int32), Ob)),
            obs_uv=jnp.asarray(pad(o_uv.astype(np.float32), Ob)),
            obs_inv_sigma2=jnp.asarray(pad(o_is2.astype(np.float32), Ob, 1.0)),
            obs_valid=jnp.asarray(pad(np.ones(len(o_kf), bool), Ob, False)),
            fixed_pose=jnp.asarray(pad(fixed_mask, Kb, True)),
            obs_ur=jnp.asarray(pad(o_ur.astype(np.float32), Ob, -1.0)),
            bf=jnp.asarray(self.bf, jnp.float32),
            **self._rig_fields(o_cam, Ob),
        )
        # phase 1 (outlier classification happens inside), then phase 2 in
        # abortable chunks of 2 LM iterations
        if abort_check is not None and abort_check():
            return False
        # multi-chip backend: above a size threshold on a multi-device mesh,
        # the landmark-sharded full-LM solve (parallel/sharded_ba) replaces
        # the single-device path — one psum-reduced Schur step per iteration
        # (SURVEY §5.8; abort granularity becomes the whole solve)
        sharded = self._try_sharded_global_ba(
            kfs, pts, o_kf, o_mp, o_uv, o_is2, old_R, old_t, fixed_mask, iters)
        if sharded is not None:
            res = sharded
            prob = prob._replace(R=res.R, t=res.t, pts=res.pts)
            # fall through to write-back with the sharded result
            done = iters[1]
        else:
            res = self._run_ba(prob, (iters[0], 0))
            prob = prob._replace(R=res.R, t=res.t, pts=res.pts,
                                 obs_valid=prob.obs_valid & res.obs_inlier)
            done = 0
        while done < iters[1]:
            if abort_check is not None and abort_check():
                return False
            res = self._run_ba(prob, (2, 0))
            prob = prob._replace(R=res.R, t=res.t, pts=res.pts)
            done += 2

        with m.lock:
            if m.remap_epoch != snap_epoch:
                # pools were compacted while the solve ran: the gathered ids
                # are stale — drop the result (a later GBA redoes the work)
                return False
            Rn = np.asarray(res.R)[: len(kfs)]
            tn = np.asarray(res.t)[: len(kfs)]
            for i, k in enumerate(kfs):
                if not fixed_mask[i] and m.kf_valid[k]:
                    m.kf_R[k] = Rn[i]
                    m.kf_t[k] = tn[i]
            in_ba = np.zeros(m.cfg.max_map_points, bool)
            keep = m.mp_valid[pts]
            m.mp_xyz[pts[keep]] = np.asarray(res.pts)[: len(pts)][keep]
            m.touch()
            in_ba[pts[keep]] = True
            if propagate:
                # keyframes created during the run: T_k_new = T_k_old ∘
                # (T_a_old⁻¹ ∘ T_a_new) with anchor a = each keyframe's own
                # most-covisible snapshot keyframe — the framework's
                # equivalent of the reference's spanning-tree parent walk
                # (src/LoopClosing.cc:2640-2830: mTcwBefGBA of the parent);
                # a single global anchor would misplace keyframes far from
                # it after a large loop correction. Pre-correction poses are
                # captured before overwriting so the map-point re-anchoring
                # below uses the right "old" pose.
                in_snap = np.zeros(m.cfg.max_keyframes, bool)
                in_snap[np.asarray(kfs)] = True
                Ra_rel = old_R[kfs[-1]].T @ m.kf_R[kfs[-1]]
                ta_rel = old_R[kfs[-1]].T @ (m.kf_t[kfs[-1]] - old_t[kfs[-1]])
                for k in range(snap_n_kf, m.n_kf):
                    old_R[k] = m.kf_R[k]
                    old_t[k] = m.kf_t[k]
                    if not m.kf_valid[k]:
                        continue
                    # anchor = spanning-tree parent when it was in the GBA
                    # snapshot (reference walks mpParent's mTcwBefGBA,
                    # src/LoopClosing.cc:2640-2830), else most covisible
                    pa = int(m.kf_parent[k])
                    if 0 <= pa < len(in_snap) and in_snap[pa] and m.kf_valid[pa]:
                        a = pa
                    else:
                        w = m.covisibility_row(k)
                        w[~in_snap[: len(w)]] = 0
                        a = int(np.argmax(w)) if w.max() > 0 else kfs[-1]
                    Ra_rel = old_R[a].T @ m.kf_R[a]
                    ta_rel = old_R[a].T @ (m.kf_t[a] - old_t[a])
                    m.kf_R[k] = (old_R[k] @ Ra_rel).astype(np.float32)
                    m.kf_t[k] = (old_R[k] @ ta_rel + old_t[k]).astype(np.float32)
                # map points not directly solved: re-anchor through their
                # reference KF (x stays fixed in the ref-KF camera frame)
                all_mp = m.valid_mp_ids()
                rest = all_mp[~in_ba[all_mp]]
                if len(rest):
                    ref = np.clip(m.mp_ref_kf[rest], 0, m.cfg.max_keyframes - 1)
                    x = m.mp_xyz[rest]
                    x_cam = np.einsum("nij,nj->ni", old_R[ref], x) + old_t[ref]
                    newR = m.kf_R[ref]
                    newt = m.kf_t[ref]
                    x_new = np.einsum("nij,nj->ni",
                                      newR.transpose(0, 2, 1), x_cam - newt)
                    m.mp_xyz[rest] = x_new.astype(np.float32)
                    m.touch()
                # expose the anchor correction for the tracker's live frame
                if self.on_poses_corrected is not None:
                    self.on_poses_corrected(Ra_rel.astype(np.float32),
                                            ta_rel.astype(np.float32))
        self.stats["gba_runs"] = self.stats.get("gba_runs", 0) + 1
        return True

    def _try_sharded_global_ba(self, kfs, pts, o_kf, o_mp, o_uv, o_is2,
                               old_R, old_t, fixed_mask, iters,
                               min_kfs: int = 64):
        """Distributed full-LM global BA over a landmark-sharded device mesh
        (parallel/sharded_ba.make_sharded_ba_solver). Returns a BAResult-like
        object, or None when a single device / small problem makes the
        single-chip path the right one. Second-camera rigs fall back (the
        sharded kernel carries mono rows only for now)."""
        import jax
        if (jax.device_count() < 2 or len(kfs) < min_kfs
                or self.rig is not None):
            return None
        import jax.numpy as jnp
        from ..parallel import sharded_ba as sb
        from ..ops.ba import BAResult
        mesh = sb.make_mesh()
        n_sh = len(mesh.devices.reshape(-1))
        n_pts_pad, o_per, out_mp, out_valid, outs = sb.partition_by_landmark(
            o_mp.astype(np.int64), len(pts), n_sh,
            {"kf": o_kf.astype(np.int32), "uv": o_uv.astype(np.float32),
             "w": o_is2.astype(np.float32)})
        pts_pad = np.zeros((n_pts_pad, 3), np.float32)
        pts_pad[: len(pts)] = self.map.mp_xyz[pts]
        K = len(kfs)
        solver = sb.make_sharded_ba_solver(
            mesh, n_kf=K, cam_type=self.cam_type,
            iters1=iters[0], iters2=iters[1])
        Rn, tn, ptsn, inl = solver(
            jnp.asarray(old_R[kfs]), jnp.asarray(old_t[kfs]),
            jnp.asarray(fixed_mask),
            jnp.asarray(pts_pad), jnp.asarray(outs["kf"]),
            jnp.asarray(out_mp), jnp.asarray(outs["uv"]),
            jnp.asarray(outs["w"] * out_valid),
            jnp.asarray(self.K))
        self.stats["sharded_gba_runs"] = (
            self.stats.get("sharded_gba_runs", 0) + 1)
        # map the shard-ordered inliers back: observations were re-ordered,
        # so outlier erasure is skipped on this path (the next local BA
        # reclassifies) — report all-inlier
        O = len(o_kf)
        return BAResult(
            R=jnp.asarray(np.asarray(Rn)), t=jnp.asarray(np.asarray(tn)),
            pts=jnp.asarray(np.asarray(ptsn)[: len(pts)]),
            obs_inlier=jnp.ones(O, bool),
            chi2=jnp.asarray(0.0), n_inlier=jnp.asarray(O))

    # ------------------------------------------------------------------
    # inertial
    # ------------------------------------------------------------------
    def _inertial_stage(self, kf_id: int):
        """IMU initialization staging (reference src/LocalMapping.cc:211-288):
        InitializeIMU with strong priors → VIBA1 at mTinit>5 s (priors 1, 1e5)
        → VIBA2 at >15 s (priors 0, 0) → scale-refinement windows every ~10 s
        until the map has 100 keyframes (mono only)."""
        tr = self.inertial
        m = self.map
        if not tr.imu_enabled:
            return
        if not tr.imu_initialized:
            if tr.try_imu_init():
                # the reference's InitializeIMU does not stop at the MAP
                # estimate: it runs FullInertialBA(100) on the freshly
                # aligned map (src/LocalMapping.cc:1720). The joint BA is
                # ALSO the scale estimator here: measured on the synthetic
                # VI fixture it recovers a 0.43x init-scale error to ~0.88
                # by 30 iterations (16 was not converged)
                self.full_inertial_ba(kf_id, iters=30,
                                      prior_g=1e2,
                                      prior_a=1e10 if self.bf <= 0 else 1e5)
            return
        ts = float(m.kf_ts[kf_id])
        tinit = ts - tr.imu_init_ts
        # bad-IMU detection (reference src/LocalMapping.cc:155-172): within
        # 10 s of IMU init and before VIBA2, near-zero travel over the last
        # three keyframes means the init was under-excited and the scale/
        # biases are garbage — reset the active map (src/Tracking.cc:1805)
        valid = m.valid_kf_ids()
        if (not tr.viba2_done and tinit < 10.0 and len(valid) >= 3
                and self.on_bad_imu is not None):
            k0, k1, k2 = (int(valid[-3]), int(valid[-2]), int(valid[-1]))
            c = [-m.kf_R[k].T @ m.kf_t[k] for k in (k0, k1, k2)]
            dist = (float(np.linalg.norm(c[2] - c[1]))
                    + float(np.linalg.norm(c[1] - c[0])))
            if dist < 0.02:
                self.stats["bad_imu_resets"] = (
                    self.stats.get("bad_imu_resets", 0) + 1)
                self.on_bad_imu()
                return
        # VIBA1/VIBA2 are FullInertialBA passes with annealed bias priors
        # (reference src/LocalMapping.cc:244-273 call InitializeIMU which
        # lands in FullInertialBA; the round-1 inertial-only MAP refit is
        # gone — its scale estimate attenuates toward zero under visual
        # noise and UNDID the joint BA's scale recovery, measured 0.88→0.62)
        if not tr.viba1_done and tinit > 5.0:
            self.full_inertial_ba(kf_id, iters=12, prior_g=1.0, prior_a=1e5)
            self.stats["viba1"] = 1
            tr.viba1_done = True
        elif not tr.viba2_done and tinit > 15.0:
            self.full_inertial_ba(kf_id, iters=12, prior_g=0.0, prior_a=0.0)
            self.stats["viba2"] = 1
            tr.viba2_done = True
        elif (self.bf <= 0 and tr.viba2_done and m.n_kf <= 100
              and ts - max(tr.imu_init_ts + 15.0, tr.last_scale_refine_ts) > 10.0):
            # scale-refinement windows (reference :277-288): another joint
            # pass over the whole map
            tr.last_scale_refine_ts = ts
            self.full_inertial_ba(kf_id, iters=8, prior_g=1e2, prior_a=1e5)
            self.stats["scale_refines"] = self.stats.get("scale_refines", 0) + 1

    def local_inertial_ba(self, kf_id: int, iters: int = 8):
        """Local inertial BA (reference LocalInertialBA src/Optimizer.cc:4314:
        temporal window of 10 keyframes linked by mPrevKF preintegration edges
        + visual edges, boundary fixed) as ONE joint landmark+pose/velocity/
        bias Schur solve (ops/vi_ba.vi_joint_ba) — the round-1 alternating
        block-coordinate scheme is gone."""
        self._run_vi_joint(kf_id, window=self.vi_window, iters=iters,
                           fix_vel_bias_of_fixed=True)

    def full_inertial_ba(self, kf_id: int, iters: int = 12,
                         prior_g: float = 1e2, prior_a: float = 1e5,
                         abort_check=None):
        """Whole-map joint inertial BA (reference FullInertialBA
        src/Optimizer.cc:495 — 100 iterations at IMU initialization,
        src/LocalMapping.cc:1720, and 7 at inertial loop-closure GBA,
        src/LoopClosing.cc:2601). Window = every valid keyframe; only the
        first pose is fixed; bias priors follow the bInit path.

        ``abort_check`` mirrors the reference's pbStopFlag (honored by
        FullInertialBA, src/LoopClosing.cc:2601): checked before dispatch and
        before write-back so a pending loop correction isn't blocked behind
        the whole-map solve (advisor r4 medium)."""
        m = self.map
        n = len(m.valid_kf_ids())
        self._run_vi_joint(kf_id, window=n, iters=iters,
                           fix_vel_bias_of_fixed=False,
                           prior_g=prior_g, prior_a=prior_a,
                           abort_check=abort_check)
        # a whole-map inertial solve can rescale/re-gravity the world: any
        # pipelined tracking dispatch in flight was predicted in the old
        # world and must be dropped at consume (Tracker.world_epoch guard)
        if self.inertial is not None:
            self.inertial.world_epoch += 1

    def _run_vi_joint(self, kf_id: int, window: int, iters: int,
                      fix_vel_bias_of_fixed: bool,
                      prior_g: float = 0.0, prior_a: float = 0.0,
                      abort_check=None):
        from ..ops import vi_ba as vi_ops
        import functools
        import jax
        tr = self.inertial
        m = self.map
        with m.lock:
            snap_epoch = m.remap_epoch
            data = self._gather_vi_joint(kf_id, window)
        if data is None:
            return
        (win, n_win, pts, o_src_kf, o_src_feat, n_obs, args) = data
        key = (args["R0"].shape[0], args["obs_uv"].shape[0],
               args["pts0"].shape[0], iters, fix_vel_bias_of_fixed,
               bool(prior_g), bool(prior_a))
        if key not in self._vi_jit:
            self._vi_jit[key] = jax.jit(functools.partial(
                vi_ops.vi_joint_ba, cam_type=self.cam_type, iters=iters,
                prior_g=prior_g, prior_a=prior_a,
                fix_vel_bias_of_fixed=fix_vel_bias_of_fixed))
        if abort_check is not None and abort_check():
            return
        res = self._vi_jit[key](**args)
        Rn = np.asarray(res.R)
        tn = np.asarray(res.t)
        vn = np.asarray(res.vels)
        bgn = np.asarray(res.bg)
        ban = np.asarray(res.ba)
        ptsn = np.asarray(res.pts)
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()
                and np.isfinite(ptsn).all()):
            return
        if abort_check is not None and abort_check():
            # aborted while the solve ran: skip write-back entirely so the
            # loop correction sees a consistent (pre-GBA) map
            return
        fixed = np.asarray(args["fixed_pose"])
        with m.lock:
            if m.remap_epoch != snap_epoch:
                # pools compacted while the solve ran (possible when invoked
                # from the background GBA thread): gathered ids are stale
                return
            for i, k in enumerate(win):
                if i >= n_win or fixed[i] or not m.kf_valid[k]:
                    continue
                m.kf_R[k] = Rn[i]
                m.kf_t[k] = tn[i]
                m.kf_vel[k] = vn[i]
                if np.isfinite(bgn[i]).all() and np.isfinite(ban[i]).all():
                    m.kf_bias_g[k] = bgn[i]
                    m.kf_bias_a[k] = ban[i]
            keep = m.mp_valid[pts]
            m.mp_xyz[pts[keep]] = ptsn[: len(pts)][keep]
            m.touch()
            # the tracker predicts with the LAST keyframe's bias (reference
            # mpLastKeyFrame->GetImuBias())
            last = win[n_win - 1]
            if np.isfinite(bgn[n_win - 1]).all():
                tr.imu_bias_g = bgn[n_win - 1].astype(np.float32)
                tr.imu_bias_a = ban[n_win - 1].astype(np.float32)
            # erase outlier observations
            inl = np.asarray(res.obs_inlier)[: n_obs]
            bad = ~inl & (o_src_feat >= 0)
            if bad.any():
                m.kf_feat_mp[o_src_kf[bad], o_src_feat[bad]] = -1
        self.stats["vi_ba_runs"] = self.stats.get("vi_ba_runs", 0) + 1

    def _gather_vi_joint(self, kf_id: int, window: int):
        """Gather the temporal window, preintegration chain, landmarks and
        visual observations for the joint inertial BA."""
        import jax.numpy as jnp
        from ..ops import imu as imu_ops
        tr = self.inertial
        m = self.map
        kfs = [int(k) for k in m.valid_kf_ids() if k <= kf_id]
        win = kfs[-window:]
        n_win = len(win)
        if n_win < 3:
            return None
        Kb = self._bucket(n_win, [5, 10, 15, 25, 50, 100, 200, 400])
        if Kb is None:
            win = win[-400:]
            n_win = len(win)
            Kb = 400
        # preintegration chain (pair i connects win[i] → win[i+1])
        zero = imu_ops.init_state()
        pre, pair_ok = [], []
        for i in range(1, n_win):
            k = win[i]
            p = tr.kf_preints.get(k)
            dt_kf = float(m.kf_ts[k] - m.kf_ts[win[i - 1]])
            if p is not None and abs(float(p.dT) - dt_kf) < 0.02:
                pre.append(p)
                pair_ok.append(True)
            else:
                pre.append(zero)
                pair_ok.append(False)
        if not any(pair_ok):
            return None
        while len(pre) < Kb - 1:
            pre.append(zero)
            pair_ok.append(False)

        # landmarks observed by the window
        pts = m.local_map_points(np.asarray(win, np.int32))[: self.ba_point_cap]
        if len(pts) < 20:
            return None
        kf_idx, feat_idx = m.observations_of(pts)
        obs_mp_global = m.kf_feat_mp[kf_idx, feat_idx]
        kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
        kf_lut[np.asarray(win)] = np.arange(n_win)
        mp_lut = np.full(m.cfg.max_map_points, -1, np.int32)
        mp_lut[pts] = np.arange(len(pts))
        sel = (kf_lut[kf_idx] >= 0) & (mp_lut[obs_mp_global] >= 0)
        o_kf = kf_lut[kf_idx[sel]]
        o_mp = mp_lut[obs_mp_global[sel]]
        o_uv = m.kf_feat_xy[kf_idx[sel], feat_idx[sel]]
        o_ur = m.kf_feat_ur[kf_idx[sel], feat_idx[sel]]
        o_is2 = m.inv_level_sigma2[m.kf_feat_octave[kf_idx[sel], feat_idx[sel]]]
        o_src_kf = kf_idx[sel]
        o_src_feat = feat_idx[sel]
        Pb = self._bucket(len(pts), [256, 512, 1024, 2048, 4096])
        Ob = self._bucket(len(o_kf), [1024, 2048, 4096, 8192, 16384, 32768])
        if Pb is None or Ob is None:
            return None

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        eye_pad = np.tile(np.eye(3, dtype=np.float32), (Kb, 1, 1))
        eye_pad[:n_win] = m.kf_R[win]
        fixed = np.ones(Kb, bool)
        fixed[1:n_win] = False
        fixed[0] = True
        stack9 = lambda attr: jnp.asarray(np.stack(
            [np.asarray(getattr(s, attr), np.float32) for s in pre]))
        cov = jnp.asarray(np.stack(
            [np.asarray(s.C, np.float32)[:9, :9] for s in pre]))
        args = dict(
            R0=jnp.asarray(eye_pad),
            t0=jnp.asarray(pad(m.kf_t[win], Kb)),
            vels0=jnp.asarray(pad(m.kf_vel[win], Kb)),
            bg0=jnp.asarray(pad(m.kf_bias_g[win], Kb)),
            ba0=jnp.asarray(pad(m.kf_bias_a[win], Kb)),
            fixed_pose=jnp.asarray(fixed),
            pts0=jnp.asarray(pad(m.mp_xyz[pts], Pb)),
            obs_kf=jnp.asarray(pad(o_kf.astype(np.int32), Ob)),
            obs_mp=jnp.asarray(pad(o_mp.astype(np.int32), Ob)),
            obs_uv=jnp.asarray(pad(o_uv.astype(np.float32), Ob)),
            obs_ur=jnp.asarray(pad(o_ur.astype(np.float32), Ob, -1.0)),
            obs_inv_sigma2=jnp.asarray(pad(o_is2.astype(np.float32), Ob, 1.0)),
            obs_valid=jnp.asarray(pad(np.ones(len(o_kf), bool), Ob, False)),
            bf=jnp.asarray(self.bf, jnp.float32),
            dT=stack9("dT"), dR=stack9("dR"), dV=stack9("dV"), dP=stack9("dP"),
            JRg=stack9("JRg"), JVg=stack9("JVg"), JVa=stack9("JVa"),
            JPg=stack9("JPg"), JPa=stack9("JPa"),
            pre_cov=cov,
            pair_valid=jnp.asarray(np.asarray(pair_ok)),
            cam_params=jnp.asarray(
                self.inertial.cam_params if hasattr(self.inertial, "cam_params")
                else self.K),
        )
        return (np.asarray(win, np.int64), n_win, pts, o_src_kf, o_src_feat,
                len(o_kf), args)

    def _run_ba(self, prob, iters):
        chunk = int(getattr(self, "ba_chunk", 0) or 0)
        if chunk <= 0:
            if self._ba_jit is None:
                import functools
                import jax
                self._ba_jit = jax.jit(
                    functools.partial(ba_ops.local_ba, cam_type=self.cam_type,
                                      chi2_th=ba_ops.CHI2_MONO),
                    static_argnames=("iters1", "iters2"))
            return self._ba_jit(prob, jnp.asarray(self.K),
                                iters1=iters[0], iters2=iters[1])
        return self._run_ba_chunked(prob, iters, chunk)

    def _run_ba_chunked(self, prob, iters, chunk):
        """Cooperative-yield local BA: same two-phase LM schedule, issued as
        several short device dispatches with the state carried ON DEVICE
        between them (no extra host pulls). On a single chip all kernels
        share one in-order execution queue, so a monolithic 15-iteration BA
        dispatch makes concurrent tracking frames wait out its whole
        runtime; chunking lets tracker kernels interleave between chunks —
        the dispatch-queue analogue of the reference's mbAbortBA preemption
        (src/LocalMapping.cc:184-185). Each chunk re-linearizes once at
        entry (one extra linearization per chunk ≈ 1/chunk overhead) and
        restarts LM damping at 1e-4 — measured no accuracy change on the
        e2e fixtures."""
        import functools
        import jax
        if not hasattr(self, "_ba_chunk_jit"):
            self._ba_chunk_jit = jax.jit(
                functools.partial(ba_ops.ba_iterate, cam_type=self.cam_type,
                                  huber_chi2=ba_ops.CHI2_MONO),
                static_argnames=("n_iters",))
            self._ba_classify_jit = jax.jit(
                functools.partial(ba_ops.classify_inliers,
                                  cam_type=self.cam_type,
                                  chi2_th=ba_ops.CHI2_MONO))
        Kd = jnp.asarray(self.K)
        p = prob
        inlier = jnp.ones(p.obs_kf.shape[0], bool)
        chi2 = None
        for phase_iters in iters:
            done = 0
            while done < int(phase_iters):
                n = min(chunk, int(phase_iters) - done)
                R, t, pts = self._ba_chunk_jit(p, n_iters=n, inlier=inlier,
                                               cam_params=Kd)
                p = p._replace(R=R, t=t, pts=pts)
                done += n
            if phase_iters:
                inlier, chi2 = self._ba_classify_jit(p, Kd)
        if chi2 is None:
            inlier, chi2 = self._ba_classify_jit(p, Kd)
        return ba_ops.BAResult(
            R=p.R, t=p.t, pts=p.pts, obs_inlier=inlier,
            chi2=jnp.sum(jnp.where(inlier, chi2, 0.0)),
            n_inlier=jnp.sum(inlier.astype(jnp.int32)))

    @staticmethod
    def _bucket(n: int, buckets):
        for b in buckets:
            if n <= b:
                return b
        return None
