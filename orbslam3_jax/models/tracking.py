"""Tracking front end: the per-frame state machine.

Rebuilds the reference ``Tracking`` (reference src/Tracking.cc:1794-2479
``Track()`` with states NOT_INITIALIZED / OK / RECENTLY_LOST / LOST,
include/Tracking.h:107-115) as a host-side driver over jitted kernels:

- Monocular initialization (reference MonocularInitialization :2621 →
  two-view H/F RANSAC → CreateInitialMapMonocular :2744 with GBA(20) and
  median-depth scale normalization).
- TrackWithMotionModel (:3173): constant-velocity prediction + projection
  matching (radius 15 px mono, x2 retry) + pose-only LM.
- TrackReferenceKeyFrame (:2994): descriptor matching to the reference KF
  (ratio 0.7) + pose-only LM.
- TrackLocalMap (:3296): covisibility-expanded local map, fused frustum +
  projection matching, pose-only LM, inlier gates.
- Keyframe policy (NeedNewKeyFrame :3468, simplified to the dominant c1a/c2
  conditions) and trajectory bookkeeping relative to reference keyframes
  (include/Tracking.h:138-141) so export benefits from later BA corrections.

Device work is batched and fixed-shape; the state machine itself is plain
Python (the reference's data-dependent control flow stays on host by design).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np
import jax.numpy as jnp

from ..ops import features as feat_ops
from ..ops import lie
from ..utils.timing import StageTimer
from . import kernels
from .frame import Frame, build_frame
from .map import MapConfig, MapState, locked_current


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


@dataclass
class TrackingParams:
    # matching radii / ratios (reference values, SURVEY A.2; motion radius
    # tightened from the reference's 15 — with all-pairs matching the larger
    # window admits sibling-corner mismatches that cost accuracy)
    motion_radius: float = 8.0
    local_radius: float = 3.0
    motion_ratio: float = 0.9
    refkf_ratio: float = 0.7
    local_ratio: float = 0.8
    th_high: int = 100
    th_low: int = 50
    # gates
    min_motion_matches: int = 20
    min_motion_inliers: int = 10
    min_local_inliers: int = 30
    min_init_matches: int = 100
    # keyframe policy (reference NeedNewKeyFrame src/Tracking.cc:3468-3643:
    # mMinFrames=0, mMaxFrames=fps — set max_frames_between_kf to the camera
    # rate; the c1b/c2 conditions drive the actual insertion density)
    max_frames_between_kf: int = 20     # = fps (EuRoC 20 fps)
    min_frames_between_kf: int = 0
    ref_ratio: float = 0.9              # mono (reference :3551-3569)
    # >0 replaces the c1 cadence with a fixed frame interval (c2 still ORs
    # in). For synthetic fixtures whose per-frame motion is far larger than a
    # real camera's — the reference's c2 fires on real-image feature churn
    # that renderers don't produce. 0 = reference policy.
    kf_interval_override: int = 0
    # local map sizes
    max_local_kfs: int = 20
    max_local_mps: int = 4096
    # TrackLocalMap match→optimize passes (re-match at the refined pose).
    # >1 and pose_starts>1 are optional robustifications (batched on device);
    # multi-seed sweeps (scripts/sweep_tracking.py) show no consistent win on
    # the synthetic fixtures, so the defaults stay at the reference's shape.
    local_passes: int = 1
    # multi-start pose optimization (1 = single start; >1 = batched LM from
    # depth-axis-perturbed starts, winner by robust cost)
    pose_starts: int = 1
    # minimum predicted image motion (px, rotational+translational) for the
    # motion model to extrapolate the pose; below it the frame starts at the
    # last pose (see Tracker._predict_pose). 0 disables anchoring.
    cv_predict_min_px: float = 6.0
    # weak last-pose prior in pose LM: per-block information = eps·tr(H)/3.
    # Floors the curvature of near-null pose directions (frontal-plane scenes)
    # so a motion-model seed cannot random-walk down them; negligible along
    # observed directions. 0 disables. (ops/pose_opt.py docstring.)
    pose_prior_eps: float = 3e-4
    # RECENTLY_LOST dead-reckoning window with an initialized IMU (reference
    # time_recently_lost = 5 s, src/Tracking.cc:2044)
    time_recently_lost: float = 5.0
    # software-pipelined tracking: the fused result of frame N is consumed at
    # the start of call N+1, overlapping its device→host transfer with the
    # next frame's extraction (the transfer otherwise serializes with it; sync
    # against pipelined has not been measured on the GPU). Info
    # returned by track_* then describes the most recently FINALIZED frame
    # and keyframe insertion lags one frame. Visual-only paths.
    pipeline: bool = False
    # in-flight frame budget: 1 = consume the previous frame's result at the
    # next call (its transfer overlaps one extraction); 2 = consume two calls
    # later — the transfer leaves the critical path entirely, at the
    # cost of candidate sets and keyframe insertion lagging two frames (the
    # constant-velocity prediction extrapolates the extra step and the
    # matching window widens accordingly)
    pipeline_depth: int = 1
    # --- adaptive-gate toggles (scripts/gate_ablation.py; VERDICT r4 Weak
    # #7: every empirically-tuned gate must be individually ablatable so a
    # gate tuned on one fixture can be checked against the whole matrix) ---
    # aliasing-divergence gate: reject a frame whose motion-model evidence
    # n1 collapsed relative to its local-map inliers (tracking._track /
    # _fused_consume; no reference counterpart)
    gate_divergence: bool = True
    # adaptive EMA collapse floor in _min_local_inliers (20% of the running
    # inlier average; reference uses only absolute thresholds :3421-3454)
    gate_ema_floor: bool = True
    # split-sample scale-consistency check in monocular init
    # (_monocular_init; no reference counterpart)
    gate_init_split: bool = True
    # anchored prediction + last-pose prior health gate (_predict_pose /
    # _last_track_healthy; pose_prior_eps=0 disables the prior itself)
    gate_anchor: bool = True


class Tracker:
    def __init__(self, K: np.ndarray, D: np.ndarray | None, wh: tuple[int, int],
                 orb_cfg: feat_ops.OrbConfig, map_state: MapState,
                 params: TrackingParams | None = None, seed: int = 0,
                 bf: float = 0.0, th_depth: float = 0.0,
                 cam_type: int = 0):
        # cam_type: 0 = pinhole (K = fx fy cx cy, D = radtan), 1 = Kannala-
        # Brandt-8 fisheye (K = fx fy cx cy k0..k3, keypoints kept raw —
        # the reference projects through the model everywhere,
        # include/CameraModels/KannalaBrandt8.h)
        self.cam_type = int(cam_type)
        self.cam_params = np.asarray(K, np.float32)
        self.K = np.asarray(K, np.float32)[:4]
        self.D = None if (D is None or cam_type != 0) else np.asarray(D, np.float32)
        self.wh = np.asarray(wh, np.float32)
        self.orb_cfg = orb_cfg
        self._map = map_state
        self.p = params or TrackingParams()
        self.rng = np.random.default_rng(seed)
        self.current_frame: Frame | None = None
        # stereo: bf = baseline*fx; th_depth = close/far point threshold
        # (reference ThDepth, typically 35..40 x baseline)
        self.bf = float(bf)
        self.th_depth = float(th_depth)
        # two-camera fisheye rig (reference Camera2.* + Tlr; set_fisheye_rig)
        self.rig = None
        # localization-only mode (reference mbOnlyTracking,
        # System::ActivateLocalizationMode src/System.cc:382): track against
        # the frozen map, never spawn keyframes
        self.only_tracking = False

        self.state = TrackState.NOT_INITIALIZED
        # undistortion runs inside the extractor dispatch (pinhole only; KB8
        # keypoints stay raw, matching the reference which projects through
        # the model everywhere)
        self.extract = feat_ops.make_extractor(
            int(wh[1]), int(wh[0]), orb_cfg,
            K=self.K if self.cam_type == 0 else None, D=self.D)
        self.match_init = kernels.init_matcher()
        self.two_view = kernels.two_view_kernel(sigma_n=1.0 / float(self.K[0]))
        self.pose_opt = kernels.pose_opt_kernel(
            cam_type=self.cam_type, n_starts=self.p.pose_starts)
        self.proj_match = kernels.projection_matcher(
            self.cam_type, orb_cfg.n_levels, orb_cfg.scale)
        # device-resident map mirror + packed-I/O pooled kernels: the
        # per-frame path uploads only an id list + pose and downloads one
        # packed buffer (see models/device_map.py and models/kernels.py)
        from .device_map import mirror_for
        self._mirror_for = mirror_for
        self._cam_key = tuple(float(v) for v in self.cam_params)
        self._wh_key = (float(wh[0]), float(wh[1]))
        depth = max(1, int(getattr(self.p, "pipeline_depth", 1)))
        r_scale = 1.0 + 0.5 * (depth - 1)
        self.fused_track = kernels.fused_track_pooled(
            self.cam_type, orb_cfg.n_levels, orb_cfg.scale,
            self._cam_key, self._wh_key, float(bf),
            float(self.p.motion_radius * r_scale),
            float(self.p.local_radius * r_scale),
            float(self.p.motion_ratio), float(self.p.local_ratio),
            int(self.p.th_high))
        self.pose_opt_pooled = kernels.pose_opt_pooled(
            self.cam_type, self._cam_key, float(bf),
            orb_cfg.n_levels, orb_cfg.scale)
        self.use_fused_track = True

        # --- IMU state (visual-inertial mode; reference src/Tracking.cc IMU
        # queue :1450, PreintegrateIMU :1457, PredictStateIMU :1616) ---
        self.imu_enabled = False
        self.imu_freq = 200.0
        self.imu_noise = (1.7e-4, 2e-3, 1e-5, 1e-4)  # (gyro, acc, gyro walk, acc walk)
        self.imu_queue: list = []       # (ts, gyro(3), acc(3)) tuples
        self.imu_initialized = False
        # staging flags (reference mbIMU_BA1/mbIMU_BA2 + mTinit,
        # src/LocalMapping.cc:244-288)
        self.imu_init_ts = 0.0
        self.viba1_done = False
        self.viba2_done = False
        self.last_scale_refine_ts = 0.0
        self.imu_bias_g = np.zeros(3, np.float32)
        self.imu_bias_a = np.zeros(3, np.float32)
        self.velocity_w: np.ndarray | None = None   # body velocity in world
        # frame-to-frame marginal prior (reference ConstraintPoseImu,
        # src/Optimizer.cc:4956-5070): 9x9 information on the last frame's
        # [δθ, δp, δv]; None ⇒ anchor the previous state rigidly
        self.pose_prior_H: np.ndarray | None = None
        self.kf_preints: dict = {}       # kf_id -> PreintState since previous KF
        self.preint_since_kf = None
        self.frame_preint = None
        # host mirror: does frame_preint span the last frame gap (set by
        # _preintegrate_frame without any device pull)
        self._frame_preint_covers = False
        self._fused_track_vi = None      # built lazily on first VI fused frame
        # bumped on whole-world transforms (IMU-init gravity/scale alignment,
        # VIBA passes): a pipelined dispatch in flight across one was
        # predicted/matched in the OLD world and must be dropped at consume
        self.world_epoch = 0

        self.init_frame: Frame | None = None
        self.last_frame: Frame | None = None
        self._pending: list = []   # in-flight pipelined frames (FIFO, ≤ depth)
        self.velocity: tuple[np.ndarray, np.ndarray] | None = None  # T_cl
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self._last_kf_ts: float = -1e18
        self._last_reloc_frame_id: int = -(10 ** 9)
        self.frames_since_reloc = 0
        self.n_frames = 0
        # running inlier average for the adaptive collapse gate
        # (_min_local_inliers); None until tracking stabilizes
        self.inlier_ema: float | None = None
        # per-path frame counters (performance diagnosis; reported by bench)
        self.path_counts = {"fused": 0, "fused_retry": 0, "staged": 0,
                            "fused_vi": 0, "reloc_frames": 0}
        # Atlas hooks (set by the system): called when tracking stays lost
        # (reference CreateMapInAtlas src/Tracking.cc:2914) and for cross-map
        # relocalization that triggers a map merge
        self.on_tracking_lost = None
        self.try_cross_map_reloc = None
        # optional BoW relocalization-candidate provider bound by System
        # (reference KeyFrameDatabase::DetectRelocalizationCandidates)
        self.reloc_candidates_fn = None
        self.consecutive_lost = 0
        self.frames_to_new_map = 20   # ≈1 s at 20 fps (reference 5 s)
        self.lost_ts: float | None = None   # ts of the OK→lost transition
        # per-frame trajectory log: (ts, ref_kf, R_cr, t_cr, lost)
        self.trajectory: list = []
        # callback the system wires to local mapping
        self.on_new_keyframe = None
        # async backpressure: callable → bool (reference queue<3 gate,
        # src/Tracking.cc:3626 + LocalMapping::AcceptKeyFrames)
        self.mapper_accepting = None

        sf2 = self.map.level_sigma2
        self.inv_sigma2 = self.map.inv_level_sigma2
        # per-stage timing (reference REGISTER_TIMES taxonomy, SURVEY 5.1);
        # the system replaces this with its shared pipeline timer
        self.timer = StageTimer()
        self.map.on_remap["tracker"] = self._on_map_remap

    # ------------------------------------------------------------------
    # pool compaction protocol
    # ------------------------------------------------------------------
    @property
    def map(self) -> MapState:
        return self._map

    @map.setter
    def map(self, m: MapState):
        """Rebinding the tracker to a(nother) map moves its remap-callback
        registration (MapState.on_remap) along."""
        old = getattr(self, "_map", None)
        if old is not None and old is not m:
            old.on_remap.pop("tracker", None)
        self._map = m
        m.on_remap["tracker"] = self._on_map_remap

    def _on_map_remap(self, kf_remap: np.ndarray, mp_remap: np.ndarray):
        """Map pools were compacted/grown (MapState.compact/grow): remap every
        kf/mp id this tracker holds. Runs under the map lock."""
        if self.ref_kf >= 0:
            r = int(kf_remap[self.ref_kf])
            if r < 0:   # ref culled (shouldn't happen: culling re-anchors)
                valid = self.map.valid_kf_ids()
                r = int(valid[-1]) if len(valid) else -1
            self.ref_kf = r
        self.kf_preints = {int(kf_remap[k]): v for k, v in self.kf_preints.items()
                           if kf_remap[k] >= 0}
        new_traj = []
        for (ts, k, Rcr, tcr, lost) in self.trajectory:
            if k >= 0:
                k2 = int(kf_remap[k])
                if k2 < 0:
                    new_traj.append((ts, -1, None, None, True))
                    continue
                k = k2
            new_traj.append((ts, k, Rcr, tcr, lost))
        self.trajectory = new_traj
        for f in {id(f): f for f in (self.last_frame, self.current_frame,
                                     self.init_frame) if f is not None}.values():
            if f.feat_mp is not None:
                pos = f.feat_mp >= 0
                f.feat_mp[pos] = mp_remap[f.feat_mp[pos]]

    # ------------------------------------------------------------------
    # IMU (visual-inertial)
    # ------------------------------------------------------------------
    def enable_imu(self, freq: float = 200.0,
                   noise=(1.7e-4, 2e-3, 1e-5, 1e-4)):
        self.imu_enabled = True
        self.imu_freq = freq
        self.imu_noise = noise

    def grab_imu(self, ts, gyro, acc):
        """Queue IMU samples (reference Tracking::GrabImuData src/Tracking.cc:1450)."""
        for t, w, a in zip(np.atleast_1d(ts), np.atleast_2d(gyro), np.atleast_2d(acc)):
            self.imu_queue.append((float(t), np.asarray(w, np.float32),
                                   np.asarray(a, np.float32)))

    def _preintegrate_frame(self, ts_prev: float, ts_cur: float, cap: int = 128):
        """Preintegrate queued samples in (ts_prev, ts_cur] (reference
        PreintegrateIMU :1457); returns a PreintState or None."""
        import jax.numpy as jnp
        from ..ops import imu as imu_ops
        eps = 1e-6  # float timestamp jitter must not drop boundary samples
        take = [s for s in self.imu_queue if ts_prev + eps < s[0] <= ts_cur + eps]
        self.imu_queue = [s for s in self.imu_queue if s[0] > ts_cur + eps]
        self._frame_preint_covers = False
        if not take:
            return None
        # host-side coverage check (sum of sample dts vs the frame gap) so
        # the fused-VI gate never pulls pre.dT from the device
        self._frame_preint_covers = (
            abs((take[min(len(take), cap) - 1][0] - ts_prev)
                - (ts_cur - ts_prev)) < 0.02)
        n = min(len(take), cap)
        acc = np.zeros((cap, 3), np.float32)
        gyr = np.zeros((cap, 3), np.float32)
        dts = np.zeros(cap, np.float32)
        valid = np.zeros(cap, bool)
        t_last = ts_prev
        for i, (t, w, a) in enumerate(take[:n]):
            gyr[i] = w
            acc[i] = a
            dts[i] = t - t_last
            valid[i] = True
            t_last = t
        ng, na, wg, wa = self.imu_noise
        st = imu_ops.preintegrate(
            jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
            jnp.asarray(valid), jnp.asarray(self.imu_bias_g),
            jnp.asarray(self.imu_bias_a), ng, na, wg, wa, self.imu_freq)
        return st

    def _accumulate_preint(self, st):
        """Accumulate per-frame preintegration into the since-last-KF block
        (reference keeps mpImuPreintegratedFromLastKF alongside the per-frame
        preintegration, src/Tracking.cc:1457-1604)."""
        from ..ops import imu as imu_ops
        if st is None:
            return
        if self.preint_since_kf is None:
            self.preint_since_kf = st
        else:
            self.preint_since_kf = imu_ops.compose(self.preint_since_kf, st)

    def _predict_pose_imu(self, frame: Frame, allow_untracked: bool = False) -> bool:
        """IMU state propagation as pose prediction (reference PredictStateIMU).

        ``allow_untracked`` permits propagating from a last frame whose own
        pose was only an IMU prediction (RECENTLY_LOST dead-reckoning,
        reference src/Tracking.cc:2007-2016); the propagated velocity is then
        stored so the dead-reckon chain continues across lost frames."""
        from ..ops import imu as imu_ops
        import jax.numpy as jnp
        if (self.frame_preint is None or self.last_frame is None
                or self.velocity_w is None or self.last_frame.R is None
                or (not self.last_frame.tracked and not allow_untracked)):
            return False
        Rl, tl = self.last_frame.R, self.last_frame.t
        R_wb = Rl.T
        p_wb = -Rl.T @ tl
        R2, p2, v2 = imu_ops.predict_state(
            jnp.asarray(R_wb), jnp.asarray(p_wb), jnp.asarray(self.velocity_w),
            self.frame_preint, jnp.asarray(self.imu_bias_g),
            jnp.asarray(self.imu_bias_a))
        R2 = np.asarray(R2); p2 = np.asarray(p2)
        frame.R = R2.T.astype(np.float32)
        frame.t = (-R2.T @ p2).astype(np.float32)
        if allow_untracked:
            self.velocity_w = np.asarray(v2, np.float32)
        return True

    def try_imu_init(self, min_kfs: int = 8, prior_g: float | None = None,
                     prior_a: float | None = None, refine: bool = False,
                     fix_bias: bool = False) -> bool:
        """Inertial-only MAP: gravity + scale + biases + velocities (reference
        InitializeIMU src/LocalMapping.cc:1559). First call gravity-aligns and
        rescales the map (stage 1); with ``refine=True`` it re-estimates with
        the given priors on an already-initialized map — the reference's VIBA1
        (priors 1, 1e5 at mTinit>5 s) and VIBA2 (0, 0 at >15 s) call the same
        routine (src/LocalMapping.cc:244-273). ``fix_bias`` pins biases with
        huge priors (the reference's ScaleRefinement :1770 optimizes only
        scale + gravity direction)."""
        import jax.numpy as jnp
        from ..ops import imu_init as ii
        m = self.map
        if not self.imu_enabled or (self.imu_initialized and not refine):
            return False
        if refine and not self.imu_initialized:
            return False
        from ..ops import imu as imu_ops
        kfs = [int(k) for k in m.valid_kf_ids()]
        chain0 = [k for k in kfs if k in self.kf_preints or k == kfs[0]]
        if len(chain0) < min_kfs:
            return False
        # contiguity: a chain link is usable only when its preintegration
        # window matches the KF time gap
        contig = [True] * len(chain0)
        for i in range(1, len(chain0)):
            dt_kf = float(m.kf_ts[chain0[i]] - m.kf_ts[chain0[i - 1]])
            contig[i] = abs(float(self.kf_preints[chain0[i]].dT) - dt_kf) < 0.015
        # subsample to >=0.25 s spacing, composing preintegrations across the
        # skipped keyframes — short pairs bury the gravity/scale signal
        # (½g·dT² ≈ 1 cm at 0.05 s) under visual noise (reference edges span
        # its much sparser inertial keyframes)
        chain, pre = [chain0[0]], []
        acc_pre = None
        for i in range(1, len(chain0)):
            if not contig[i]:
                acc_pre = None
                chain, pre = [chain0[i]], []   # restart after a gap
                continue
            p_i = self.kf_preints[chain0[i]]
            acc_pre = p_i if acc_pre is None else imu_ops.compose(acc_pre, p_i)
            if float(acc_pre.dT) >= 0.25 - 1e-6:
                chain.append(chain0[i])
                pre.append(acc_pre)
                acc_pre = None
        if len(chain) < 4:
            return False
        # mono first-init timespan gate: below ~2 s of travel the scale is
        # observable only through ∫∫(a−g) vs the noisy visual positions and
        # collapses toward 0 (measured: −55% scale error at 1 s span even at
        # 3 m/s² excitation, +1% at 2.25 s — scripts/diag_init_op.py sweep;
        # the reference also waits 1-2 s before InitializeIMU,
        # src/LocalMapping.cc:213-221)
        if (self.bf <= 0 and not refine
                and float(m.kf_ts[chain[-1]] - m.kf_ts[chain[0]]) < 2.2):
            return False
        R_wb = np.stack([m.kf_R[k].T for k in chain])
        p_wb = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in chain])
        pair_ok = np.ones(len(pre), bool)
        stack = lambda attr: jnp.asarray(np.stack([np.asarray(getattr(s, attr)) for s in pre]))
        cov = jnp.asarray(np.stack([np.asarray(s.C)[:9, :9] for s in pre]))
        if prior_g is None:
            prior_g = 1e2
        if prior_a is None:
            prior_a = 1e10 if self.bf <= 0 else 1e5
        if fix_bias:
            prior_g = prior_a = 1e12
        res = ii.inertial_init(
            jnp.asarray(R_wb.astype(np.float32)), jnp.asarray(p_wb.astype(np.float32)),
            stack("dT"), stack("dR"), stack("dV"), stack("dP"),
            stack("JRg"), stack("JVg"), stack("JVa"), stack("JPg"), stack("JPa"),
            jnp.asarray(pair_ok), cov=cov,
            opt_scale=(self.bf <= 0), iters=40,
            prior_g=prior_g, prior_a=prior_a)
        s = float(res.scale)
        s_lo, s_hi = (0.02, 50.0) if not refine else (0.5, 2.0)
        if not (s_lo < s < s_hi) or not np.isfinite(s):
            return False
        sub_span_ok = (len(pre) >= 6 and
                       float(m.kf_ts[chain[(2 * len(pre)) // 3]]
                             - m.kf_ts[chain[0]]) >= 2.0)
        if self.bf <= 0 and not refine and sub_span_ok and self.p.gate_init_split:
            # split-sample consistency gate: mono scale near the observability
            # threshold is chaotic — a fit whose first-2/3 and last-2/3
            # sub-chains disagree on scale is not trustworthy yet (observed:
            # a 10-20x under-estimate passes the span/range gates, shrinks the
            # map and trips the bad-IMU watchdog 5 keyframes later). No
            # reference counterpart — it gates on time heuristics only
            # (src/LocalMapping.cc:213-288) and tolerates bad inits by
            # re-running VIBA; a wrong first scale here costs the whole map.
            n_sub = max(4, (2 * len(pre)) // 3)
            sub_scales = []
            for mask_sel in (slice(0, n_sub), slice(len(pre) - n_sub, None)):
                mask = np.zeros(len(pre), bool)
                mask[mask_sel] = True
                r_sub = ii.inertial_init(
                    jnp.asarray(R_wb.astype(np.float32)),
                    jnp.asarray(p_wb.astype(np.float32)),
                    stack("dT"), stack("dR"), stack("dV"), stack("dP"),
                    stack("JRg"), stack("JVg"), stack("JVa"), stack("JPg"),
                    stack("JPa"), jnp.asarray(pair_ok & mask), cov=cov,
                    opt_scale=True, iters=40,
                    prior_g=prior_g, prior_a=prior_a)
                sub_scales.append(float(r_sub.scale))
            ratio = max(sub_scales) / max(min(sub_scales), 1e-9)
            if not np.isfinite(ratio) or ratio > 2.0:
                return False
        Rwg = np.asarray(res.Rwg)
        if refine:
            # a refinement pass on an initialized (gravity-aligned) map must
            # stay a small correction; reject wild gravity re-estimates
            ang = np.arccos(np.clip((np.trace(Rwg) - 1.0) / 2.0, -1.0, 1.0))
            if ang > 0.35:
                return False
        # world' = s · Rgw · world with Rgw = Rwg⁻¹ (gravity → -z)
        from ..ops import imu_init as ii2
        kfs_all = m.valid_kf_ids()
        Rn, tn, pn = ii2.apply_scaled_rotation(
            jnp.asarray(m.kf_R[kfs_all]), jnp.asarray(m.kf_t[kfs_all]),
            jnp.asarray(m.mp_xyz[m.valid_mp_ids()]),
            jnp.asarray(Rwg.T), jnp.asarray(s, jnp.float32))
        m.kf_R[kfs_all] = np.asarray(Rn)
        m.kf_t[kfs_all] = np.asarray(tn)
        m.mp_xyz[m.valid_mp_ids()] = np.asarray(pn)
        m.touch()
        # transform the live frame(s) + velocity into the new world. BOTH the
        # last frame and the in-flight current frame must follow (in the
        # synchronous path the init runs inside the current frame's keyframe
        # creation, so last_frame is the PREVIOUS frame and the current one
        # would otherwise stay in the old world — the next IMU prediction
        # then dead-reckons from a stale-world pose and tracking collapses;
        # observed as a guaranteed one-frame LOST right after init)
        for fr in {id(f): f for f in (self.last_frame, self.current_frame)
                   if f is not None and f.R is not None}.values():
            fr.R = (fr.R @ Rwg).astype(np.float32)
            fr.t = (fr.t * s).astype(np.float32)
        # logged relative poses T_cr are scale-covariant: their translations
        # are in PRE-transform units but export composes them with the
        # POST-transform keyframe poses (reference SaveTrajectoryEuRoC
        # composes mlRelativeFramePoses the same way, src/System.cc:612-640 —
        # negligible there because its corrections are near-rigid, but the
        # mono init rescale is 5-10x and was worth 0.2 of ATE here)
        # frozen (k = -2) entries belong to a retired map's frame: skip them
        self.trajectory = [
            e if (e[1] == -2 or e[3] is None) else
            (e[0], e[1], e[2], (e[3] * s).astype(np.float32), e[4])
            for e in self.trajectory]
        vels = np.asarray(res.vels)
        # per-KF velocities (reference SetVelocity in InitializeIMU): solved
        # ones for the chain, finite differences of the corrected poses for
        # the rest
        ctr = -np.einsum("kij,ki->kj", m.kf_R[kfs_all].transpose(0, 2, 1),
                         m.kf_t[kfs_all])
        tss = m.kf_ts[kfs_all]
        if len(kfs_all) >= 2:
            dt = np.gradient(tss)
            dt = np.maximum(dt, 1e-3)
            v_fd = np.gradient(ctr, axis=0) / dt[:, None]
            m.kf_vel[kfs_all] = v_fd.astype(np.float32)
        v_chain = (s * (vels @ Rwg)).astype(np.float32)   # s·Rwgᵀ·v, rowwise
        m.kf_vel[np.asarray(chain)] = v_chain
        m.kf_bias_g[kfs_all] = np.asarray(res.bg, np.float32)
        m.kf_bias_a[kfs_all] = np.asarray(res.ba, np.float32)
        if self.velocity_w is not None or not refine:
            self.velocity_w = v_chain[-1]
        self.imu_bias_g = np.asarray(res.bg, np.float32)
        self.imu_bias_a = np.asarray(res.ba, np.float32)
        self.velocity = None  # const-velocity model invalid across rescale
        self.pose_prior_H = None   # marginal prior frame changed under it
        self.world_epoch += 1      # drop pipelined dispatches from the old world
        if not self.imu_initialized:
            self.imu_init_ts = float(m.kf_ts[kfs[-1]])
        self.imu_initialized = True
        return True

    # ------------------------------------------------------------------
    def _timestamp_guard(self, ts: float):
        """Timestamp-fault recovery (reference src/Tracking.cc:1819-1861):
        backwards time or a >1 s gap abandons the current tracking episode —
        the map is stored in the Atlas (or wiped while young) and tracking
        restarts, which is also how multi-session runs chain sequences into
        one process (reference ChangeDataset)."""
        lf = self.last_frame
        if lf is None or self.state == TrackState.NOT_INITIALIZED:
            return
        if ts < lf.ts or ts - lf.ts > 1.0:
            if self.on_tracking_lost is not None:
                self.on_tracking_lost()
            # any preintegration spanning the fault is invalid
            self.frame_preint = None
            self.preint_since_kf = None
            self.velocity = None
            self.velocity_w = None
            self.pose_prior_H = None
            self.last_frame = None

    def process_frame(self, img: np.ndarray, ts: float) -> dict:
        if self.p.pipeline:
            return self._process_frame_pipelined(img, ts)
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        if self.imu_enabled and self.last_frame is not None:
            with self.timer.stage("0.imu_preintegration"):
                self.frame_preint = self._preintegrate_frame(self.last_frame.ts, ts)
                self._accumulate_preint(self.frame_preint)
        with self.timer.stage("1.orb_extraction"):
            feats = self.extract(jnp.asarray(img))
            frame = build_frame(fid, ts, feats, self.K, self.D)

        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                ok = self._monocular_init(frame)
                info = {"state": self.state.name, "init": ok}
            else:
                with self.timer.stage("3.track_total"):
                    ok = self._track(frame)
                info = {"state": self.state.name,
                        "inliers": frame.n_matched() if ok else 0}

            self._log_trajectory(frame, tracked=ok)
        self.last_frame = frame
        return info

    def _process_frame_pipelined(self, img: np.ndarray, ts: float) -> dict:
        """One-frame-deep software pipeline (TrackingParams.pipeline): extract
        frame N and dispatch its fused tracking immediately; its packed result
        is pulled at the start of call N+1, so the transfer overlaps
        the caller's inter-frame time + frame N+1's extraction dispatch."""
        fid = self.n_frames
        self.n_frames += 1
        with self.timer.stage("1.orb_extraction"):
            feats = self.extract(jnp.asarray(np.asarray(img, np.float32)))
            frame = build_frame(fid, ts, feats)
        return self._pipeline_step(frame, ts)

    def _pipeline_step(self, frame: Frame, ts: float) -> dict:
        """Shared pipelined tracking step (mono and stereo front ends):
        flush the oldest in-flight frame, preintegrate, then dispatch this
        frame's fused tracking (or fall back to the staged cascade)."""
        depth = max(1, int(getattr(self.p, "pipeline_depth", 1)))
        info_prev = None
        if len(self._pending) >= depth:
            info_prev = self._flush_one()
        self._timestamp_guard(ts)
        if self.imu_enabled and self.last_frame is not None:
            # preintegration spans [last consumed frame, this frame]; at
            # pipeline depth 1 the previous frame is always consumed by now,
            # so the fused VI dispatch links consecutive frames exactly as
            # the staged path does (reference PreintegrateIMU :1457)
            with self.timer.stage("0.imu_preintegration"):
                self.frame_preint = self._preintegrate_frame(
                    self.last_frame.ts, ts)
                self._accumulate_preint(self.frame_preint)
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                info_prev = self.flush_pending() or info_prev
                self._ensure_stereo_host(frame)
                if self.bf > 0:
                    ok = self._stereo_init(frame)
                else:
                    ok = self._monocular_init(frame)
                self._log_trajectory(frame, tracked=ok)
                self.last_frame = frame
                return {"state": self.state.name, "init": ok}
            if self._can_fuse_track():
                with self.timer.stage("3f.fused_dispatch"):
                    pend = self._fused_dispatch(frame)
                if pend is not None:
                    self._pending.append(pend)
                    return info_prev if info_prev is not None else {
                        "state": self.state.name, "pending": True}
            # staged path needs a fully-consumed state: drain the pipeline
            info_prev = self.flush_pending() or info_prev
            self._ensure_stereo_host(frame)
            with self.timer.stage("3.track_total"):
                ok = self._track(frame, allow_fused=False)
            self._log_trajectory(frame, tracked=ok)
            self.last_frame = frame
            return {"state": self.state.name,
                    "inliers": frame.n_matched() if ok else 0}

    def flush_pending(self) -> dict | None:
        """Finalize ALL in-flight pipelined frames (no-op without any).
        MUST be called before reading tracker state externally — the system
        calls it from stats()/shutdown/trajectory export."""
        info = None
        while self._pending:
            info = self._flush_one() or info
        return info

    def _flush_one(self) -> dict | None:
        if not self._pending:
            return None
        pend = self._pending.pop(0)
        frame = pend["frame"]
        with locked_current(self):
            if pend["map"] is not self.map or \
                    pend["map"].remap_epoch != pend.get("epoch", pend["map"].remap_epoch) \
                    or pend.get("wepoch", self.world_epoch) != self.world_epoch:
                return None
            self.current_frame = frame
            with self.timer.stage("3g.fused_consume"):
                ok = self._fused_consume(pend)
            if ok:
                self.path_counts["fused"] += 1
            if not ok and self._can_fuse_track():
                # stale-candidate miss (deep pipelines dispatch with lagged
                # candidate sets): one synchronous fused retry with CURRENT
                # candidates costs ~1 round trip vs ~10 for the staged path
                frame.feat_mp[:] = -1
                with self.timer.stage("3g.fused_retry"):
                    ok = self._track_fused(frame)
                if ok:
                    self.path_counts["fused_retry"] += 1
            if ok:
                self._post_track(frame, True)
            else:
                frame.feat_mp[:] = -1
                self.path_counts["staged"] += 1
                self._ensure_stereo_host(frame)
                ok = self._track(frame, allow_fused=False)
            self._log_trajectory(frame, tracked=ok)
            self.last_frame = frame
            return {"state": self.state.name,
                    "inliers": frame.n_matched() if ok else 0}

    def _stereo_frontend_jit(self):
        """ONE fused dispatch for the whole stereo front end: L+R extraction
        + row-constrained descriptor matching + subpixel disparity (the
        reference splits this across two std::threads + ComputeStereoMatches,
        src/Frame.cc:132-137, :1027). The right-x vector stays on device for
        the fused tracking dispatch; the host mirror materializes lazily
        (_ensure_stereo_host)."""
        if not hasattr(self, "_stereo_fe"):
            import jax
            from ..ops import stereo as stereo_ops
            sfs = jnp.asarray(self.map.scale_factors)
            bf = jnp.asarray(self.bf, jnp.float32)
            extract = self.extract

            @jax.jit
            def fe(img_l, img_r):
                fl = extract(img_l)
                fr = extract(img_r)
                ur, _depth, ok = stereo_ops.stereo_match(
                    fl.xy, fl.desc, fl.octave, fl.valid,
                    fr.xy, fr.desc, fr.octave, fr.valid,
                    sfs, bf, jnp.asarray(0.1, jnp.float32))
                ur, ok = stereo_ops.subpixel_refine(img_l, img_r, fl.xy, ur, ok)
                disp = fl.xy[:, 0] - ur
                ur = jnp.where(ok & (disp > 0.1), ur,
                               jnp.asarray(-1.0, jnp.float32))
                return fl, ur
            self._stereo_fe = fe
        return self._stereo_fe

    def _process_stereo_pipelined(self, img_l, img_r, ts: float) -> dict:
        fid = self.n_frames
        self.n_frames += 1
        with self.timer.stage("1.orb_extraction"):
            fl, ur = self._stereo_frontend_jit()(
                jnp.asarray(np.asarray(img_l, np.float32)),
                jnp.asarray(np.asarray(img_r, np.float32)))
            frame = build_frame(fid, ts, fl, self.K, self.D)
            frame._ur_dev = ur
        return self._pipeline_step(frame, ts)

    def process_stereo_frame(self, img_l: np.ndarray, img_r: np.ndarray,
                             ts: float) -> dict:
        """Stereo front end: extract both eyes, match along rows, then run the
        common tracking path with depth available (reference GrabImageStereo
        src/Tracking.cc:1257 + Frame stereo ctor src/Frame.cc:103)."""
        import jax.numpy as jnp
        from ..ops import stereo as stereo_ops
        if self.p.pipeline and self.rig is None:
            return self._process_stereo_pipelined(img_l, img_r, ts)
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        if self.imu_enabled and self.last_frame is not None:
            self.frame_preint = self._preintegrate_frame(self.last_frame.ts, ts)
            self._accumulate_preint(self.frame_preint)
        with self.timer.stage("1.orb_extraction"):
            img_l_dev = jnp.asarray(np.asarray(img_l, np.float32))
            img_r_dev = jnp.asarray(np.asarray(img_r, np.float32))
            fl = self.extract(img_l_dev)
            fr = self.extract(img_r_dev)
        frame = build_frame(fid, ts, fl, self.K, self.D)
        fr_frame = build_frame(fid, ts, fr, self.K, self.D)
        _t_stereo = self.timer.stage("2.stereo_match"); _t_stereo.__enter__()
        ur, depth, ok = stereo_ops.stereo_match(
            fl.xy, fl.desc, fl.octave, fl.valid,
            fr.xy, fr.desc, fr.octave, fr.valid,
            jnp.asarray(self.map.scale_factors),
            jnp.asarray(self.bf, jnp.float32),
            jnp.asarray(0.1, jnp.float32))
        # subpixel disparity (integer keypoints alone give z²/bf-level depth noise)
        ur, ok = stereo_ops.subpixel_refine(
            img_l_dev, img_r_dev, fl.xy, ur, ok)
        okn = np.asarray(ok)
        urn = np.asarray(ur)
        disp = frame.xy[:, 0] - urn
        okn = okn & (disp > 0.1)
        frame.ur = np.where(okn, urn, -1.0).astype(np.float32)
        frame.depth = np.where(okn, self.bf / np.maximum(disp, 1e-6), -1.0).astype(np.float32)
        _t_stereo.__exit__(None, None, None)

        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                done = self._stereo_init(frame)
                info = {"state": self.state.name, "init": done}
            else:
                with self.timer.stage("3.track_total"):
                    done = self._track(frame)
                info = {"state": self.state.name,
                        "inliers": frame.n_matched() if done else 0}
            self._log_trajectory(frame, tracked=done)
        self.last_frame = frame
        return info

    def set_fisheye_rig(self, cam_r, R_rl, t_rl, lap_l=(0.0, 1e9),
                        lap_r=(0.0, 1e9)):
        """Configure a heterogeneous two-camera fisheye rig (reference
        Camera2.* YAML keys + Tlr, src/Tracking.cc ParseCamParamFile two-camera
        branch; lapping areas Camera.lappingBegin/End)."""
        self.rig = {
            "cam_r": np.asarray(cam_r, np.float32),
            "R_rl": np.asarray(R_rl, np.float32),
            "t_rl": np.asarray(t_rl, np.float32),
            "lap_l": np.asarray(lap_l, np.float32),
            "lap_r": np.asarray(lap_r, np.float32),
        }
        if self.bf <= 0:
            self.bf = float(np.linalg.norm(t_rl) * self.cam_params[0])
        # bf is baked into the pooled kernels — rebuild them (lru-cached)
        self.fused_track = kernels.fused_track_pooled(
            self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
            self._cam_key, self._wh_key, float(self.bf),
            float(self.p.motion_radius), float(self.p.local_radius),
            float(self.p.motion_ratio), float(self.p.local_ratio),
            int(self.p.th_high))
        self.pose_opt_pooled = kernels.pose_opt_pooled(
            self.cam_type, self._cam_key, float(self.bf),
            self.orb_cfg.n_levels, self.orb_cfg.scale)

    def process_fisheye_stereo_frame(self, img_l: np.ndarray,
                                     img_r: np.ndarray, ts: float) -> dict:
        """Two-camera fisheye front end (reference Frame two-camera ctor
        src/Frame.cc:1340 + ComputeStereoFishEyeMatches :1440): extract both
        eyes, match in the lapping areas, triangulate through the KB8 models;
        triangulated depth drives the standard close-point stereo machinery
        (map scale is metric from the rig baseline)."""
        import jax.numpy as jnp
        from ..ops import stereo as stereo_ops
        assert self.rig is not None, "call set_fisheye_rig first"
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        if self.imu_enabled and self.last_frame is not None:
            self.frame_preint = self._preintegrate_frame(self.last_frame.ts, ts)
            self._accumulate_preint(self.frame_preint)
        fl = self.extract(jnp.asarray(img_l))
        fr = self.extract(jnp.asarray(img_r))
        frame = build_frame(fid, ts, fl, self.K, None)
        fr_frame = build_frame(fid, ts, fr, self.K, None)
        rig = self.rig
        idx, ok, z, xl = stereo_ops.fisheye_stereo_match(
            fl.xy, fl.desc, fl.octave, fl.valid,
            fr.xy, fr.desc, fr.octave, fr.valid,
            jnp.asarray(self.cam_params), jnp.asarray(rig["cam_r"]),
            jnp.asarray(rig["R_rl"]), jnp.asarray(rig["t_rl"]),
            jnp.asarray(rig["lap_l"]), jnp.asarray(rig["lap_r"]),
            jnp.asarray(self.map.level_sigma2),
            jnp.asarray(0.7, jnp.float32), jnp.asarray(50, jnp.int32))
        okn = np.asarray(ok)
        idxn = np.asarray(idx)
        frame.depth = np.where(okn, np.asarray(z), -1.0).astype(np.float32)
        # no rectified right coordinate for fisheye (reference keeps
        # mvuRight=-1 for KB8 rigs); instead record the right-eye PIXEL of the
        # match — BA adds a second-camera (ToBody) residual that anchors the
        # metric scale (reference EdgeSE3ProjectXYZToBody)
        frame.uvr = np.where(okn[:, None], fr_frame.xy[idxn],
                             -1.0).astype(np.float32)
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                done = self._stereo_init(frame)
                info = {"state": self.state.name, "init": done,
                        "n_stereo": int(okn.sum())}
            else:
                done = self._track(frame)
                info = {"state": self.state.name,
                        "inliers": frame.n_matched() if done else 0}
            self._log_trajectory(frame, tracked=done)
        self.last_frame = frame
        return info

    def process_rgbd_frame(self, img: np.ndarray, depth_map: np.ndarray,
                           ts: float) -> dict:
        """RGB-D front end: depth sampled at keypoint locations becomes a
        virtual stereo coordinate (reference src/Frame.cc:1279)."""
        import jax.numpy as jnp
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        if self.imu_enabled and self.last_frame is not None:
            self.frame_preint = self._preintegrate_frame(self.last_frame.ts, ts)
            self._accumulate_preint(self.frame_preint)
        feats = self.extract(jnp.asarray(img))
        frame = build_frame(fid, ts, feats, self.K, self.D)
        xi = np.clip(np.round(frame.xy[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
        yi = np.clip(np.round(frame.xy[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
        z = depth_map[yi, xi].astype(np.float32)
        ok = frame.valid & (z > 0)
        frame.depth = np.where(ok, z, -1.0).astype(np.float32)
        frame.ur = np.where(ok, frame.xy[:, 0] - self.bf / np.maximum(z, 1e-6),
                            -1.0).astype(np.float32)
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                done = self._stereo_init(frame)
                info = {"state": self.state.name, "init": done}
            else:
                done = self._track(frame)
                info = {"state": self.state.name,
                        "inliers": frame.n_matched() if done else 0}
            self._log_trajectory(frame, tracked=done)
        self.last_frame = frame
        return info

    def _stereo_init(self, frame: Frame) -> bool:
        """Instant map from stereo depth (reference StereoInitialization
        src/Tracking.cc:2485: needs >500 keypoints, spawns a point per valid
        depth)."""
        if frame.n_valid < 500:
            return False
        m = self.map
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        k0 = m.add_keyframe(frame.R, frame.t, frame.ts, frame.frame_id,
                            frame.xy, frame.angle, frame.octave, frame.desc,
                            frame.valid, ur=frame.ur, depth=frame.depth,
                            uvr=frame.uvr)
        sel = np.nonzero(frame.valid & (frame.depth > 0))[0]
        # the reference spawns a point per valid depth with no floor
        # (src/Tracking.cc:2516-2540); 50 guards degenerate starts — fisheye
        # rigs see fewer stereo depths (parallax-gated lapping area)
        if len(sel) < 50:
            m.kf_valid[k0] = False
            m.n_kf -= 1
            return False
        z = frame.depth[sel]
        xyz = (self._backproject(frame.xy[sel]) * z[:, None]).astype(np.float32)
        dist = np.linalg.norm(xyz, axis=1)
        normals = xyz / np.maximum(dist[:, None], 1e-9)
        sf = m.scale_factors
        lvl = frame.octave[sel]
        maxd = dist * sf[lvl]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xyz, frame.desc[sel], k0, normals, mind, maxd,
                               first_kf=k0)
        m.kf_feat_mp[k0, sel] = ids
        m.mp_visible[ids] = 1
        m.mp_found[ids] = 1
        frame.feat_mp = m.kf_feat_mp[k0].copy()
        self.ref_kf = k0
        self.last_kf_frame_id = frame.frame_id
        self._last_kf_ts = frame.ts
        self.velocity = None
        self.state = TrackState.OK
        frame.tracked = True
        return True

    def _backproject(self, xy: np.ndarray) -> np.ndarray:
        """Pixels → unit-z rays through the active camera model (reference
        GeometricCamera::unproject; pinhole AND KB8 — depth is z-depth)."""
        from ..ops import camera as cam_ops
        return np.asarray(cam_ops.unproject(
            self.cam_type, jnp.asarray(self.cam_params), jnp.asarray(xy)))

    def _spawn_close_points(self, frame: Frame, kf_id: int, max_new: int = 100):
        """Close-depth point spawning on keyframe creation (reference
        CreateNewKeyFrame src/Tracking.cc:3653: sorts by depth, inserts points
        up to ThDepth or at least the 100 closest)."""
        m = self.map
        sel = np.nonzero(frame.valid & (frame.depth > 0) & (frame.feat_mp < 0))[0]
        if len(sel) == 0:
            return
        order = sel[np.argsort(frame.depth[sel])]
        close = order[frame.depth[order] < self.th_depth]
        if len(close) < max_new:
            close = order[: max_new]
        if len(close) == 0:
            return
        z = frame.depth[close]
        Rwc = frame.R.T
        c = -Rwc @ frame.t
        xc = self._backproject(frame.xy[close]) * z[:, None]
        xyz = (xc @ Rwc.T + c).astype(np.float32)
        dirs = xyz - c
        dist = np.linalg.norm(dirs, axis=1)
        normals = dirs / np.maximum(dist[:, None], 1e-9)
        sf = m.scale_factors
        lvl = frame.octave[close]
        maxd = dist * sf[lvl]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xyz, frame.desc[close], kf_id, normals, mind,
                               maxd, first_kf=kf_id)
        m.kf_feat_mp[kf_id, close] = ids
        m.mp_visible[ids] = 1
        m.mp_found[ids] = 1
        frame.feat_mp[close] = ids

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _monocular_init(self, frame: Frame) -> bool:
        p = self.p
        if frame.n_valid < p.min_init_matches:
            self.init_frame = None
            return False
        if self.init_frame is None:
            self.init_frame = frame
            return False

        f0, f1 = self.init_frame, frame
        idx, best, ok = self.match_init(
            jnp.asarray(f0.desc), jnp.asarray(f0.valid), jnp.asarray(f0.xy),
            jnp.asarray(f0.angle), jnp.asarray(f1.desc), jnp.asarray(f1.valid),
            jnp.asarray(f1.xy), jnp.asarray(f1.angle))
        okn = np.asarray(ok)
        idxn = np.asarray(idx)
        if okn.sum() < p.min_init_matches:
            self.init_frame = frame   # slide the reference forward
            return False

        # normalized coords of matches
        fx, fy, cx, cy = self.K[:4]
        if self.cam_type == 0:
            x1 = (f0.xy - [cx, cy]) / [fx, fy]
            x2 = (f1.xy[idxn] - [cx, cy]) / [fx, fy]
        else:
            # fisheye: normalized coords through the camera model (reference
            # two-view init goes through GeometricCamera::ReconstructWithTwoViews)
            from ..ops import camera as cam_ops
            r1 = np.asarray(cam_ops.unproject(self.cam_type,
                jnp.asarray(self.cam_params), jnp.asarray(f0.xy)))
            r2 = np.asarray(cam_ops.unproject(self.cam_type,
                jnp.asarray(self.cam_params), jnp.asarray(f1.xy[idxn])))
            x1 = r1[:, :2]
            x2 = r2[:, :2]
        rand_sets = self._rand_sets(np.nonzero(okn)[0], iters=200, k=8)
        res = self.two_view(
            jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
            jnp.asarray(okn), jnp.asarray(rand_sets))
        if not bool(res.success):
            return False

        good = np.asarray(res.good) & okn
        if good.sum() < p.min_init_matches // 2:
            return False
        R21 = np.asarray(res.R)
        t21 = np.asarray(res.t)
        pts = np.asarray(res.pts)

        # scale so median depth (in cam1) = 1 (reference CreateInitialMapMonocular)
        med = float(np.median(pts[good, 2]))
        if med <= 0:
            return False
        pts = pts / med
        t21 = t21 / med

        self._create_initial_map(f0, f1, R21, t21, pts, good, idxn)
        return True

    def _create_initial_map(self, f0, f1, R21, t21, pts, good, idxn):
        m = self.map
        gi = np.nonzero(good)[0]
        f0_assign = np.full(len(f0.valid), -1, np.int32)
        f1_assign = np.full(len(f1.valid), -1, np.int32)

        k0 = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                            f0.ts, f0.frame_id, f0.xy, f0.angle, f0.octave,
                            f0.desc, f0.valid)
        k1 = m.add_keyframe(R21.astype(np.float32), t21.astype(np.float32),
                            f1.ts, f1.frame_id, f1.xy, f1.angle, f1.octave,
                            f1.desc, f1.valid)
        # map points (world = cam0 frame)
        xyz = pts[gi]
        desc = f0.desc[gi]
        normals = xyz / np.maximum(np.linalg.norm(xyz, axis=1, keepdims=True), 1e-9)
        dist = np.linalg.norm(xyz, axis=1)
        sf = m.scale_factors
        lvl = f0.octave[gi]
        maxd = dist * sf[lvl]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xyz, desc, k1, normals, mind, maxd, first_kf=k0)
        f0_assign[gi] = ids
        f1_assign[idxn[gi]] = ids
        m.kf_feat_mp[k0] = f0_assign
        m.kf_feat_mp[k1] = f1_assign

        # initial global BA (reference: 20 iterations, first KF fixed)
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k1, initial=True)

        f1.R = m.kf_R[k1].copy()
        f1.t = m.kf_t[k1].copy()
        f1.feat_mp = m.kf_feat_mp[k1].copy()
        self.ref_kf = k1
        self.last_kf_frame_id = f1.frame_id
        self._last_kf_ts = f1.ts
        self.velocity = None
        # discard IMU accumulated before the map existed (reference resets the
        # from-last-KF preintegrator at initialization, src/Tracking.cc:2504)
        self.preint_since_kf = None
        self.state = TrackState.OK

    def _rand_sets(self, valid_idx: np.ndarray, iters: int, k: int) -> np.ndarray:
        if len(valid_idx) < k:
            return np.zeros((iters, k), np.int32)
        return self.rng.choice(valid_idx, size=(iters, k), replace=True).astype(np.int32)

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------
    def _last_track_healthy(self) -> bool:
        """Was the last frame tracked with a healthy inlier count? Gates the
        anchored motion model and the weak last-pose prior: both are
        drift-suppression devices that presume good tracking, and both turn
        into a frozen-pose attractor when applied to a degraded estimate."""
        lf = self.last_frame
        if lf is None or not lf.tracked:
            return False
        if not self.p.gate_anchor:      # ablation: unconditional protections
            return True
        # 6% of the feature budget: the walk-revisit frozen state sits at
        # ~5% while ordinary low-overlap phases (VI fixtures dip to ~10%)
        # must keep the protections on
        return lf.n_matched() >= max(20, int(0.06 * self.orb_cfg.total_capacity))

    def _check_replaced_in_last_frame(self):
        """Forward fused-away map-point ids in the last frame to their
        replacements (reference Tracking::CheckReplacedInLastFrame,
        src/Tracking.cc:2159: Frame::mvpMapPoints follow MapPoint's
        mpReplaced). Without this, a fuse burst — e.g. the mass duplicate
        merge when a loop/revisit reconnects two map generations — silently
        drops most of the motion-model candidate set and tracking collapses
        (r4 walk-revisit root cause: n1 370→9 across four frames)."""
        lf = self.last_frame
        if lf is None:
            return
        m = self.map
        fm = lf.feat_mp
        pos = np.nonzero(fm >= 0)[0]
        if len(pos) == 0:
            return
        ids = fm[pos]
        if m.mp_valid[ids].all():
            return
        fwd = ids.copy()
        for _ in range(4):          # bounded chain resolution
            b = ~m.mp_valid[fwd] & (m.mp_replaced[fwd] >= 0)
            if not b.any():
                break
            fwd[b] = m.mp_replaced[fwd[b]]
        fwd[~m.mp_valid[fwd]] = -1
        fm[pos] = fwd
        # two features forwarding to one survivor: keep the first
        live = np.nonzero(fm >= 0)[0]
        order = live[np.argsort(fm[live], kind="stable")]
        v = fm[order]
        dup = np.zeros(len(order), bool)
        dup[1:] = v[1:] == v[:-1]
        fm[order[dup]] = -1

    def _can_fuse_track(self) -> bool:
        if not (self.state == TrackState.OK and self.use_fused_track
                and self.last_frame is not None
                and self.p.local_passes == 1 and self.p.pose_starts == 1):
            return False
        if self.imu_initialized:
            # visual-inertial fused path (fused_track_vi_pooled): needs a
            # valid per-frame preintegration spanning exactly the frame gap
            # and a tracked previous state to propagate from
            lf = self.last_frame
            return (self.frame_preint is not None
                    and self._frame_preint_covers
                    and lf.tracked and lf.R is not None
                    and self.velocity_w is not None)
        return self.velocity is not None

    def _track(self, frame: Frame, allow_fused: bool = True) -> bool:
        # registered so a mid-frame world transform (IMU init / VIBA gravity-
        # scale refinement) can remap the in-flight pose too (try_imu_init)
        self.current_frame = frame
        self._check_replaced_in_last_frame()
        self._n1_last = None    # motion-model evidence for this frame
        ok = False
        if allow_fused and self._can_fuse_track():
            with self.timer.stage("3f.fused_track"):
                ok = self._track_fused(frame)
        if not ok and self.state == TrackState.OK:
            frame.feat_mp[:] = -1
            with self.timer.stage("3a.pose_prediction"):
                if (self.imu_initialized
                        and self._predict_pose_imu(frame)):
                    ok = self._track_with_prediction(frame)
                if not ok and self.velocity is not None and self.last_frame is not None:
                    ok = self._track_motion_model(frame)
                if not ok:
                    ok = self._track_reference_kf(frame)
        elif not ok:
            if (self.state == TrackState.RECENTLY_LOST and self.imu_initialized
                    and self.lost_ts is not None
                    and frame.ts - self.lost_ts <= self.p.time_recently_lost):
                # IMU dead-reckoning substitutes for relocalization for up to
                # time_recently_lost (reference src/Tracking.cc:2007-2016)
                ok = self._track_recently_lost_imu(frame)
            if not ok:
                # lost: relocalize against recent keyframes (reference
                # Relocalization src/Tracking.cc:4153; candidate source here is
                # recency until the keyframe database lands)
                ok = self._relocalize(frame)
                if not ok and self.try_cross_map_reloc is not None:
                    # relocalizing into a STORED map triggers a map merge
                    # (reference NewDetectCommonRegions merge branch)
                    ok = self.try_cross_map_reloc(frame)

        if ok and not getattr(frame, "_fused_done", False):
            with self.timer.stage("3b.track_local_map"):
                ok = self._track_local_map(frame)
            if (ok and self.p.gate_divergence and self._n1_last is not None
                    and self._n1_last < max(10, 0.1 * self.n_local_inliers)):
                # aliasing-divergence signature (see _fused_consume)
                ok = False

        self._post_track(frame, ok)
        return ok

    def _post_track(self, frame: Frame, ok: bool) -> None:
        """State-machine epilogue shared by the synchronous cascade and the
        pipelined consume: motion model, keyframe policy, loss handling."""
        if ok:
            self.state = TrackState.OK
            frame.tracked = True
            inl_now = float(getattr(self, "n_local_inliers", 0) or 0)
            if inl_now > 0:
                self.inlier_ema = (inl_now if self.inlier_ema is None
                                   else 0.9 * self.inlier_ema + 0.1 * inl_now)
            # world body-velocity estimate for IMU prediction — finite
            # differences ONLY before IMU init; afterwards velocity is a
            # state of the visual-inertial optimizer (reference keeps
            # mCurrentFrame.mVw from PoseInertialOptimization; overwriting it
            # with an FD of noisy positions corrupts the next PredictStateIMU
            # and was the post-init RECENTLY_LOST flicker)
            if (self.imu_enabled and not self.imu_initialized
                    and self.last_frame is not None
                    and self.last_frame.tracked and self.last_frame.R is not None):
                dt = frame.ts - self.last_frame.ts
                if dt > 1e-6:
                    c_now = -frame.R.T @ frame.t
                    c_last = -self.last_frame.R.T @ self.last_frame.t
                    self.velocity_w = ((c_now - c_last) / dt).astype(np.float32)
            # motion model T_cl = T_cw ∘ inv(T_lw) — only from a trustworthy
            # last pose (after a loss gap the reference clears mVelocity too)
            if (self.last_frame is not None and self.last_frame.tracked
                    and self.last_frame.R is not None):
                Rl, tl = self.last_frame.R, self.last_frame.t
                Rli, tli = Rl.T, -Rl.T @ tl
                Rv = frame.R @ Rli
                tv = frame.R @ tli + frame.t
                self.velocity = (Rv, tv)
            else:
                self.velocity = None
            with self.timer.stage("4.new_kf_decision"):
                need_kf = (not self.only_tracking
                           and self._need_new_keyframe(frame))
            if need_kf:
                with self.timer.stage("4b.new_kf_creation"):
                    self._create_new_keyframe(frame)
            self.consecutive_lost = 0
        else:
            self.velocity = None
            self.pose_prior_H = None
            self.inlier_ema = None    # recovery restarts the adaptive gate
            if self.state == TrackState.OK:
                self.lost_ts = frame.ts
            if self.map.n_kf > 10:
                self.state = TrackState.RECENTLY_LOST
            else:
                self.state = TrackState.LOST
            self.consecutive_lost += 1
            # with an initialized IMU the loss window is time-based (the
            # reference's time_recently_lost = 5 s, src/Tracking.cc:2044);
            # visual-only gives up after frames_to_new_map frames
            if self.imu_initialized and self.lost_ts is not None:
                new_map_due = (frame.ts - self.lost_ts
                               > self.p.time_recently_lost)
            else:
                new_map_due = self.consecutive_lost >= self.frames_to_new_map
            if new_map_due and self.on_tracking_lost is not None:
                self.on_tracking_lost()
                self.consecutive_lost = 0

    def reset_for_new_map(self, new_map: MapState):
        """Re-point the tracker at a fresh (or merged) map."""
        self.map = new_map
        self.state = (TrackState.NOT_INITIALIZED if new_map.n_kf == 0
                      else TrackState.RECENTLY_LOST)
        self.init_frame = None
        self.velocity = None
        self.lost_ts = None
        self.ref_kf = int(new_map.valid_kf_ids()[-1]) if new_map.n_kf else -1
        self.kf_preints = {}
        self.preint_since_kf = None
        self.pose_prior_H = None
        self.inlier_ema = None

    def _predict_pose(self, frame: Frame):
        """Motion-model prediction with anchored translation for slow motion.

        The pose is extrapolated by the constant-velocity model only when the
        PREDICTED image motion (rotational + translational, in px) exceeds
        `cv_predict_min_px`; otherwise the frame starts at the last frame's
        pose. Rationale: on low-parallax/frontal-structure views the pose has
        a near-null coupled lateral-translation+yaw direction; seeding and
        match-window placement from an extrapolated pose integrates the
        estimator's own bias along it into a scale-drift runaway (reproduced
        and isolated in scripts/diag_scale2.py — anchored tracking holds map
        scale to <1% over 80 frames where extrapolated tracking diverged 3x;
        extrapolating EITHER component of the coupled pair re-opens the
        runaway). When inter-frame motion is fast enough to need prediction
        for window placement, it is also fast enough to be observable, so
        extrapolation is safe there. The match-window radius (motion_radius,
        with a 2x retry) covers the un-extrapolated motion in the anchored
        regime by construction of the threshold."""
        Rv, tv = self.velocity
        Rl, tl = self.last_frame.R, self.last_frame.t
        # deeper pipelines consume with a lag: extrapolate the per-interval
        # velocity once per skipped frame (frame ids are consecutive)
        steps = max(1, int(frame.frame_id - self.last_frame.frame_id))
        Rp, tp = Rl, tl
        for _ in range(min(steps, 4)):
            Rp, tp = Rv @ Rp, Rv @ tp + tv
        Rp = Rp.astype(np.float32)
        tp = tp.astype(np.float32)
        thresh = self.p.cv_predict_min_px
        if not self._last_track_healthy():
            # anchoring exists to stop an EXTRAPOLATED seed from integrating
            # estimator bias along near-null directions — a protection that
            # presumes tracking is healthy. With a degraded last frame it
            # becomes an attractor: the pose freezes at the last estimate,
            # aliased texture keeps feeding ~50 self-consistent matches, and
            # the frame never escapes (r4 walk-revisit frozen-pose mode).
            thresh = 0.0
        if thresh > 0.0:
            c_p = -Rp.T @ tp
            c_l = -Rl.T @ tl
            zmed = self._last_matched_depth()
            ang = np.arccos(np.clip((np.trace(Rv) - 1.0) / 2.0, -1.0, 1.0))
            px = float(self.K[0]) * (
                float(ang) + float(np.linalg.norm(c_p - c_l)) / max(zmed, 1e-6))
            if px < thresh:
                Rp, tp = Rl.copy(), tl.copy()
        frame.R = Rp
        frame.t = tp

    def _last_matched_depth(self) -> float:
        """Median depth of the last frame's matched map points (in its cam)."""
        lf = self.last_frame
        if lf is None or lf.R is None:
            return 1.0
        mp = lf.feat_mp[lf.feat_mp >= 0]
        mp = mp[self.map.mp_valid[mp]] if len(mp) else mp
        if len(mp) == 0:
            return 1.0
        z = (self.map.mp_xyz[mp] @ lf.R.T + lf.t)[:, 2]
        z = z[z > 1e-6]
        return float(np.median(z)) if len(z) else 1.0

    def _gather_mps(self, mp_ids: np.ndarray, cap: int):
        """Pad/crop map-point SoA to a fixed-size device buffer."""
        m = self.map
        mp_ids = mp_ids[:cap]
        n = len(mp_ids)
        pad = cap - n
        def pk(a, fill=0.0):
            out = a[mp_ids]
            if pad:
                out = np.concatenate([out, np.full((pad,) + out.shape[1:], fill, out.dtype)])
            return out
        xyz = pk(m.mp_xyz)
        desc = pk(m.mp_desc)
        normal = pk(m.mp_normal)
        mind = pk(m.mp_min_dist)
        maxd = pk(m.mp_max_dist, 1.0)
        valid = np.zeros(cap, bool)
        valid[:n] = m.mp_valid[mp_ids]
        return mp_ids, xyz, desc, normal, mind, maxd, valid

    def _project_and_assign(self, frame: Frame, mp_ids: np.ndarray, cap: int,
                            radius: float, ratio: float, max_dist: int,
                            view_cos: float = 0.5, count_visible: bool = False,
                            in_map: MapState | None = None) -> int:
        """Fused frustum+projection matcher against the device-resident pool:
        uploads pose + one id vector, downloads one packed buffer."""
        m = in_map if in_map is not None else self.map
        mp_ids = np.asarray(mp_ids, np.int32)[:cap]
        mp_ids = mp_ids[m.mp_valid[mp_ids]]
        n = len(mp_ids)
        ids = np.full(cap, -1, np.int32)
        ids[:n] = mp_ids
        pose = np.empty(12, np.float32)
        pose[0:9] = frame.R.reshape(-1)
        pose[9:12] = frame.t
        fn = kernels.projection_assign_pooled(
            self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
            self._cam_key, self._wh_key,
            float(radius), float(ratio), int(max_dist), float(view_cos))
        mpf, mpu = self._mirror_for(m).sync(m)
        dev = frame.dev
        if dev is not None:
            fxy, fdesc, foct, fval = dev.xy, dev.desc, dev.octave, dev.valid
        else:
            fxy, fdesc = jnp.asarray(frame.xy), jnp.asarray(frame.desc)
            foct, fval = jnp.asarray(frame.octave), jnp.asarray(frame.valid)
        out = np.asarray(fn(jnp.asarray(pose), jnp.asarray(ids), mpf, mpu,
                            fxy, fdesc, foct, fval))
        idxn = out[:cap]
        nw = (cap + 31) // 32
        okn = kernels.unpack_bits_host(out[cap: cap + nw], cap)
        sel = np.nonzero(okn)[0]
        sel = sel[sel < n]
        # don't overwrite existing assignments
        free = frame.feat_mp[idxn[sel]] < 0
        sel = sel[free]
        frame.feat_mp[idxn[sel]] = ids[sel]
        if count_visible:
            # reference MapPoint::IncreaseVisible fires only when isInFrustum
            vis = kernels.unpack_bits_host(
                out[cap + nw: cap + 2 * nw], cap)[:n]
            m.mp_visible[ids[:n][vis]] += 1
        return len(sel)

    def _optimize_frame_pose(self, frame: Frame, in_map: MapState | None = None) -> int:
        m = in_map if in_map is not None else self.map
        matched = frame.feat_mp >= 0
        # visual-inertial frame optimization once IMU-initialized (reference
        # TrackLocalMap switches to PoseInertialOptimizationLastFrame,
        # src/Tracking.cc:3421 area)
        if (self.imu_initialized and in_map is None
                and self.frame_preint is not None
                and self.last_frame is not None and self.last_frame.tracked
                and self.last_frame.R is not None
                and self.velocity_w is not None
                and abs(float(self.frame_preint.dT)
                        - (frame.ts - self.last_frame.ts)) < 0.02):
            mp = frame.feat_mp.copy()
            pts = np.zeros((len(mp), 3), np.float32)
            pts[matched] = m.mp_xyz[mp[matched]]
            snap_R = None if frame.R is None else frame.R.copy()
            snap_t = None if frame.t is None else frame.t.copy()
            inl = self._optimize_frame_pose_vi(
                frame, pts, matched, self.inv_sigma2[frame.octave])
            if inl >= 15 or (0 <= inl and matched.sum() < 30):
                return inl
            if inl >= 0:
                # inertial solve collapsed despite plentiful visual matches
                # (stale prior/velocity, e.g. right after the IMU-init world
                # transform): drop the marginal prior and fall through to the
                # visual-only solve for this frame (the reference's recovery
                # is coarser — it resets the whole IMU after
                # mnFramesToResetIMU of failures, src/Tracking.cc:3443-3454)
                self.pose_prior_H = None
                frame.feat_mp = mp
                matched = frame.feat_mp >= 0
                if snap_R is not None:
                    frame.R = snap_R
                    frame.t = snap_t
        # anchor the weak prior at the LAST tracked pose (not the motion-model
        # seed) — see TrackingParams.pose_prior_eps
        lf = self.last_frame
        use_prior = (lf is not None and lf is not frame and lf.tracked
                     and lf.R is not None and self.p.pose_prior_eps > 0.0
                     and self._last_track_healthy())
        if use_prior:
            pR, pt = lf.R, lf.t
            eps = self.p.pose_prior_eps
        else:
            pR, pt = frame.R, frame.t
            eps = 0.0
        if (in_map is None and frame.dev is not None
                and self.p.pose_starts == 1):
            # pooled path: world points gathered on device by feat_mp ids
            pose_in = np.empty(25, np.float32)
            pose_in[0:9] = frame.R.reshape(-1)
            pose_in[9:12] = frame.t
            pose_in[12:21] = np.asarray(pR).reshape(-1)
            pose_in[21:24] = pt
            pose_in[24] = eps
            mpf, _ = self._mirror_for(m).sync(m)
            dev = frame.dev
            out = np.asarray(self.pose_opt_pooled(
                jnp.asarray(pose_in), jnp.asarray(frame.feat_mp), mpf,
                dev.xy, dev.octave, dev.valid, jnp.asarray(frame.ur)))
            Rn = out[0:9].view(np.float32).reshape(3, 3).copy()
            tn = out[9:12].view(np.float32).copy()
            if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
                return 0
            frame.R = Rn
            frame.t = tn
            N = len(frame.feat_mp)
            inl = kernels.unpack_bits_host(out[13: 13 + (N + 31) // 32], N)
            frame.feat_mp[matched & ~inl] = -1
            return int(out[12])
        mp = frame.feat_mp.copy()
        pts = np.zeros((len(mp), 3), np.float32)
        pts[matched] = m.mp_xyz[mp[matched]]
        inv_s2 = self.inv_sigma2[frame.octave]
        res = self.pose_opt(
            jnp.asarray(frame.R), jnp.asarray(frame.t), jnp.asarray(pts),
            jnp.asarray(frame.xy), jnp.asarray(inv_s2, jnp.float32),
            jnp.asarray(matched & frame.valid), jnp.asarray(self.cam_params),
            jnp.asarray(frame.ur), jnp.asarray(self.bf, jnp.float32),
            jnp.asarray(pR), jnp.asarray(pt), jnp.asarray(eps, jnp.float32))
        frame.R = np.asarray(res.R)
        frame.t = np.asarray(res.t)
        inl = np.asarray(res.inlier)
        # clear outlier assignments (reference discards them after PoseOptimization)
        frame.feat_mp[matched & ~inl] = -1
        return int(inl.sum())

    def _optimize_frame_pose_vi(self, frame: Frame, pts, matched, inv_s2) -> int:
        """Visual-inertial frame pose+velocity optimization against the last
        frame's state through the per-frame preintegration (reference
        PoseInertialOptimizationLastFrame src/Optimizer.cc:7785)."""
        from ..ops import imu as imu_ops, vi_ba as vi_ops
        import functools
        import jax
        pre = self.frame_preint
        lf = self.last_frame
        dR_c, dV_c, dP_c = imu_ops.corrected_delta(
            pre, jnp.asarray(self.imu_bias_g), jnp.asarray(self.imu_bias_a))
        if not hasattr(self, "_pi_jit"):
            self._pi_jit = {}
        use_prior = self.pose_prior_H is not None
        if use_prior not in self._pi_jit:
            # ONE packed int32 result (poses/vel/H_marg bitcast + n_inliers +
            # packbits(inlier)) — one device→host pull instead of five
            sig_gw, sig_aw = float(self.imu_noise[2]), float(self.imu_noise[3])

            def _packed(*a, **kw):
                res = vi_ops.pose_inertial_optimize(
                    *a, cam_type=self.cam_type,
                    sigma_gw=sig_gw, sigma_aw=sig_aw, **kw)
                from . import kernels as _k
                return jnp.concatenate([
                    _k._bitcast_f2i(res.R.reshape(-1)),
                    _k._bitcast_f2i(res.t),
                    _k._bitcast_f2i(res.v),
                    _k._bitcast_f2i(res.bg),
                    _k._bitcast_f2i(res.ba),
                    _k._bitcast_f2i(res.H_marg.reshape(-1)),
                    res.n_inliers.astype(jnp.int32)[None],
                    _k._pack_bits_i32(res.inlier),
                ])
            if use_prior:
                self._pi_jit[True] = jax.jit(
                    lambda *a, prior_H: _packed(*a, prior_H=prior_H))
            else:
                self._pi_jit[False] = jax.jit(_packed)
        args = (
            jnp.asarray(frame.R), jnp.asarray(frame.t),
            jnp.asarray(self.velocity_w),
            jnp.asarray(lf.R.T), jnp.asarray(-lf.R.T @ lf.t),
            jnp.asarray(self.velocity_w),
            jnp.asarray(self.imu_bias_g), jnp.asarray(self.imu_bias_a),
            pre.dT, dR_c, dV_c, dP_c,
            pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, pre.C[:9, :9],
            jnp.asarray(pts), jnp.asarray(frame.xy),
            jnp.asarray(inv_s2, jnp.float32),
            jnp.asarray(matched & frame.valid), jnp.asarray(self.cam_params))
        if use_prior:
            pH = self.pose_prior_H
            # H_marg's bias blocks are expressed in walk-scaled units
            # sb = σ_walk·sqrt(dT) of the frame they were built for; if the
            # frame interval changed (dropped frames, recently-lost gaps) the
            # carried information must be rescaled to the new units
            # (information transforms as D·H·D with D = sb_new/sb_old on the
            # bias coordinates; advisor r4 low)
            dT_prev = getattr(self, "pose_prior_dT", None)
            dT_now = max(float(pre.dT), 1e-3)
            if dT_prev is not None and abs(dT_prev - dT_now) > 1e-6:
                r = np.sqrt(dT_now / max(dT_prev, 1e-3))
                d = np.ones(15, np.float32)
                d[9:15] = r
                pH = pH * d[:, None] * d[None, :]
            out = np.asarray(self._pi_jit[True](
                *args, prior_H=jnp.asarray(pH, jnp.float32)))
        else:
            out = np.asarray(self._pi_jit[False](*args))
        Rn = out[0:9].view(np.float32).reshape(3, 3).copy()
        tn = out[9:12].view(np.float32).copy()
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            self.pose_prior_H = None
            return -1
        frame.R = Rn
        frame.t = tn
        self.velocity_w = out[12:15].view(np.float32).copy()
        bgn = out[15:18].view(np.float32)
        ban = out[18:21].view(np.float32)
        if np.isfinite(bgn).all() and np.isfinite(ban).all():
            # frame-rate bias tracking through the RW chain + marginal prior
            # (reference keeps the optimized frame bias, src/Tracking.cc)
            self.imu_bias_g = bgn.astype(np.float32).copy()
            self.imu_bias_a = ban.astype(np.float32).copy()
        # carry the marginalized information to the next frame (reference
        # builds mpcpi = new ConstraintPoseImu from the 15×15 marginal
        # Hessian, include/G2oTypes.h:711)
        import os as _os
        Hm = out[21:246].view(np.float32).reshape(15, 15)
        if np.isfinite(Hm).all() and not _os.environ.get("DBG_NO_VIPRIOR"):
            self.pose_prior_H = Hm.astype(np.float32)
            self.pose_prior_dT = max(float(pre.dT), 1e-3)
        else:
            self.pose_prior_H = None
        n_inl = int(out[246])
        N = len(frame.feat_mp)
        inl = kernels.unpack_bits_host(out[247: 247 + (N + 31) // 32], N)
        frame.feat_mp[matched & ~inl] = -1
        return n_inl

    def _track_recently_lost_imu(self, frame: Frame) -> bool:
        """Dead-reckon on the IMU while RECENTLY_LOST and try to re-acquire
        visually (reference src/Tracking.cc:2007-2016: with an initialized IMU
        the predicted state substitutes for relocalization for up to
        time_recently_lost seconds; TrackLocalMap then re-acquires). Even when
        re-acquisition fails the frame keeps the predicted pose, so the
        dead-reckon chain — and the exported trajectory — stays continuous."""
        if not self._predict_pose_imu(frame, allow_untracked=True):
            return False
        m = self.map
        p = self.p
        if self.ref_kf < 0 or not m.kf_valid[self.ref_kf]:
            return False
        kfs = np.unique(np.concatenate(
            [[self.ref_kf], m.best_covisible(self.ref_kf, 10)])).astype(np.int64)
        mps = m.local_map_points(kfs)
        if len(mps) == 0:
            return False
        # wider window than motion-model tracking: the prediction has drifted
        n = self._project_and_assign(frame, mps, p.max_local_mps,
                                     2.0 * p.motion_radius, p.motion_ratio,
                                     p.th_high)
        if n < p.min_motion_matches:
            return False
        inl = self._optimize_frame_pose(frame)
        return inl >= p.min_motion_inliers

    def _frame_gap(self, frame: Frame) -> float:
        lf = self.last_frame
        return float(frame.ts - lf.ts) if lf is not None else 0.05

    def _frame_ur_dev(self, frame: Frame):
        """Device right-x vector for the fused kernels: the pipelined stereo
        front end keeps it on device (no host round trip); otherwise upload
        the host mirror."""
        ur_dev = getattr(frame, "_ur_dev", None)
        return ur_dev if ur_dev is not None else jnp.asarray(frame.ur)

    def _ensure_stereo_host(self, frame: Frame) -> None:
        """Materialize the host ur/depth of a pipelined stereo frame (kept
        device-resident for the fused dispatch; host code — keyframe
        creation's close-point spawning, stereo init, the staged fallback —
        needs the numpy mirrors)."""
        ur_dev = getattr(frame, "_ur_dev", None)
        if ur_dev is None:
            return
        urn = np.asarray(ur_dev)
        disp = frame.xy[:, 0] - urn
        okn = (urn >= 0) & (disp > 0.1)
        frame.ur = np.where(okn, urn, -1.0).astype(np.float32)
        frame.depth = np.where(
            okn, self.bf / np.maximum(disp, 1e-6), -1.0).astype(np.float32)
        frame._ur_dev = None

    def _get_fused_track_vi(self):
        """Lazily build the fused VI tracking kernel (compiled only when a
        map actually reaches the IMU-initialized state)."""
        if self._fused_track_vi is None:
            depth = max(1, int(getattr(self.p, "pipeline_depth", 1)))
            r_scale = 1.0 + 0.5 * (depth - 1)
            self._fused_track_vi = kernels.fused_track_vi_pooled(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
                self._cam_key, self._wh_key, float(self.bf),
                float(self.p.motion_radius * r_scale),
                float(self.p.local_radius * r_scale),
                float(self.p.motion_ratio), float(self.p.local_ratio),
                int(self.p.th_high),
                float(self.imu_noise[2]), float(self.imu_noise[3]))
        return self._fused_track_vi

    def _track_fused(self, frame: Frame) -> bool:
        """One-dispatch visual tracking (kernels.fused_track_pooled): the
        motion-model stage and the local-map stage — two matchings and two
        pose LMs — run as a single device call; the host does prediction,
        candidate gathering, and one bookkeeping pass on the results.

        The local-map candidate set comes from the PREVIOUS reference
        keyframe's covisibility (one-frame lag vs the reference's
        UpdateLocalKeyFrames — the set changes slowly); the reference
        keyframe updates from the returned matches. Falls back (returns
        False) to the staged cascade on thin matches."""
        pend = self._fused_dispatch(frame)
        if pend is None:
            return False
        return self._fused_consume(pend)

    def _fused_dispatch(self, frame: Frame):
        """Host prep + uploads + ONE fused dispatch + async result download.
        Returns a pending record for :meth:`_fused_consume`, or None when the
        fused path does not apply (caller falls back to the staged cascade)."""
        p = self.p
        m = self.map
        lf = self.last_frame
        if self.ref_kf < 0 or not m.kf_valid[self.ref_kf]:
            # reference keyframe culled since last frame: re-anchor on the
            # newest surviving keyframe (reference reassigns mpReferenceKF on
            # SetBadFlag) instead of dropping to the staged fallback
            vk = m.valid_kf_ids()
            if len(vk) == 0:
                return None
            self.ref_kf = int(vk[-1])
        vi = self.imu_initialized
        if not vi:
            self._predict_pose(frame)
        else:
            # IMU prediction happens inside the fused VI kernel; seed the
            # frame pose host-side too so a fused-miss fallback starts sane
            frame.R = lf.R.copy()
            frame.t = lf.t.copy()
        self._check_replaced_in_last_frame()
        last_mps = lf.feat_mp[lf.feat_mp >= 0]
        ids_last = np.unique(last_mps)
        ids_last = ids_last[m.mp_valid[ids_last]]
        if len(ids_last) < p.min_motion_matches:
            return None
        kfs = np.unique(np.concatenate(
            [[self.ref_kf], m.best_covisible(self.ref_kf, p.max_local_kfs - 1)]
        )).astype(np.int64)
        loc_ids = m.local_map_points(kfs)
        loc_ids = loc_ids[~np.isin(loc_ids, ids_last)]

        cap_l = self.orb_cfg.total_capacity
        cap_c = p.max_local_mps
        ids_last = ids_last[:cap_l]
        loc_ids = loc_ids[:cap_c]
        # ONE id upload: [last-frame candidates | local-map candidates]
        ids_packed = np.full(cap_l + cap_c, -1, np.int32)
        ids_packed[: len(ids_last)] = ids_last
        ids_packed[cap_l: cap_l + len(loc_ids)] = loc_ids

        mpf, mpu = self._mirror_for(m).sync(m)
        dev = frame.dev
        if vi:
            # pack the previous body state + biases + carried marginal prior
            # (reference PredictStateIMU inputs + ConstraintPoseImu)
            st = np.empty(247, np.float32)
            R1_wb = lf.R.T
            st[0:9] = R1_wb.reshape(-1)
            st[9:12] = -R1_wb @ lf.t
            st[12:15] = self.velocity_w
            st[15:18] = self.imu_bias_g
            st[18:21] = self.imu_bias_a
            pH = self.pose_prior_H
            if pH is not None:
                dT_prev = getattr(self, "pose_prior_dT", None)
                dT_now = max(self._frame_gap(frame), 1e-3)
                if dT_prev is not None and abs(dT_prev - dT_now) > 1e-6:
                    r = np.sqrt(dT_now / max(dT_prev, 1e-3))
                    d = np.ones(15, np.float32)
                    d[9:15] = r
                    pH = pH * d[:, None] * d[None, :]
                st[21:246] = pH.reshape(-1)
            else:
                # no carried prior (first frame after a keyframe / world
                # transform): anchor the previous state RIGIDLY — the staged
                # path's use_prior=False fixes it outright, and a soft anchor
                # weaker than the visual information lets the previous state
                # absorb inertial residual and corrupts the carried H_marg
                st[21:246] = (1e10 * np.eye(15, dtype=np.float32)).reshape(-1)
            st[246] = p.pose_prior_eps
            out_dev = self._get_fused_track_vi()(
                jnp.asarray(st), jnp.asarray(ids_packed), mpf, mpu,
                dev.xy, dev.desc, dev.octave, dev.valid,
                self._frame_ur_dev(frame), self.frame_preint, cl=cap_l)
        else:
            use_prior = (lf.tracked and lf.R is not None
                         and p.pose_prior_eps > 0.0
                         and self._last_track_healthy())
            pR, pt = (lf.R, lf.t) if use_prior else (frame.R, frame.t)
            eps = p.pose_prior_eps if use_prior else 0.0
            pose_in = np.empty(25, np.float32)
            pose_in[0:9] = frame.R.reshape(-1)
            pose_in[9:12] = frame.t
            pose_in[12:21] = np.asarray(pR).reshape(-1)
            pose_in[21:24] = pt
            pose_in[24] = eps
            out_dev = self.fused_track(
                jnp.asarray(pose_in), jnp.asarray(ids_packed), mpf, mpu,
                dev.xy, dev.desc, dev.octave, dev.valid,
                self._frame_ur_dev(frame), cl=cap_l)
        # pull the packed result in a background thread: np.asarray blocks on
        # the device with the GIL released, so by consume time
        # (next frame) the data has landed and join() is ~free
        import threading
        holder: dict = {}

        def _pull(arr=out_dev, h=holder):
            try:
                h["v"] = np.asarray(arr)
            except Exception as e:   # surfaced at consume
                h["e"] = e
        th = threading.Thread(target=_pull, daemon=True)
        th.start()
        return {"frame": frame, "out": out_dev, "ids": ids_packed,
                "n_loc": len(loc_ids), "cap_l": cap_l, "cap_c": cap_c,
                "map": m, "epoch": m.remap_epoch,
                "thread": th, "holder": holder,
                "vi": vi, "dT": max(self._frame_gap(frame), 1e-3),
                "wepoch": self.world_epoch}

    def _fused_consume(self, pend) -> bool:
        p = self.p
        m = pend["map"]
        frame = pend["frame"]
        cap_l = pend["cap_l"]
        cap_c = pend["cap_c"]
        ids_packed = pend["ids"]
        nc = pend["n_loc"]
        loc_ids = ids_packed[cap_l: cap_l + nc]
        N = self.orb_cfg.total_capacity
        th = pend.get("thread")
        if th is not None:
            th.join()
            holder = pend["holder"]
            if "e" in holder:
                raise holder["e"]
            out = holder["v"]
        else:
            out = np.asarray(pend["out"])
        Rn = out[0:9].view(np.float32).reshape(3, 3).copy()
        tn = out[9:12].view(np.float32).copy()
        n1 = int(out[12])
        inl = int(out[13])
        min_inl = self._min_local_inliers()
        import os as _os
        if _os.environ.get("DBG_TRACK_VERBOSE"):
            print(f"    [fused] f{frame.frame_id} n1={n1} inl={inl} "
                  f"min={min_inl} nc={nc} ref_kf={self.ref_kf}", flush=True)
        if n1 < p.min_motion_matches or inl < min_inl:
            return False
        if self.p.gate_divergence and n1 < max(10, 0.1 * inl):
            # aliasing-divergence signature: the frame barely re-finds the
            # LAST frame's own points (tight-window, same-view matching is
            # alias-resistant) while the wide local-map search still reports
            # "inliers" — the walk-revisit frozen state ran for 20+ frames
            # at n1 ~2 / inl ~70. Treat as failure; reloc re-acquires.
            return False
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            return False
        frame.R = Rn
        frame.t = tn
        al = out[14: 14 + N]
        ac = out[14 + N: 14 + 2 * N]
        off = 14 + 2 * N
        nw_f = (cap_c + 31) // 32
        frustum_bits = out[off: off + nw_f]
        if pend.get("vi"):
            # unpack + adopt the inertial state (velocity, biases, carried
            # 15-dim marginal prior — reference PoseInertialOptimizationLast
            # Frame keeps mVw/biases and builds mpcpi, src/Optimizer.cc:7785)
            off_vi = off + nw_f + (N + 31) // 32
            vi_f = out[off_vi: off_vi + 234].view(np.float32)
            v = vi_f[0:3]
            bgn = vi_f[3:6]
            ban = vi_f[6:9]
            Hm = vi_f[9:234].reshape(15, 15)
            if not np.isfinite(v).all():
                return False
            self.velocity_w = v.astype(np.float32).copy()
            if np.isfinite(bgn).all() and np.isfinite(ban).all():
                self.imu_bias_g = bgn.astype(np.float32).copy()
                self.imu_bias_a = ban.astype(np.float32).copy()
            import os as _os2
            if np.isfinite(Hm).all() and not _os2.environ.get("DBG_NO_VIPRIOR"):
                self.pose_prior_H = Hm.astype(np.float32).copy()
                self.pose_prior_dT = pend["dT"]
            else:
                self.pose_prior_H = None
        frame.feat_mp[:] = -1
        sel_l = al >= 0
        frame.feat_mp[sel_l] = ids_packed[al[sel_l]]
        sel_c = ac >= 0
        sel_c &= ac < nc
        frame.feat_mp[sel_c] = ids_packed[cap_l + ac[sel_c]]
        # found/visible counters (reference IncreaseFound/IncreaseVisible)
        vis = kernels.unpack_bits_host(frustum_bits, cap_c)[:nc]
        m.mp_visible[loc_ids[vis]] += 1
        found = frame.feat_mp[frame.feat_mp >= 0]
        m.mp_found[found] += 1
        m.mp_visible[found] += 1
        # reference keyframe ← most-shared observer of the matches
        kf_idx, _ = m.observations_of(np.unique(found))
        if len(kf_idx):
            counts = np.bincount(kf_idx, minlength=m.n_kf)
            self.ref_kf = int(np.argmax(counts))
        self.n_local_inliers = inl
        frame._fused_done = True
        if pend.get("vi"):
            self.path_counts["fused_vi"] += 1
        return True

    def _min_local_inliers(self) -> int:
        """Reference TrackLocalMap acceptance (src/Tracking.cc:3421-3454):
        50 right after a relocalization, 15 with an initialized IMU, else the
        visual threshold (30) — PLUS an adaptive floor at 20% of the running
        inlier average. A divergence that settles into an aliased-match
        equilibrium (measured: a pitch runaway at the walk's phase wrap kept
        ~70 'inliers' while 550 were available) passes any absolute gate;
        relative collapse is the reliable failure signal, and declaring the
        frame lost hands recovery to relocalization, which re-acquires from
        descriptors instead of a poisoned projection window."""
        if self.frames_since_reloc is not None and \
                0 <= self.n_frames - 1 - self._last_reloc_frame_id < self.p.max_frames_between_kf:
            return max(self.p.min_local_inliers, 50)
        if self.imu_initialized:
            return 15
        base = self.p.min_local_inliers
        ema = self.inlier_ema
        if self.p.gate_ema_floor and ema is not None and ema > 3.0 * base:
            return max(base, int(0.2 * ema))
        return base

    def _track_with_prediction(self, frame: Frame) -> bool:
        """Track against last-frame points from an already-set predicted pose
        (IMU prediction path — reference TrackWithMotionModel with
        PredictStateIMU)."""
        p = self.p
        last_mps = self.last_frame.feat_mp
        mp_ids = np.unique(last_mps[last_mps >= 0])
        mp_ids = mp_ids[self.map.mp_valid[mp_ids]]
        if len(mp_ids) == 0:
            return False
        cap = self.orb_cfg.total_capacity
        n = self._project_and_assign(frame, mp_ids, cap, p.motion_radius,
                                     p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            return False
        inl = self._optimize_frame_pose(frame)
        return inl >= p.min_motion_inliers

    def _track_motion_model(self, frame: Frame) -> bool:
        p = self.p
        self._predict_pose(frame)
        last_mps = self.last_frame.feat_mp
        mp_ids = np.unique(last_mps[last_mps >= 0])
        mp_ids = mp_ids[self.map.mp_valid[mp_ids]]
        if len(mp_ids) == 0:
            return False
        cap = self.orb_cfg.total_capacity
        n = self._project_and_assign(frame, mp_ids, cap, p.motion_radius,
                                     p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            frame.feat_mp[:] = -1
            n = self._project_and_assign(frame, mp_ids, cap, 2 * p.motion_radius,
                                         p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            return False
        inl = self._optimize_frame_pose(frame)
        ok = inl >= p.min_motion_inliers
        # record motion-model evidence ONLY when this pose is the one the
        # frame proceeds with — if this attempt fails and _track_reference_kf
        # rescues the frame, the divergence gate in _track must not see the
        # stale failed-attempt inlier count (it would reject a healthy
        # reference-KF recovery; advisor r4 high finding)
        if ok:
            self._n1_last = inl
        return ok

    def _track_reference_kf(self, frame: Frame) -> bool:
        from ..ops import matching as match_ops
        p = self.p
        if self.ref_kf < 0:
            return False
        m = self.map
        k = self.ref_kf
        idx, best, ok = kernels.init_matcher()(
            jnp.asarray(m.kf_feat_desc[k]), jnp.asarray(m.kf_feat_valid[k] & (m.kf_feat_mp[k] >= 0)),
            jnp.asarray(m.kf_feat_xy[k]), jnp.asarray(m.kf_feat_angle[k]),
            jnp.asarray(frame.desc), jnp.asarray(frame.valid),
            jnp.asarray(frame.xy), jnp.asarray(frame.angle))
        okn = np.asarray(ok)
        idxn = np.asarray(idx)
        if okn.sum() < 15:
            return False
        frame.feat_mp[:] = -1
        src = np.nonzero(okn)[0]
        frame.feat_mp[idxn[src]] = m.kf_feat_mp[k][src]
        # initial pose = last frame's
        frame.R = self.last_frame.R.copy() if self.last_frame.R is not None else m.kf_R[k].copy()
        frame.t = self.last_frame.t.copy() if self.last_frame.t is not None else m.kf_t[k].copy()
        inl = self._optimize_frame_pose(frame)
        return inl >= p.min_motion_inliers

    def _relocalize(self, frame: Frame, n_candidates: int = 8,
                    in_map: MapState | None = None) -> bool:
        """Try recent KFs as relocalization anchors: descriptor-match the KF's
        map-point features to the frame (ratio 0.75 like the reference's reloc
        BoW stage), then pose-optimize from the KF pose; accept >= min inliers."""
        from ..ops import matching as match_ops
        import jax.numpy as jnp
        m = in_map if in_map is not None else self.map
        cands = list(m.valid_kf_ids()[::-1][:n_candidates])
        # BoW inverted-file candidates first when a database is bound
        # (reference DetectRelocalizationCandidates, src/Tracking.cc:4163);
        # recent KFs remain the fallback anchors
        if self.reloc_candidates_fn is not None and in_map is None:
            try:
                bow_cands = self.reloc_candidates_fn(frame.desc, frame.valid)
                cands = [int(c) for c in bow_cands] + \
                    [c for c in cands if int(c) not in set(map(int, bow_cands))]
            except Exception as e:   # keep reloc alive, but surface the defect
                from ..utils import verbose
                verbose.print_mess(
                    f"relocalization candidate query failed: {e!r}",
                    verbose.NORMAL)
        for k in cands:
            k = int(k)
            has_mp = m.kf_feat_valid[k] & (m.kf_feat_mp[k] >= 0)
            if has_mp.sum() < 15:
                continue
            idx, best, ok = match_ops.search_by_descriptor(
                jnp.asarray(m.kf_feat_desc[k]), jnp.asarray(has_mp),
                jnp.asarray(frame.desc), jnp.asarray(frame.valid),
                max_dist=match_ops.TH_LOW, ratio=0.75)
            okn = np.asarray(ok)
            if okn.sum() < 15:
                continue
            idxn = np.asarray(idx)
            frame.feat_mp[:] = -1
            src = np.nonzero(okn)[0]
            frame.feat_mp[idxn[src]] = m.kf_feat_mp[k][src]
            # PnP RANSAC for the initial pose (reference uses MLPnP RANSAC,
            # src/Tracking.cc:4216; the KF's own pose is the fallback seed)
            frame.R = m.kf_R[k].copy()
            frame.t = m.kf_t[k].copy()
            matched = np.nonzero(frame.feat_mp >= 0)[0]
            if len(matched) >= 10:
                from ..ops import camera as cam_ops, pnp as pnp_ops
                xw = m.mp_xyz[frame.feat_mp[matched]]
                rays = np.asarray(cam_ops.unproject(
                    self.cam_type, jnp.asarray(self.cam_params),
                    jnp.asarray(frame.xy[matched])))
                rand = self.rng.integers(0, len(matched), (128, 6)).astype(np.int32)
                res = pnp_ops.pnp_ransac(
                    jnp.asarray(xw.astype(np.float32)), jnp.asarray(rays),
                    jnp.ones(len(matched), bool), jnp.asarray(rand),
                    jnp.asarray(self.inv_sigma2[frame.octave[matched]], jnp.float32),
                    focal=float(self.K[0]))
                if bool(res.success):
                    # ML refinement on the RANSAC inliers (reference
                    # MLPnPsolver's covariance-weighted bearing GN,
                    # src/MLPnPsolver.cpp; camera-model-free — exact for
                    # fisheye relocalization too)
                    Rr, tr_ = pnp_ops.mlpnp_refine(
                        jnp.asarray(xw.astype(np.float32)), jnp.asarray(rays),
                        jnp.asarray((self.inv_sigma2[frame.octave[matched]]
                                     * float(self.K[0]) ** 2).astype(np.float32)),
                        res.inliers, res.R, res.t)
                    Rr = np.asarray(Rr)
                    tr_ = np.asarray(tr_)
                    if np.isfinite(Rr).all() and np.isfinite(tr_).all():
                        frame.R = Rr
                        frame.t = tr_
                    else:
                        frame.R = np.asarray(res.R)
                        frame.t = np.asarray(res.t)
            inl = self._optimize_frame_pose(frame, in_map=m)
            if inl < self.p.min_local_inliers and inl >= 10:
                # guided-matching rescue (reference src/Tracking.cc:4293-4345):
                # a near-miss candidate gets two SearchByProjection rounds
                # around the optimized pose — wide (radius 10 px) then narrow
                # (3 px) — each followed by a re-optimization, instead of
                # being rejected on the single pose-opt verdict
                group = np.concatenate(
                    [[k], m.best_covisible(k, 10, min_weight=15)])
                mps = m.local_map_points(group.astype(np.int32))
                for radius in (10.0, 3.0):
                    if len(mps) == 0:
                        break
                    added = self._project_and_assign(
                        frame, mps, 2048, radius=radius, ratio=0.9,
                        max_dist=match_ops.TH_HIGH, in_map=m)
                    if added == 0:
                        continue
                    inl = self._optimize_frame_pose(frame, in_map=m)
                    if inl >= self.p.min_local_inliers:
                        break
            if inl >= self.p.min_local_inliers:
                self.ref_kf = k
                self.frames_since_reloc = 0
                self._last_reloc_frame_id = frame.frame_id
                return True
        return False

    def _track_local_map(self, frame: Frame) -> bool:
        p = self.p
        m = self.map
        # local KFs: those sharing points with the frame, ranked by shared count
        mps = frame.feat_mp[frame.feat_mp >= 0]
        if len(mps) == 0:
            return False
        kf_idx, feat_idx = m.observations_of(mps)
        if len(kf_idx) == 0:
            return False
        counts = np.bincount(kf_idx, minlength=m.n_kf)
        local_kfs = np.argsort(-counts)[: p.max_local_kfs]
        local_kfs = local_kfs[counts[local_kfs] > 0]
        best_kf = int(local_kfs[0])
        self.ref_kf = best_kf

        local_mps = m.local_map_points(local_kfs)
        # exclude already matched
        new_mps = local_mps[~np.isin(local_mps, mps)]
        self._project_and_assign(frame, new_mps, p.max_local_mps,
                                 p.local_radius, p.local_ratio, p.th_high,
                                 count_visible=True)
        inl = self._optimize_frame_pose(frame)
        # re-match at the refined pose + re-optimize: the first optimization's
        # outlier censoring can capture the pose in a drifted local minimum
        # (the motion prediction biases the first matching window); matching
        # again from the refined pose recovers the censored observations.
        # The reference gets this effect from its motion→local two-stage
        # cascade; one extra pass measurably removes a drift-runaway mode on
        # low-parallax sequences (scripts/sweep_tracking.py).
        for _ in range(max(0, self.p.local_passes - 1)):
            frame.feat_mp[:] = -1
            self._project_and_assign(frame, local_mps, p.max_local_mps,
                                     p.local_radius, p.local_ratio, p.th_high)
            inl = self._optimize_frame_pose(frame)
        # found counters (reference IncreaseFound in TrackLocalMap)
        found = frame.feat_mp[frame.feat_mp >= 0]
        m.mp_found[found] += 1
        m.mp_visible[found] += 1
        self.n_local_inliers = inl
        return inl >= self._min_local_inliers()

    # ------------------------------------------------------------------
    # keyframe policy
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference NeedNewKeyFrame (src/Tracking.cc:3468-3643): the full
        c1a/c1b/c1c/c2 | c3/c4 condition set with the pre-IMU-init 0.25 s
        cadence, the reloc guard, and the close-point triggers."""
        p = self.p
        m = self.map
        if self.ref_kf < 0:
            return False
        last_kf_ts = float(m.kf_ts[self.ref_kf])
        if self.last_kf_frame_id >= 0:
            # ref_kf may be an older covisible KF; prefer the true last-KF ts
            last_kf_ts = max(last_kf_ts, self._last_kf_ts)
        # pre-IMU-init inertial cadence: insert every 0.25 s (:3472-3475)
        if self.imu_enabled and not self.imu_initialized:
            return frame.ts - last_kf_ts >= 0.25
        if p.kf_interval_override > 0:
            # fixed-interval cadence for synthetic fixtures (round-1 policy)
            ref_mps0 = m.kf_feat_mp[self.ref_kf]
            ref_mps0 = ref_mps0[ref_mps0 >= 0]
            ref_mps0 = ref_mps0[m.mp_valid[ref_mps0]]
            # reference nRefMatches counts only >= minObs-observed points
            # (KeyFrame::TrackedMapPoints, src/Tracking.cc:3509-3523) —
            # without it, a fresh keyframe's 2-obs triangulations inflate
            # n_ref0 and c2 fires every frame (insert→cull churn)
            if len(ref_mps0):
                min_obs0 = 3 if int(m.kf_valid[: m.n_kf].sum()) > 2 else 2
                ref_mps0 = ref_mps0[m.obs_count(ref_mps0) >= min_obs0]
            n_ref0 = max(len(ref_mps0), 1)
            n_tr = frame.n_matched()
            c1 = frame.frame_id >= self.last_kf_frame_id + p.kf_interval_override
            c2 = (n_tr < p.ref_ratio * n_ref0) and n_tr > 15
            if not (c1 or c2):
                return False
            return self.mapper_accepting is None or self.mapper_accepting()
        # reloc guard: wait mMaxFrames frames after a relocalization when the
        # map is already dense (:3502-3506)
        n_kfs = int(m.kf_valid[: m.n_kf].sum())
        if (frame.frame_id < self._last_reloc_frame_id + p.max_frames_between_kf
                and n_kfs > p.max_frames_between_kf):
            return False
        # nRefMatches = ref-KF map points with >= minObs observations
        # (reference KeyFrame::TrackedMapPoints, src/Tracking.cc:3509-3523)
        ref_mps = m.kf_feat_mp[self.ref_kf]
        ref_mps = ref_mps[ref_mps >= 0]
        ref_mps = ref_mps[m.mp_valid[ref_mps]]
        min_obs = 3 if n_kfs > 2 else 2
        if len(ref_mps):
            ref_mps = ref_mps[m.obs_count(ref_mps) >= min_obs]
        n_ref = max(len(ref_mps), 1)
        n_tracked = getattr(self, "n_local_inliers", frame.n_matched())
        idle = self.mapper_accepting is None or self.mapper_accepting()
        # close-point triggers (stereo/RGB-D only, :3527-3546)
        is_mono = self.bf <= 0
        need_close = False
        if not is_mono and self.th_depth > 0:
            self._ensure_stereo_host(frame)   # pipelined stereo: depth is lazy
            close = (frame.depth > 0) & (frame.depth < self.th_depth)
            n_tracked_close = int((close & (frame.feat_mp >= 0)).sum())
            n_untracked_close = int((close & (frame.feat_mp < 0)).sum())
            need_close = (n_tracked_close < 100) and (n_untracked_close > 70)
        # thRefRatio (:3551-3569)
        th_ref = 0.75
        if n_kfs < 2:
            th_ref = 0.4
        elif is_mono and not self.imu_enabled:
            th_ref = p.ref_ratio          # mono: 0.9
        elif self.rig is not None:
            th_ref = 0.75
        elif self.imu_enabled and is_mono:
            th_ref = 0.75 if n_tracked > 350 else 0.9
        c1a = frame.frame_id >= self.last_kf_frame_id + p.max_frames_between_kf
        c1b = (frame.frame_id >= self.last_kf_frame_id + p.min_frames_between_kf
               and idle)
        c1c = (not is_mono and not self.imu_enabled
               and (n_tracked < 0.25 * n_ref or need_close))
        c2 = ((n_tracked < th_ref * n_ref or need_close) and n_tracked > 15)
        # inertial temporal/rescue triggers (:3585-3607)
        c3 = self.imu_enabled and (frame.ts - last_kf_ts >= 0.5)
        c4 = (self.imu_enabled and is_mono
              and (15 < n_tracked < 75
                   or self.state == TrackState.RECENTLY_LOST))
        if not (((c1a or c1b or c1c) and c2) or c3 or c4):
            return False
        if idle:
            return True
        # mapper busy: non-mono may still queue (<3 gate lives in
        # mapper_accepting, reference :3626); mono never does (:3637)
        return False

    def _create_new_keyframe(self, frame: Frame):
        m = self.map
        self._ensure_stereo_host(frame)
        k = m.add_keyframe(frame.R, frame.t, frame.ts, frame.frame_id,
                           frame.xy, frame.angle, frame.octave, frame.desc,
                           frame.valid, feat_mp=frame.feat_mp.copy(),
                           ur=frame.ur, depth=frame.depth, uvr=frame.uvr)
        if self.bf > 0:
            self._spawn_close_points(frame, k)
            m.kf_feat_mp[k] = frame.feat_mp
        if self.imu_enabled and self.preint_since_kf is not None:
            self.kf_preints[k] = self.preint_since_kf
            self.preint_since_kf = None
        # after a keyframe the mapper re-optimizes the local window: the
        # frame-to-frame marginal prior is stale (reference switches to
        # PoseInertialOptimizationLastKeyFrame there)
        self.pose_prior_H = None
        if self.imu_enabled and self.velocity_w is not None:
            m.kf_vel[k] = self.velocity_w
            m.kf_bias_g[k] = self.imu_bias_g
            m.kf_bias_a[k] = self.imu_bias_a
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        self._last_kf_ts = frame.ts
        # IMU init + VIBA staging run in the mapper (reference
        # src/LocalMapping.cc:211-288); keep a synchronous fallback when no
        # mapper is wired
        if (self.imu_enabled and not self.imu_initialized
                and self.on_new_keyframe is None):
            self.try_imu_init()
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k, initial=False)
            # NOTE: deliberately do NOT copy the BA-adjusted KF pose back into
            # the live frame — doing so feeds window-BA gauge wobble into the
            # velocity model and can seed a pose-opt local-minimum runaway
            # (found empirically; the reference's Tracking also keeps its own
            # frame pose and only consumes corrections via the map points)

    # ------------------------------------------------------------------
    # trajectory
    # ------------------------------------------------------------------
    def _log_trajectory(self, frame: Frame, tracked: bool):
        if frame.R is None or self.ref_kf < 0:
            self.trajectory.append((frame.ts, -1, None, None, True))
            return
        m = self.map
        k = self.ref_kf
        # T_cr = T_cw ∘ inv(T_rw)
        Rr, tr = m.kf_R[k], m.kf_t[k]
        Rri, tri = Rr.T, -Rr.T @ tr
        Rcr = frame.R @ Rri
        tcr = frame.R @ tri + frame.t
        self.trajectory.append((frame.ts, k, Rcr, tcr, not tracked))

    def freeze_trajectory(self, mark_lost: bool = False):
        """Convert map-relative trajectory entries into absolute poses before
        the tracker leaves the map they reference (Atlas loss-spawn / switch).
        Frozen entries (k = -2, storing T_cw directly) stop receiving BA
        corrections — their map is retired, so none will come (the reference
        equivalently walks mlpReferences into stored maps at save time and
        marks reset-map frames lost, src/System.cc:612-640, Tracking reset).
        ``mark_lost`` flags them lost (map wiped rather than stored)."""
        m = self.map
        out = []
        for (ts, k, Rcr, tcr, lost) in self.trajectory:
            if k >= 0 and Rcr is not None and m.kf_valid[k]:
                Rr, tr_ = m.kf_R[k], m.kf_t[k]
                Rcw = Rcr @ Rr
                tcw = Rcr @ tr_ + tcr
                out.append((ts, -2, Rcw.astype(np.float32),
                            tcw.astype(np.float32), lost or mark_lost))
            elif k >= 0 and Rcr is not None:
                out.append((ts, -1, None, None, True))
            else:
                out.append((ts, k, Rcr, tcr, lost))
        self.trajectory = out

    def remap_trajectory_for_merge(self, kf_map: dict):
        """After an Atlas merge: relative entries reference the pre-merge
        current map — rewrite them to the migrated keyframe ids so they keep
        receiving corrections in the merged map."""
        out = []
        for (ts, k, Rcr, tcr, lost) in self.trajectory:
            if k >= 0:
                nk = kf_map.get(int(k))
                if nk is None:
                    out.append((ts, -1, None, None, True))
                    continue
                k = nk
            out.append((ts, k, Rcr, tcr, lost))
        self.trajectory = out
        # preintegration chain: retired-map keyframe ids must follow the
        # migration or the temporal chain is severed (the reference preserves
        # mPrevKF/mpImuPreintegrated through MergeLocal2,
        # src/LoopClosing.cc:2210-2442); deltas are body-frame metric
        # quantities — ids remap, values don't change
        if self.kf_preints:
            self.kf_preints = {
                kf_map[int(k)]: v for k, v in self.kf_preints.items()
                if int(k) in kf_map}

    def rotate_world_state_for_merge(self, R_align: np.ndarray,
                                     s_align: float = 1.0):
        """Rotate/scale the tracker's world-frame inertial state into the
        merge target's world (x_old = s·R_a·x_cur + t_a)."""
        if self.velocity_w is not None:
            self.velocity_w = (
                s_align * (R_align @ self.velocity_w)).astype(np.float32)

    def reanchor_trajectory(self, k: int):
        """Re-anchor logged frames whose reference keyframe is about to be
        culled onto the nearest surviving keyframe. The reference instead
        walks the spanning tree past bad KFs at save time, accumulating mTcp
        (src/System.cc:612-616); re-anchoring at cull time is equivalent at
        the moment of culling and keeps the entries receiving later BA/loop
        corrections through a LIVE keyframe instead of a frozen pose."""
        m = self.map
        if not any(e[1] == k and e[2] is not None for e in self.trajectory):
            return
        valid = [int(v) for v in m.valid_kf_ids() if int(v) != k]
        if not valid:
            return
        # prefer the spanning-tree parent (reference walks mpParent past bad
        # KFs, src/System.cc:612-616); nearest-timestamp fallback
        par = int(m.kf_parent[k]) if hasattr(m, "kf_parent") else -1
        if par >= 0 and par != k and m.kf_valid[par]:
            r2 = par
        else:
            ts_k = float(m.kf_ts[k])
            r2 = min(valid, key=lambda v: abs(float(m.kf_ts[v]) - ts_k))
        R_k, t_k = m.kf_R[k], m.kf_t[k]
        R_2, t_2 = m.kf_R[r2], m.kf_t[r2]
        R_k2 = R_k @ R_2.T                  # T_k_r2 = T_kw ∘ T_r2w⁻¹
        t_k2 = t_k - R_k2 @ t_2
        for i, (ts_, kk, Rcr, tcr, lost_) in enumerate(self.trajectory):
            if kk == k and Rcr is not None:
                self.trajectory[i] = (
                    ts_, r2, (Rcr @ R_k2).astype(np.float32),
                    (Rcr @ t_k2 + tcr).astype(np.float32), lost_)

    def export_trajectory(self):
        """Compose logged relative poses with (possibly BA-corrected) KF poses
        (reference System::SaveTrajectoryTUM src/System.cc:457-520).
        Returns (ts (F,), R_wc (F,3,3), t_wc (F,3), lost (F,))."""
        m = self.map
        out_ts, out_R, out_t, lost = [], [], [], []
        for ts, k, Rcr, tcr, is_lost in self.trajectory:
            if Rcr is None or k == -1:
                continue
            if k == -2:     # frozen absolute entry (see freeze_trajectory)
                Rcw, tcw = Rcr, tcr
            else:
                Rr, tr = m.kf_R[k], m.kf_t[k]
                Rcw = Rcr @ Rr
                tcw = Rcr @ tr + tcr
            out_ts.append(ts)
            out_R.append(Rcw.T)
            out_t.append(-Rcw.T @ tcw)
            lost.append(is_lost)
        return (np.array(out_ts), np.array(out_R), np.array(out_t),
                np.array(lost, bool))
