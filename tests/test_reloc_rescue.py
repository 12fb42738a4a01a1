"""Relocalization guided-matching rescue (reference src/Tracking.cc:4293-4345):
a near-miss candidate — pose-optimization inliers below the acceptance gate —
gets two SearchByProjection rounds (radius 10 then 3) with re-optimization
instead of an outright rejection."""
import numpy as np
import jax.numpy as jnp

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.models.tracking import TrackState
from orbslam3_jax.models.frame import build_frame
from orbslam3_jax.utils.datasets import RoomScene, walk_trajectory


def _built_system():
    scene = RoomScene(seed=2, n_clutter=4)
    poses = walk_trajectory(40, period=200)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0, tracking_params=dense_tracking_params())
    for i, (R, t) in enumerate(poses):
        slam.track_monocular(scene.render(R, t), ts=i / 20.0)
    slam.tracker.flush_pending()
    assert slam.state == TrackState.OK
    return scene, poses, slam


def test_reloc_rescue_recovers_near_miss():
    scene, poses, slam = _built_system()
    tr = slam.tracker
    # query view: offset from the traversed path (never keyframed)
    R_q, t_q = poses[20]
    c_q = -R_q.T @ t_q + np.array([0.25, 0.1, 0.2])
    t_q = -R_q @ c_q
    img = scene.render(R_q, t_q)
    feats = tr.extract(jnp.asarray(img))
    frame = build_frame(999, 99.0, feats, tr.K, tr.D)

    # count descriptor-stage inliers WITH THE RESCUE DISABLED to place the
    # acceptance gate strictly above them (forcing the near-miss regime)
    orig_project = tr._project_and_assign
    tr._project_and_assign = lambda *a, **k: 0
    probe = build_frame(998, 98.0, feats, tr.K, tr.D)
    base_gate = tr.p.min_local_inliers
    assert tr._relocalize(probe), "fixture sanity: reloc must work at base gate"
    base_inl = probe.n_matched()
    tr.p.min_local_inliers = base_inl + 10

    # 1) without the rescue the candidate is now rejected
    frame_a = build_frame(997, 97.0, feats, tr.K, tr.D)
    assert not tr._relocalize(frame_a)

    # 2) with the rescue, the same near-miss candidate is recovered
    tr._project_and_assign = orig_project
    rescue_calls = []

    def counting_project(*a, **k):
        rescue_calls.append(1)
        return orig_project(*a, **k)

    tr._project_and_assign = counting_project
    ok = tr._relocalize(frame)
    tr._project_and_assign = orig_project
    tr.p.min_local_inliers = base_gate
    assert ok, (base_inl, len(rescue_calls))
    assert rescue_calls, "rescue rounds never engaged"
    assert frame.n_matched() >= base_inl + 10
    # recovered pose equals the true query pose mapped through the
    # gt→map-frame similarity (mono map frame/scale are arbitrary)
    from orbslam3_jax.utils.evaluation import horn_align
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    gt_c = np.array([-R.T @ t for (R, t) in poses])
    sel = ~lost
    gt_idx = np.rint(ts[sel] * 20.0).astype(int)
    R_al, t_al, s_al = horn_align(gt_c[gt_idx], t_wc[sel], with_scale=True)
    c_q_map = s_al * R_al @ c_q + t_al
    c_est = -frame.R.T @ frame.t
    # tolerance: a fraction of the map-frame path radius (~2.5 * s_al)
    assert np.linalg.norm(c_est - c_q_map) < 0.5 * 2.5 * s_al, (
        c_est, c_q_map, s_al)
