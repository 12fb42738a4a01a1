"""False-positive audit of cross-map place recognition (VERDICT r4 Weak #5).

The system scales the reference's absolute acceptance counts
(20/15/20/50/80, reference src/LoopClosing.cc:734-738) by n_features/1000
(system.py), so a 512-feature rig verifies with ~2x looser gates. What
protects against wrong loop/merge closures at those budgets?

Measured here (and worth stating): the GEOMETRIC verification stage alone
is structure-blind — two box rooms with different textures but the same
dimensions Sim3-align perfectly, so `_verify_candidate` on cross-scene
pairs accepts (measured 15/15 on same-geometry scenes). The reference has
the same property (perceptual aliasing); its protection — and ours — is
the layer BEFORE geometry: BoW candidate selection (appearance) plus the
3-consecutive temporal-consistency requirement. This test therefore audits
the CANDIDATE stage: cross-scene keyframes must score far below genuine
revisits in the BoW database, so structure-aliased pairs never reach the
Sim3 verifier in the first place.
"""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_jax.models.system import SlamSystem
from orbslam3_jax.ops import vocab as vocab_ops
from orbslam3_jax.utils.datasets import RoomScene, walk_trajectory

# builds two full maps for the FP audit — excluded from the fast profile (pytest.ini)
pytestmark = pytest.mark.slow


def _build(seed, n_frames=40):
    scene = RoomScene(seed=seed, n_clutter=4)
    poses = walk_trajectory(n_frames, period=60)
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0, tracking_params=dense_tracking_params(),
                      enable_loop_closing=True)
    for i, (R, t) in enumerate(poses):
        slam.track_monocular(scene.render(R, t), ts=i / 20.0)
    return slam


def test_candidate_stage_rejects_cross_scene():
    a = _build(seed=1)
    b = _build(seed=9)
    lc_a, lc_b = a.loop_closer, b.loop_closer
    ma, mb = a.map, b.map
    kfs_a = [int(k) for k in ma.valid_kf_ids()]
    kfs_b = [int(k) for k in mb.valid_kf_ids()]
    assert len(kfs_a) >= 5 and len(kfs_b) >= 5

    n_words = lc_a.vocab.n_words

    def dense_row(lc, m, k):
        ids, w = lc._sparse_row(m.kf_feat_desc[k], m.kf_feat_valid[k])
        return vocab_ops.sparse_to_dense_np(ids, w, n_words)

    rows_b_ids = np.stack([lc_b._sparse_row(mb.kf_feat_desc[k],
                                            mb.kf_feat_valid[k])[0]
                           for k in kfs_b])
    rows_b_w = np.stack([lc_b._sparse_row(mb.kf_feat_desc[k],
                                          mb.kf_feat_valid[k])[1]
                         for k in kfs_b])

    fp = 0
    for k1 in kfs_a[2:8]:
        q = dense_row(lc_a, ma, k1)
        cross, _ = vocab_ops.sparse_scores_np(q, rows_b_ids, rows_b_w)
        # same-map self score = ceiling for this query
        ids_s, w_s = lc_a._sparse_row(ma.kf_feat_desc[k1],
                                      ma.kf_feat_valid[k1])
        self_score, _ = vocab_ops.sparse_scores_np(
            q, ids_s[None], w_s[None])
        # the reference admits candidates above 0.75x the best covisible-
        # group score (src/KeyFrameDatabase.cc:243); a cross-scene keyframe
        # scoring anywhere near the self ceiling would pass any such gate
        if cross.max() > 0.5 * self_score[0]:
            fp += 1
    assert fp == 0, f"{fp}/6 cross-scene queries scored like revisits"

    # positive control: a genuine revisit (same scene, nearby pose) scores
    # HIGH relative to self — the discrimination isn't vacuous strictness
    k1, k2 = kfs_a[2], kfs_a[3]
    q = dense_row(lc_a, ma, k1)
    ids2, w2 = lc_a._sparse_row(ma.kf_feat_desc[k2], ma.kf_feat_valid[k2])
    near, _ = vocab_ops.sparse_scores_np(q, ids2[None], w2[None])
    ids_s, w_s = lc_a._sparse_row(ma.kf_feat_desc[k1], ma.kf_feat_valid[k1])
    self_score, _ = vocab_ops.sparse_scores_np(q, ids_s[None], w_s[None])
    assert near[0] > 0.35 * self_score[0], (near[0], self_score[0])
