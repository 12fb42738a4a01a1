"""Place-recognition quality of the packaged vocabulary (VERDICT r1 weak #3:
the default vocab must discriminate real descriptors, not noise).

Revisit benchmark: two laps over the same 16 viewpoints of a rendered scene
(second lap from slightly perturbed poses, like a real revisit); lap-1 BoW
vectors form the database, every lap-2 view queries it. Precision@3 = fraction
of queries whose true viewpoint is in the 3 best-scoring database entries
(the reference's DetectNBestCandidates keeps 3, src/KeyFrameDatabase.cc:67).
"""
import numpy as np
import pytest
import jax.numpy as jnp

from orbslam3_jax.models.loop_closing import _default_vocabulary
from orbslam3_jax.ops import features as feat_ops, vocab as vocab_ops
from orbslam3_jax.utils.datasets import RoomScene

N_VIEWS = 16


@pytest.fixture(scope="module")
def revisit_bench():
    scene = RoomScene(seed=11, h=240, w=376, fx=229.3, fy=228.6,
                      cx=188.0, cy=120.0, n_clutter=5)
    cfg = feat_ops.OrbConfig(n_features=512)
    extract = feat_ops.make_extractor(240, 376, cfg)
    rng = np.random.default_rng(3)
    vocab = _default_vocabulary()
    tf = vocab.transform_fn()
    bow = vocab.bow_fn()

    def view(i, jitter):
        ang = 2 * np.pi * i / N_VIEWS
        c = np.array([2.2 * np.sin(ang), 0.4 * np.sin(2 * ang),
                      2.0 + 1.0 * np.cos(ang)])
        yaw = 0.3 * np.sin(ang + 0.5)
        if jitter:
            c = c + rng.normal(0, 0.08, 3)
            yaw += rng.normal(0, 0.02)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        R = R_wc.T
        img = scene.render(R, -R @ c)
        f = extract(jnp.asarray(img.astype(np.float32)))
        v = np.asarray(bow(tf(f.desc, f.valid)))
        return v

    db = np.stack([view(i, jitter=False) for i in range(N_VIEWS)])
    queries = np.stack([view(i, jitter=True) for i in range(N_VIEWS)])
    return db, queries


def test_candidate_precision_at_3(revisit_bench):
    db, queries = revisit_bench
    hits = 0
    for i in range(N_VIEWS):
        scores = np.asarray(vocab_ops.l1_scores(
            jnp.asarray(queries[i]), jnp.asarray(db)))
        top3 = np.argsort(-scores)[:3]
        hits += i in top3
    p_at_3 = hits / N_VIEWS
    assert p_at_3 > 0.8, p_at_3


def test_top1_margin(revisit_bench):
    """The true view should usually win outright, with a real score margin
    over the median distractor (uninformative BoW vectors would be flat)."""
    db, queries = revisit_bench
    top1 = 0
    margins = []
    for i in range(N_VIEWS):
        scores = np.asarray(vocab_ops.l1_scores(
            jnp.asarray(queries[i]), jnp.asarray(db)))
        top1 += int(np.argmax(scores) == i)
        margins.append(scores[i] - np.median(scores))
    assert top1 / N_VIEWS >= 0.7, top1
    assert np.median(margins) > 0.05, np.median(margins)
