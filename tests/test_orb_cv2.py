"""ORB parity against OpenCV (the reference's ORBextractor is an OpenCV-based
FAST + rBRIEF implementation; reference src/ORBextractor.cc:150,:688,:1038).

Three layers, from strict to looser:
1. descriptor parity — computing OUR descriptor at cv2's own keypoints and
   angles must reproduce cv2's descriptor almost bit-for-bit (same learned
   bit_pattern_31, same steering arithmetic, same 7x7/sigma-2 blur);
2. orientation parity — our IC_Angle (OpenCV u_max integer circle) agrees
   with cv2's keypoint angles;
3. detection overlap — mutual keypoint recall between our extractor and
   cv2.ORB_create on a textured rendered image.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from orbslam3_jax.ops import features as feat_ops
from orbslam3_jax.utils.datasets import RoomScene


@pytest.fixture(scope="module")
def scene_img():
    scene = RoomScene(seed=5, n_clutter=4)
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    img = scene.render(R, t)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def cv2_kps(scene_img):
    orb = cv2.ORB_create(nfeatures=512, scaleFactor=1.2, nlevels=8,
                         edgeThreshold=19, fastThreshold=20)
    kps, desc = orb.detectAndCompute(scene_img, None)
    return kps, desc


def _cv2_desc_to_u32(desc):
    return np.ascontiguousarray(desc).view("<u4")   # (N, 8), bit i of word w
    # == pattern pair 32w+i — the same packing brief_descriptors emits


def test_descriptor_parity_at_cv2_keypoints(scene_img, cv2_kps):
    kps, desc_cv = cv2_kps
    sel = [i for i, kp in enumerate(kps) if kp.octave == 0]
    assert len(sel) > 50
    xy = np.array([[kps[i].pt[0], kps[i].pt[1]] for i in sel])
    ang = np.array([np.deg2rad(kps[i].angle) for i in sel], np.float32)
    img = jnp.asarray(scene_img.astype(np.float32))
    blurred = feat_ops.gaussian_blur7(img)
    ours = np.asarray(feat_ops.brief_descriptors(
        blurred, jnp.asarray(np.round(xy).astype(np.int32)),
        jnp.asarray(ang)))
    theirs = _cv2_desc_to_u32(desc_cv[sel])
    ham = np.unpackbits((ours ^ theirs).view(np.uint8), axis=-1).sum(-1)
    # near-zero median: identical pattern/steering; residual bits come from
    # sub-pixel keypoint rounding and blur edge handling
    assert np.median(ham) <= 8, (np.median(ham), ham.mean())
    assert ham.mean() <= 16, ham.mean()


def test_orientation_parity(scene_img, cv2_kps):
    kps, _ = cv2_kps
    sel = [i for i, kp in enumerate(kps) if kp.octave == 0]
    xy = np.array([[kps[i].pt[0], kps[i].pt[1]] for i in sel])
    ang_cv = np.array([np.deg2rad(kps[i].angle) for i in sel])
    img = jnp.asarray(scene_img.astype(np.float32))
    ours = np.asarray(feat_ops.ic_angles(
        img, jnp.asarray(np.round(xy).astype(np.int32))))
    d = np.angle(np.exp(1j * (ours - ang_cv)))
    agree = np.abs(d) < 0.05
    assert agree.mean() > 0.9, (agree.mean(), np.median(np.abs(d)))


def test_keypoint_mutual_recall(scene_img, cv2_kps):
    kps, _ = cv2_kps
    cfg = feat_ops.OrbConfig(n_features=512)
    feats = feat_ops.extract_orb(jnp.asarray(scene_img.astype(np.float32)), cfg)
    ours = np.asarray(feats.xy)[np.asarray(feats.valid)]
    theirs = np.array([kp.pt for kp in kps])
    assert len(ours) > 200

    def recall(a, b, r=3.0):
        d = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
        return (d.min(axis=1) < r).mean()

    # cv2's keypoints should mostly be found by us (VERDICT target >= 0.7)
    assert recall(theirs, ours) >= 0.7, recall(theirs, ours)
    # and a majority of ours correspond to cv2's (selection may differ more)
    assert recall(ours, theirs) >= 0.5, recall(ours, theirs)
