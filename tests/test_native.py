"""Native C++ map kernels vs numpy reference implementations."""
import numpy as np
import pytest

from orbslam3_jax import native


@pytest.fixture(scope="module")
def pools():
    rng = np.random.default_rng(0)
    n_kf, n_feat, max_mp = 24, 128, 2048
    feat_mp = np.where(rng.random((n_kf, n_feat)) < 0.6,
                       rng.integers(0, max_mp, (n_kf, n_feat)), -1).astype(np.int32)
    kf_valid = (rng.random(n_kf) < 0.9)
    return feat_mp, kf_valid, max_mp


def test_native_compiles():
    assert native.available(), "g++ toolchain should be present in this image"


def test_covisibility_matches_numpy(pools):
    feat_mp, kf_valid, max_mp = pools
    for kf in (0, 5, 11):
        got = native.covisibility_row(feat_mp, kf_valid, kf, max_mp)
        row = feat_mp[kf]
        mps = np.unique(row[row >= 0])
        want = np.zeros(len(feat_mp), np.int32)
        for k in range(len(feat_mp)):
            if k == kf or not kf_valid[k]:
                continue
            r = feat_mp[k]
            want[k] = np.isin(r[r >= 0], mps).sum()
        assert np.array_equal(got, want)


def test_obs_counts_matches_numpy(pools):
    feat_mp, kf_valid, max_mp = pools
    got = native.obs_counts(feat_mp, kf_valid, max_mp)
    fm = feat_mp[kf_valid]
    want = np.bincount(fm[fm >= 0], minlength=max_mp).astype(np.int32)
    assert np.array_equal(got, want)


def test_observations_of_matches_numpy(pools):
    feat_mp, kf_valid, max_mp = pools
    mp_ids = np.array([3, 99, 1000, 2000], np.int64)
    kf_idx, feat_idx = native.observations_of(feat_mp, kf_valid, mp_ids, max_mp)
    sel = np.isin(feat_mp, mp_ids) & (feat_mp >= 0) & kf_valid[:, None]
    wk, wf = np.nonzero(sel)
    assert np.array_equal(np.sort(kf_idx * 1000 + feat_idx), np.sort(wk * 1000 + wf))


def test_replace_points_dedups(pools):
    feat_mp, kf_valid, max_mp = pools
    fm = feat_mp.copy()
    lut = np.arange(max_mp, dtype=np.int32)
    lut[10] = 20  # merge 10 → 20
    native.replace_points(fm, lut, max_mp)
    assert not (fm == 10).any()
    # no keyframe observes the same point twice
    for k in range(len(fm)):
        row = fm[k][fm[k] >= 0]
        assert len(row) == len(np.unique(row))


def test_native_build_is_keyed_by_source_hash(tmp_path):
    """The library lands in the gitignored build directory under a name
    hashed from its source, so an edited source (or a library copied from
    elsewhere under another name) is never loaded in its place."""
    import os
    import shutil
    assert native.library_path().startswith(native.BUILD_DIR + os.sep)
    assert os.path.basename(native.BUILD_DIR) == "build"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "build/" in f.read().split()
    src = shutil.copy(native._SRC, tmp_path / "mapops.cpp")
    out = tmp_path / "build"
    first = native.build(str(src), str(out))
    assert os.path.exists(first)
    stamp = os.path.getmtime(first)
    assert native.build(str(src), str(out)) == first       # no rebuild
    assert os.path.getmtime(first) == stamp
    with open(src, "a") as f:
        f.write("\n// edited\n")
    second = native.build(str(src), str(out))
    assert second != first and os.path.exists(second)
    assert sorted(os.listdir(out)) == sorted(
        os.path.basename(p) for p in (first, second))
