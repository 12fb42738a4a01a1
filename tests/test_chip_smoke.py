"""The pieces chip_smoke.py stands on, checked on the CPU: the projection
matcher against its numpy brute-force reference, the device check, and the
compile-cache placement. The ``gpu`` tests repeat the matcher and BA phases
on a card."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from orbslam3_jax.models import kernels, system
from orbslam3_jax.ops import features, matching

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows_problem(case, seed=3):
    """(M, N) shapes off any power-of-two tile; ``masked`` empties a third
    of the rows and all of one octave band; ``ties`` repeats descriptors so
    that rows see equal best distances."""
    rng = np.random.default_rng(seed)
    m, n = {"non_tile": (300, 200), "masked": (257, 131),
            "ties": (129, 67)}[case]
    mp_desc = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    uv = rng.uniform([0, 0], [752, 480], (m, 2)).astype(np.float32)
    rad = rng.uniform(5, 80, m).astype(np.float32)
    lvl = rng.integers(0, 8, m).astype(np.int32)
    row_ok = rng.random(m) < 0.7
    feat_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    feat_xy = rng.uniform([0, 0], [752, 480], (n, 2)).astype(np.float32)
    feat_oct = rng.integers(0, 8, n).astype(np.int32)
    feat_ok = rng.random(n) < 0.9
    if case == "masked":
        row_ok[: m // 3] = False
        feat_ok[feat_oct == 3] = False
    if case == "ties":
        feat_desc[1::2] = feat_desc[0::2][: n // 2]
        mp_desc[:] = feat_desc[rng.integers(0, n, m)]
        rad[:] = 400.0
    return (mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct,
            feat_ok)


@pytest.mark.parametrize("case", ["non_tile", "masked", "ties"])
def test_match_rows_equals_numpy_reference(case):
    args = _rows_problem(case)
    got = jax.jit(matching.match_rows)(*(jnp.asarray(a) for a in args))
    want = chip_smoke.match_rows_reference(*args)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w)
    idx, best, second = want
    assert (best == chip_smoke.BIG).any()          # rows with no candidate
    assert (best < chip_smoke.BIG).any()
    if case == "ties":
        assert ((best == second) & (best < chip_smoke.BIG)).sum() > 10


@pytest.mark.parametrize("n_col", [67, 8300])
def test_masked_top2_equals_numpy(n_col):
    """Both reductions of masked_top2: the packed key (<= 8192 columns) and
    argmin beyond it, with ties and empty rows."""
    rng = np.random.default_rng(n_col)
    dist = rng.integers(0, 40, (24, n_col)).astype(np.int32)
    mask = rng.random((24, n_col)) < 0.3
    mask[:3] = False
    mask[3, :] = False
    mask[3, [5, 9]] = True
    got = jax.jit(matching.masked_top2)(jnp.asarray(dist), jnp.asarray(mask))
    d = np.where(mask, dist, chip_smoke.BIG)
    idx = np.argmin(d, axis=1)
    best = d[np.arange(24), idx]
    d[np.arange(24), idx] = chip_smoke.BIG
    for g, w in zip(got, (idx, best, d.min(axis=1))):
        assert np.array_equal(np.asarray(g), w)
    assert (best[:3] == chip_smoke.BIG).all() and (best[3:] < 40).all()


def test_matched_points_ignores_unmatched_rows():
    """An unmatched row that names a matched row's feature must not clear
    that feature's point, whichever row the scatter writes last."""
    idx = jnp.asarray([2, 2, 0, 2, 0, 4], jnp.int32)
    ok = jnp.asarray([False, True, False, False, True, False])
    xyz = jnp.arange(18, dtype=jnp.float32).reshape(6, 3) + 1.0
    pts, valid = jax.jit(kernels.matched_points, static_argnums=3)(
        idx, ok, xyz, 5)
    want = np.zeros((5, 3), np.float32)
    want[2], want[0] = np.asarray(xyz[1]), np.asarray(xyz[4])
    assert np.array_equal(np.asarray(pts), want)
    assert np.asarray(valid).tolist() == [True, False, True, False, False]


def test_projection_matcher_equals_numpy_reference():
    cfg = features.OrbConfig(n_features=256)
    mp, frame, K, wh = chip_smoke.matcher_problem(
        600, cfg.total_capacity, n_levels=cfg.n_levels, scale=cfg.scale)
    proj = kernels.projection_matcher(0, cfg.n_levels, cfg.scale)
    idx, ok, uv, lvl, frustum = map(np.asarray, proj(
        *mp, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), K, *frame,
        wh, np.float32(8.0), np.float32(0.9), np.int32(100),
        np.float32(0.5)))
    sf = np.asarray([cfg.scale ** i for i in range(cfg.n_levels)], np.float32)
    r_idx, r_best, r_second = chip_smoke.match_rows_reference(
        mp[1], uv, np.float32(8.0) * sf[lvl], lvl, frustum, frame[1],
        frame[0], frame[2], frame[3])
    r_ok = chip_smoke.projection_ok_reference(r_idx, r_best, r_second,
                                              100, 0.9)
    assert np.array_equal(idx, r_idx)
    assert np.array_equal(ok, r_ok)
    assert 0 < r_ok.sum() < len(r_ok) and not frustum.all()


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a CPU-only JAX, and in a directory holding nothing of the repo
    but the script, it exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        script = shutil.copy(script, tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_compile_cache_placement():
    assert system.compilation_cache_dir(
        "gpu", {"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"
    assert system.compilation_cache_dir(
        "cpu", {"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"
    assert system.compilation_cache_dir("gpu", {}) == system.CACHE_DIR
    assert system.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert system.compilation_cache_dir("cpu", {}) is None
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    # the CPU backend gets no cache unless JAX_COMPILATION_CACHE_DIR asks
    before = jax.config.jax_compilation_cache_dir
    system.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.gpu
def test_matcher_on_gpu(gpu):
    chip_smoke.phase_matcher(timing_reps=2)


@pytest.mark.gpu
def test_ba_on_gpu_matches_cpu(gpu):
    chip_smoke.phase_ba(("bench_K16", "loop_K256"))
