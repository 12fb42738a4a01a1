"""Isolate cross-view ORB matching quality on the bench walk fixture:
how many ratio-test matches survive between views N frames apart, and how
many of those are geometrically correct (ground-truth epipolar/projection)?
Run: JAX_PLATFORMS=cpu python scripts/debug_crossview_matching.py
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import features as feat_ops, matching
from orbslam3_jax.utils.datasets import RoomScene, walk_trajectory

scene = RoomScene(seed=1, n_clutter=4)
poses = walk_trajectory(300, period=280)
cfg = feat_ops.OrbConfig(n_features=1024)

K = scene.K


def extract(i):
    img, depth = scene.render(*poses[i], return_depth=True)
    f = feat_ops.extract_orb(jnp.asarray(img), cfg)
    return (np.asarray(f.xy), np.asarray(f.desc), np.asarray(f.valid),
            np.asarray(f.octave), depth)


def gt_project(i, j, xy_i, depth_i):
    """Project pixels of view i (with depth) into view j via GT."""
    R_i, t_i = poses[i]
    R_j, t_j = poses[j]
    fx, fy, cx, cy = K
    rays = np.stack([(xy_i[:, 0] - cx) / fx, (xy_i[:, 1] - cy) / fy,
                     np.ones(len(xy_i))], -1)
    ui = np.clip(xy_i[:, 0].astype(int), 0, scene.w - 1)
    vi = np.clip(xy_i[:, 1].astype(int), 0, scene.h - 1)
    z = depth_i[vi, ui]
    xc = rays * z[:, None]
    xw = (xc - t_i) @ R_i
    xcj = xw @ R_j.T + t_j
    uv = np.stack([fx * xcj[:, 0] / np.maximum(xcj[:, 2], 1e-6) + cx,
                   fy * xcj[:, 1] / np.maximum(xcj[:, 2], 1e-6) + cy], -1)
    return uv, xcj[:, 2] > 0


base = 2
xy0, d0, v0, o0, dep0 = extract(base)
for gap in (1, 4, 13, 40, 265):
    j = base + gap
    xyj, dj, vj, oj, depj = extract(j)
    idx, best, ok = matching.search_by_descriptor(
        jnp.asarray(d0), jnp.asarray(v0),
        jnp.asarray(dj), jnp.asarray(vj),
        max_dist=matching.TH_LOW, ratio=0.9)
    okn = np.asarray(ok)
    idxn = np.asarray(idx)
    src = np.nonzero(okn)[0]
    uv_gt, front = gt_project(base, j, xy0[src], dep0)
    err = np.linalg.norm(xyj[idxn[src]] - uv_gt, axis=1)
    good = (err < 4.0) & front
    # no-ratio variant
    idx2, best2, ok2 = matching.search_by_descriptor(
        jnp.asarray(d0), jnp.asarray(v0),
        jnp.asarray(dj), jnp.asarray(vj),
        max_dist=matching.TH_LOW, ratio=1.0)
    ok2n = np.asarray(ok2)
    print(f"gap {gap:3d}: matches={okn.sum():4d} correct={good.sum():4d} "
          f"({100*good.mean() if len(good) else 0:.0f}%)  "
          f"no-ratio matches={ok2n.sum():4d}")
