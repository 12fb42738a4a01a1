"""Multi-stream tracking frontend sharded over a device mesh.

The reference serves ONE camera rig per process (its parallelism is four
POSIX threads, SURVEY §2.3). The device-mesh scale-out for production serving
is the orthogonal direction: many concurrent SLAM sessions (robots / AR
clients / dataset shards), each frame-serial, batched so every device runs the
identical fixed-shape frontend on its own stream shard — data parallelism
over SESSIONS, with zero collectives in the steady state (each stream's
state stays on its device; host code only routes inputs/outputs).

One step is ``models/kernels.frontend_step`` (ORB extraction → projection
matching against the stream's map shard → pose-only LM, the per-frame hot
path of Tracking, reference src/Tracking.cc GrabImageMonocular → Track),
vmapped over the stream axis and sharded over the mesh.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import kernels
from ..ops import features as feat_ops


def make_batched_frontend(mesh: Mesh, h: int, w: int,
                          orb_cfg: feat_ops.OrbConfig | None = None,
                          n_mp: int = 4096, axis: str = "lm"):
    """Build a jitted multi-stream frontend step.

    Returns ``step(imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind,
    mp_maxd, mp_valid, K) -> (R, t, n_inliers)`` where every array has a
    leading stream axis sharded over ``axis``. Per-stream shapes match the
    single-chip path; K is (S,4) per-stream intrinsics.
    """
    cfg = orb_cfg or feat_ops.OrbConfig(n_features=1024)
    wh = jnp.asarray([float(w), float(h)], jnp.float32)
    vstep = jax.vmap(kernels.frontend_step(cfg),
                     in_axes=(0,) * 10 + (None,))
    shard = NamedSharding(mesh, P(axis))

    @functools.partial(jax.jit,
                       in_shardings=(shard,) * 10,
                       out_shardings=(shard, shard, shard))
    def step(imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd,
             mp_valid, K):
        return vstep(imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind,
                     mp_maxd, mp_valid, K, wh)

    return step
