"""Device-resident mirror of the map-point pool.

The reference keeps its map in CPU pointer graphs and every consumer walks
them in place (include/MapPoint.h, include/Map.h). Here the host ``MapState``
stays the source of truth for bookkeeping, but the numerical per-point state
that tracking kernels consume every frame — position, descriptor, normal,
scale range, validity — is mirrored ON DEVICE and refreshed only when the map
actually mutates (``MapState.device_version``). Per-frame device work then
uploads only small id lists and gathers from the resident pool, instead of
re-uploading gathered arrays each frame (every host↔device transfer is a
synchronisation point with its own latency).

Packing layout (two buffers so one upload each):
- ``mpf`` (P, 8) float32: xyz (3), normal (3), min_dist, max_dist
- ``mpu`` (P, 9) uint32:  desc (8), valid (1)
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _bucket(n: int, lo: int = 4096) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceKfPool:
    """Device-resident per-keyframe feature arrays (xy, desc, octave).

    These are IMMUTABLE per keyframe (the reference's KeyFrame keypoint set,
    include/KeyFrame.h), so each row uploads once; dynamic per-call masks
    (unmatched features, validity) stay host-computed and ride along as small
    uploads. Rows are synced lazily by id; pool compaction (MapState.compact)
    is detected via ``remap_epoch`` and simply invalidates the cache."""

    def __init__(self):
        self._map_ref = None
        self._epoch = -1
        self._have: set[int] = set()
        self._cap = 0
        self._n_feat = 0
        self.xy = None      # (Kc, N, 2) f32
        self.desc = None    # (Kc, N, 8) u32
        self.octave = None  # (Kc, N) i32

    def sync(self, m, kf_ids) -> tuple:
        import jax
        n_feat = m.cfg.n_features
        if (self._map_ref is not m or self._epoch != m.remap_epoch
                or self._n_feat != n_feat):
            self._map_ref = m
            self._epoch = m.remap_epoch
            self._have = set()
            self._n_feat = n_feat
            self._cap = 0
        need = [int(k) for k in kf_ids if int(k) not in self._have]
        top = max([int(k) for k in kf_ids], default=-1)
        if top >= self._cap:
            cap = _bucket(top + 1, 64)
            xy = jnp.zeros((cap, n_feat, 2), jnp.float32)
            desc = jnp.zeros((cap, n_feat, 8), jnp.uint32)
            octv = jnp.zeros((cap, n_feat), jnp.int32)
            if self._cap and self._have:
                xy = xy.at[: self._cap].set(self.xy)
                desc = desc.at[: self._cap].set(self.desc)
                octv = octv.at[: self._cap].set(self.octave)
            self.xy, self.desc, self.octave = xy, desc, octv
            self._cap = cap
        if need:
            idx = jnp.asarray(np.asarray(need, np.int32))
            self.xy = self.xy.at[idx].set(jnp.asarray(m.kf_feat_xy[need]))
            self.desc = self.desc.at[idx].set(jnp.asarray(m.kf_feat_desc[need]))
            self.octave = self.octave.at[idx].set(
                jnp.asarray(m.kf_feat_octave[need]))
            self._have.update(need)
        return self.xy, self.desc, self.octave


class DeviceMapMirror:
    """Mirrors one MapState's point pool on the default device."""

    def __init__(self):
        self._map_ref = None
        self._ver = -1
        self._cap = 0
        self.mpf = None   # (P,8) f32
        self.mpu = None   # (P,9) u32

    def invalidate(self):
        self._ver = -1
        self._map_ref = None

    def sync(self, m) -> tuple:
        """Return (mpf, mpu) device buffers for ``m``, uploading only if the
        map mutated since the last sync (or the mirror tracked another map)."""
        ver = getattr(m, "device_version", None)
        if ver is None:
            ver = -2  # MapState without versioning: upload every time
        if (self._map_ref is m and ver >= 0 and ver == self._ver
                and self._cap >= m.n_mp):
            return self.mpf, self.mpu
        n = m.n_mp
        cap = self._cap if (self._map_ref is m and self._cap >= n and
                            self._cap > 0) else _bucket(max(n, 1))
        f = np.zeros((cap, 8), np.float32)
        u = np.zeros((cap, 9), np.uint32)
        f[:n, 0:3] = m.mp_xyz[:n]
        f[:n, 3:6] = m.mp_normal[:n]
        f[:n, 6] = m.mp_min_dist[:n]
        f[:n, 7] = np.maximum(m.mp_max_dist[:n], 1e-6)
        u[:n, 0:8] = m.mp_desc[:n]
        u[:n, 8] = m.mp_valid[:n]
        self.mpf = jnp.asarray(f)
        self.mpu = jnp.asarray(u)
        self._cap = cap
        self._map_ref = m
        self._ver = ver
        return self.mpf, self.mpu


# ---------------------------------------------------------------------------
# Shared per-map registries: tracker, mapper and loop closer reuse ONE mirror
# and ONE keyframe pool per MapState (weakly keyed — retired maps free their
# device memory with the host object).
# ---------------------------------------------------------------------------
import weakref

_MIRRORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_KF_POOLS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def mirror_for(m) -> DeviceMapMirror:
    mir = _MIRRORS.get(m)
    if mir is None:
        mir = DeviceMapMirror()
        _MIRRORS[m] = mir
    return mir


def kf_pool_for(m) -> DeviceKfPool:
    pool = _KF_POOLS.get(m)
    if pool is None:
        pool = DeviceKfPool()
        _KF_POOLS[m] = pool
    return pool
