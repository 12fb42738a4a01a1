"""Per-image frame: extracted features + pose + map-point assignments.

The reference's ``Frame`` (reference include/Frame.h, src/Frame.cc) bundles
extraction, undistortion, grid assignment and stereo matching. Here a Frame is
an SoA snapshot of the jitted extractor output. Undistortion happens inside
the extractor dispatch (ops/features.make_extractor); the grid is unnecessary
— matching uses masked all-pairs kernels (ops/matching.py).

**Device-first**: the extractor output stays ON DEVICE (``dev``) and the host
mirrors (``xy``/``angle``/``octave``/``desc``/``valid``) materialize lazily
via ONE packed device→host transfer, only when host code actually touches
them. Every transfer is a synchronisation point with its own latency, so
ordinary tracked frames — whose bookkeeping needs only the small packed
result of the fused tracking kernel — never download their features at all;
keyframes materialize once at insertion.
"""
from __future__ import annotations

import numpy as np


class Frame:
    """One image's working set. Construct either from host arrays (tests,
    datasets) or from a device feature set (``dev=OrbFeatures``)."""

    _LAZY = ("xy", "angle", "octave", "desc", "valid", "response")

    def __init__(self, frame_id: int, ts: float, xy=None, angle=None,
                 octave=None, desc=None, valid=None, response=None,
                 dev=None, n_feat: int | None = None,
                 R=None, t=None, feat_mp=None, ur=None, depth=None, uvr=None,
                 tracked: bool = False):
        self.frame_id = frame_id
        self.ts = ts
        self.dev = dev                    # OrbFeatures on device (or None)
        self._host = {}
        for name, val in (("xy", xy), ("angle", angle), ("octave", octave),
                          ("desc", desc), ("valid", valid),
                          ("response", response)):
            if val is not None:
                self._host[name] = np.asarray(val)
        if n_feat is None:
            if dev is not None:
                n_feat = int(dev.valid.shape[0])
            elif valid is not None:
                n_feat = len(self._host["valid"])
            else:
                raise ValueError("Frame needs dev, valid, or n_feat")
        self.n_feat = n_feat
        # pose (world→cam); None until tracked
        self.R = None if R is None else np.asarray(R)
        self.t = None if t is None else np.asarray(t)
        # map-point id per feature (-1 = none)
        self.feat_mp = (np.full(n_feat, -1, np.int32) if feat_mp is None
                        else np.asarray(feat_mp))
        # stereo right-x / depth per feature (<0 = mono)
        self.ur = (np.full(n_feat, -1.0, np.float32) if ur is None
                   else np.asarray(ur))
        self.depth = (np.full(n_feat, -1.0, np.float32) if depth is None
                      else np.asarray(depth))
        # two-camera rigs: right-eye pixel of the stereo match (<0 = none)
        self.uvr = uvr if uvr is None else np.asarray(uvr)
        # whether tracking succeeded for this frame (pose is trustworthy)
        self.tracked = tracked

    # -- lazy host mirrors ------------------------------------------------
    def materialize(self) -> None:
        """Download the device features as ONE packed transfer (no-op if the
        host mirrors already exist)."""
        if all(k in self._host for k in ("xy", "angle", "octave", "desc",
                                         "valid")):
            return
        from ..ops import features as feat_ops
        buf = np.asarray(feat_ops._pack_features_jit(self.dev))
        xy, angle, response, octave, desc, valid = \
            feat_ops.unpack_features_host(buf)
        self._host.setdefault("xy", xy)
        self._host.setdefault("angle", angle)
        self._host.setdefault("response", response)
        self._host.setdefault("octave", octave)
        self._host.setdefault("desc", desc)
        self._host.setdefault("valid", valid)

    def __getattr__(self, name):
        # only called when normal lookup fails → lazy host mirrors
        if name in Frame._LAZY:
            host = self.__dict__.get("_host")
            if host is None:
                raise AttributeError(name)
            if name not in host:
                if self.__dict__.get("dev") is None:
                    raise AttributeError(f"Frame has no host '{name}' and no "
                                         "device features to materialize")
                self.materialize()
            return host[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in Frame._LAZY:
            self._host[name] = value
        else:
            object.__setattr__(self, name, value)

    @property
    def host_ready(self) -> bool:
        return "xy" in self._host

    @property
    def n_valid(self) -> int:
        if "valid" not in self._host and self.dev is not None \
                and hasattr(self, "_n_valid_hint"):
            return int(self._n_valid_hint)
        return int(self.valid.sum())

    def n_matched(self) -> int:
        # kernels only assign matches to valid features, so the mask is
        # implied; avoids materializing `valid` on untracked frames
        return int((self.feat_mp >= 0).sum())


def build_frame(frame_id: int, ts: float, feats, K=None, D=None) -> Frame:
    """Wrap extractor output (device arrays) in a Frame WITHOUT downloading.

    ``K``/``D`` are accepted for backward compatibility but undistortion now
    runs inside the extractor jit (ops/features.make_extractor); callers that
    still pass raw-keypoint features with distortion must undistort first."""
    return Frame(frame_id=frame_id, ts=ts, dev=feats)
