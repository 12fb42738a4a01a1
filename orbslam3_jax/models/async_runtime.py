"""Asynchronous SLAM runtime: mapper + loop-closing threads, background GBA.

Rebuilds the reference's thread architecture (reference src/System.cc:135-164:
LocalMapping and LoopClosing threads + a transient Global-BA thread spawned per
loop closure, src/LoopClosing.cc:1538-1541) on the host side of the device
pipeline:

- Tracking runs in the caller's thread and never blocks on BA; it hands new
  keyframes to the mapper through a small queue with the reference's
  backpressure rules (queue<3 gate src/Tracking.cc:3626, SetAcceptKeyFrames
  src/LocalMapping.cc:88,327).
- The mapper thread pops keyframes, runs the mapping pipeline (triangulation,
  fuse, local BA, culling) and pushes processed keyframes to the loop-closing
  thread (reference src/LocalMapping.cc:299).
- The loop-closing thread runs place recognition + corrections; a detected
  loop spawns an interruptible global-BA thread (reference
  RunGlobalBundleAdjustment src/LoopClosing.cc:2587) whose result is
  propagated to keyframes/points created while it ran (the reference's
  spanning-tree propagation :2640-2830 — here an anchor-relative correction,
  since our trajectory is stored relative to reference keyframes).
- Cross-thread map consistency is the per-map ``MapState.lock`` (the
  reference's Map::mMutexMapUpdate): tracking holds it through the Track()
  core (src/Tracking.cc:1898), the mapper during gather/write-back, the loop
  closer during corrections. Device compute (the expensive part) runs outside
  the lock on gathered snapshots — XLA kernels only ever see immutable
  buffers, so there are no data races by construction on the device side.

Abort protocol: a new keyframe arriving mid-local-BA skips the BA's second
phase (the reference's mbAbortBA polled per g2o iteration,
src/LocalMapping.cc:184-185); a loop correction request pauses the mapper
(RequestStop/Release, src/LocalMapping.cc:1122-1176); a second loop found
while GBA runs kills the running GBA (mbStopGBA, src/LoopClosing.cc:1259-1289).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np


class _KFQueue:
    """Bounded keyframe queue with map tagging (stale entries from a replaced
    map are dropped — the reference instead clears queues in its reset
    protocol, src/LocalMapping.cc:1440-1470)."""

    def __init__(self):
        self._q: deque = deque()
        self._cv = threading.Condition()

    def push(self, item):
        with self._cv:
            self._q.append(item)
            self._cv.notify()

    def pop(self, timeout: float = 0.05):
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            if self._q:
                return self._q.popleft()
            return None

    def __len__(self):
        return len(self._q)

    def clear(self):
        with self._cv:
            self._q.clear()


class AsyncRuntime:
    """Owns the mapper + loop-closing threads for a SlamSystem."""

    def __init__(self, system):
        self.system = system
        self.kf_queue = _KFQueue()       # tracking → mapper
        self.loop_queue = _KFQueue()     # mapper → loop closing
        self._finish = threading.Event()
        self._stop_requested = threading.Event()   # pause mapper (loop corr.)
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self.gba = None                  # running BackgroundGBA or None
        self._mapper_thread = threading.Thread(
            target=self._mapper_run, name="local-mapping", daemon=True)
        self._loop_thread = threading.Thread(
            target=self._loop_run, name="loop-closing", daemon=True)
        self._mapper_thread.start()
        self._loop_thread.start()

    # -- tracking-side API ------------------------------------------------
    def insert_keyframe(self, kf_id: int, initial: bool):
        self.kf_queue.push((self.system.map, kf_id, initial))
        self._idle.clear()

    def accepting(self) -> bool:
        """Backpressure for the keyframe policy (reference queue<3 gate,
        src/Tracking.cc:3626, and SetAcceptKeyFrames while busy)."""
        return len(self.kf_queue) < 3 and not self._stop_requested.is_set()

    def on_map_remap(self, m, kf_remap):
        """Map pools compacted (MapState.compact, mapper thread, under the map
        lock): rewrite queued keyframe ids for that map; drop culled ones."""
        for q in (self.kf_queue, self.loop_queue):
            with q._cv:
                items = list(q._q)
                q._q.clear()
                for item in items:
                    if item[0] is m:
                        nid = int(kf_remap[item[1]])
                        if nid < 0:
                            continue
                        item = (m, nid) + tuple(item[2:])
                    q._q.append(item)

    def abort_requested(self) -> bool:
        """Local BA aborts when newer keyframes are waiting (reference
        mbAbortBA, src/LocalMapping.cc:184)."""
        return len(self.kf_queue) > 0 or self._stop_requested.is_set()

    # -- loop-closing-side mapper pause (reference RequestStop/Release) ----
    def request_stop(self, timeout: float = 30.0):
        self._stop_requested.set()
        t0 = time.monotonic()
        while not (self._stopped.is_set() or self._idle.is_set()):
            if time.monotonic() - t0 > timeout:
                break
            time.sleep(0.002)

    def release(self):
        self._stop_requested.clear()

    # -- lifecycle ---------------------------------------------------------
    def wait_idle(self, timeout: float = 120.0):
        """Drain both queues (used by tests and shutdown; the reference's
        shutdown spin-waits on thread Finish flags, src/System.cc:433-445)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if (len(self.kf_queue) == 0 and len(self.loop_queue) == 0
                    and self._idle.is_set()):
                return True
            time.sleep(0.005)
        return False

    def shutdown(self, timeout: float = 120.0):
        self.wait_idle(timeout)
        if self.gba is not None:
            self.gba.join(timeout)
        self._finish.set()
        self._mapper_thread.join(timeout)
        self._loop_thread.join(timeout)

    # -- threads -----------------------------------------------------------
    def _mapper_run(self):
        while not self._finish.is_set():
            if self._stop_requested.is_set():
                self._stopped.set()
                time.sleep(0.003)
                continue
            self._stopped.clear()
            item = self.kf_queue.pop(timeout=0.05)
            if item is None:
                if len(self.kf_queue) == 0:
                    self._idle.set()
                continue
            m, kf_id, initial = item
            sysm = self.system
            if m is not sysm.map:       # stale entry from a replaced map
                continue
            try:
                kf_id = sysm.mapper.process_keyframe(
                    kf_id, initial=initial,
                    abort_check=self.abort_requested)
                if not initial:
                    self.loop_queue.push((m, kf_id))
            except Exception as e:      # never kill the pipeline
                sysm.mapper.stats["mapper_errors"] = (
                    sysm.mapper.stats.get("mapper_errors", 0) + 1)
                sysm.mapper.stats["last_mapper_error"] = repr(e)
            if len(self.kf_queue) == 0:
                self._idle.set()

    def _loop_run(self):
        while not self._finish.is_set():
            item = self.loop_queue.pop(timeout=0.05)
            if item is None:
                continue
            m, kf_id = item
            sysm = self.system
            if m is not sysm.map or sysm.loop_closer is None:
                continue
            try:
                corrected = sysm.loop_closer.process_keyframe(
                    kf_id, pre_correct=self._pre_correct,
                    post_correct=self.release)
                if corrected:
                    self._start_gba()
                # cross-map merges are detected inside process_keyframe
                # (LoopCloser._try_merge) — already in this thread
            except Exception as e:
                if sysm.loop_closer is not None:
                    sysm.loop_closer.stats["lc_errors"] = (
                        sysm.loop_closer.stats.get("lc_errors", 0) + 1)
                    sysm.loop_closer.stats["last_lc_error"] = repr(e)
            finally:
                # an exception between pre_correct and post_correct must not
                # leave the mapper paused forever (release() is idempotent)
                self.release()

    def _pre_correct(self):
        """Before a loop correction: pause the mapper and kill a running GBA
        (reference CorrectLoop step 1, src/LoopClosing.cc:1259-1289)."""
        if self.gba is not None:
            self.gba.abort()
            self.gba.join()
            self.gba = None
        self.request_stop()

    def _start_gba(self):
        if self.gba is not None and self.gba.running:
            self.gba.abort()
            self.gba.join()
        self.gba = BackgroundGBA(self.system)
        self.gba.start()


class BackgroundGBA:
    """Interruptible full BA concurrent with tracking/mapping (reference's
    transient GBA thread, src/LoopClosing.cc:1538-1541 + propagation of
    corrections to keyframes/points created during the run, :2640-2830)."""

    def __init__(self, system, iters: int = 10, chunk: int = 2):
        self.system = system
        self.map = system.map
        self.iters = iters
        self.chunk = chunk
        self._abort = threading.Event()
        self.running = False
        self._thread = threading.Thread(target=self._run, name="global-ba",
                                        daemon=True)

    def start(self):
        self.running = True
        self._thread.start()

    def abort(self):
        self._abort.set()

    def join(self, timeout: float = 300.0):
        self._thread.join(timeout)

    def _run(self):
        try:
            tr = self.system.tracker
            if getattr(tr, "imu_initialized", False):
                # inertial map: FullInertialBA(7), not visual GBA (reference
                # RunGlobalBundleAdjustment, src/LoopClosing.cc:2591-2601).
                # The solve is one device dispatch, so the abort flag
                # (reference pbStopFlag, src/LoopClosing.cc:2601) is polled
                # between iteration chunks and before write-back — a pending
                # loop correction is never blocked behind the full solve.
                ids = self.map.valid_kf_ids()
                if len(ids):
                    for _ in range(2):
                        if self._abort.is_set():
                            break
                        self.system.mapper.full_inertial_ba(
                            int(ids[-1]), iters=4, prior_g=0.0, prior_a=0.0,
                            abort_check=self._abort.is_set)
            else:
                self.system.mapper.global_ba(
                    iters=(4, self.iters), abort_check=self._abort.is_set,
                    propagate=True)
        except Exception as e:
            self.system.mapper.stats["gba_errors"] = (
                self.system.mapper.stats.get("gba_errors", 0) + 1)
            self.system.mapper.stats["last_gba_error"] = repr(e)
        finally:
            self.running = False
