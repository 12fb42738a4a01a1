"""Headless visualization: map/trajectory rendering + frame overlay.

Covers the reference's Pangolin Viewer / FrameDrawer / MapDrawer capability
(reference src/Viewer.cc:130, src/FrameDrawer.cc, src/MapDrawer.cc) without a
GL dependency: matplotlib renders the map point cloud, keyframe frusta,
covisibility graph and trajectory to PNG; OpenCV draws the per-frame keypoint
overlay with the reference's status-bar text.
"""
from __future__ import annotations

import numpy as np


def render_map(map_state, path: str, trajectory=None, show_covisibility=True,
               max_points: int = 5000, elev: float = -60, azim: float = -90):
    """Save a 3D rendering of the map (MapDrawer parity: points, keyframe
    frusta, covisibility edges, trajectory)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = map_state
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    mps = m.valid_mp_ids()
    if len(mps) > max_points:
        mps = mps[np.linspace(0, len(mps) - 1, max_points).astype(int)]
    if len(mps):
        P = m.mp_xyz[mps]
        ax.scatter(P[:, 0], P[:, 2], -P[:, 1], s=1, c="k", alpha=0.35,
                   label=f"{len(mps)} map points")

    kfs = m.valid_kf_ids()
    centers = []
    for k in kfs:
        R, t = m.kf_R[k], m.kf_t[k]
        c = -R.T @ t
        centers.append(c)
        # frustum: 4 image-corner rays at depth 0.2
        z = 0.12
        corners = np.array([[-0.16, -0.1, z], [0.16, -0.1, z],
                            [0.16, 0.1, z], [-0.16, 0.1, z]])
        pts = (corners @ R) + c
        for a, b in [(0, 1), (1, 2), (2, 3), (3, 0)]:
            ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 2], pts[b, 2]],
                    [-pts[a, 1], -pts[b, 1]], "b-", lw=0.5)
        for corner in pts:
            ax.plot([c[0], corner[0]], [c[2], corner[2]], [-c[1], -corner[1]],
                    "b-", lw=0.4)
    centers = np.asarray(centers) if len(centers) else np.zeros((0, 3))

    if show_covisibility and len(kfs) > 1:
        for i, k in enumerate(kfs):
            row = m.covisibility_row(int(k))
            for j in np.nonzero(row >= 100)[0]:
                jj = np.nonzero(kfs == j)[0]
                if len(jj) and jj[0] > i:
                    a, b = centers[i], centers[jj[0]]
                    ax.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]],
                            "g-", lw=0.6, alpha=0.6)

    if trajectory is not None and len(trajectory):
        T = np.asarray(trajectory)
        ax.plot(T[:, 0], T[:, 2], -T[:, 1], "r-", lw=1.2, label="trajectory")

    ax.set_xlabel("x"); ax.set_ylabel("z"); ax.set_zlabel("-y")
    ax.view_init(elev=elev, azim=azim)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_frame(img: np.ndarray, frame, state_name: str = "OK") -> np.ndarray:
    """Per-frame overlay (FrameDrawer parity): tracked keypoints as green
    squares, untracked as blue dots, reference status bar."""
    import cv2
    vis = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    n_tracked = 0
    for i in np.nonzero(frame.valid)[0]:
        x, y = int(frame.xy[i, 0]), int(frame.xy[i, 1])
        if frame.feat_mp[i] >= 0:
            cv2.rectangle(vis, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
            n_tracked += 1
        else:
            cv2.circle(vis, (x, y), 1, (255, 0, 0), -1)
    bar = np.zeros((22, vis.shape[1], 3), np.uint8)
    txt = f"{state_name} | matches: {n_tracked} | kps: {int(frame.valid.sum())}"
    cv2.putText(bar, txt, (8, 15), cv2.FONT_HERSHEY_PLAIN, 1.0, (255, 255, 255), 1)
    return np.concatenate([vis, bar], axis=0)


class LiveViewer:
    """Live (interactive) viewer over HTTP — the reference's Pangolin Viewer
    thread (reference src/Viewer.cc:130-250: render loop, menu toggles
    follow-camera / show-points / show-KFs / show-graph / localization-mode /
    reset) re-imagined for a headless host: a background thread renders
    the map + current-frame overlay at ``fps`` and a stdlib HTTP server
    serves an auto-refreshing page with the same menu actions. Open
    http://<host>:<port>/ while the system runs.

    Endpoints: ``/`` (page), ``/map.png``, ``/frame.png``, ``/state``
    (JSON), ``/toggle?key=...`` (show_points/show_kfs/show_graph/follow),
    ``/action?do=reset|localization|mapping``.
    """

    def __init__(self, system, port: int = 8642, fps: float = 2.0):
        self.system = system
        self.port = int(port)
        self.period = 1.0 / max(fps, 0.1)
        self.toggles = {"show_points": True, "show_kfs": True,
                        "show_graph": True, "follow": False}
        self._map_png = b""
        self._frame_png = b""
        self._stop = False
        self._httpd = None
        import threading
        self._render_t = threading.Thread(target=self._render_loop, daemon=True)
        self._serve_t = threading.Thread(target=self._serve, daemon=True)
        self._render_t.start()
        self._serve_t.start()

    # -- rendering -------------------------------------------------------
    def _render_once(self):
        import io
        import os
        import tempfile
        sysm = self.system
        m = sysm.map
        with m.lock:
            ts, R_wc, t_wc, lost = sysm.tracker.export_trajectory()
            tmp = tempfile.NamedTemporaryFile(suffix=".png", delete=False)
            tmp.close()
            try:
                render_map(m, tmp.name, trajectory=t_wc,
                           show_covisibility=self.toggles["show_graph"],
                           max_points=4000 if self.toggles["show_points"] else 0)
                with open(tmp.name, "rb") as f:
                    self._map_png = f.read()
            finally:
                os.unlink(tmp.name)
        lf = sysm.tracker.last_frame
        if lf is not None and lf.dev is not None or (lf is not None
                                                    and lf.host_ready):
            try:
                import cv2
                h = int(sysm.tracker.wh[1])
                w = int(sysm.tracker.wh[0])
                canvas = np.full((h, w), 16, np.float32)
                vis = draw_frame(canvas, lf, sysm.tracker.state.name)
                ok, buf = cv2.imencode(".png", vis)
                if ok:
                    self._frame_png = buf.tobytes()
            except Exception:
                pass

    def _render_loop(self):
        import time as _t
        while not self._stop:
            try:
                self._render_once()
            except Exception:
                pass
            _t.sleep(self.period)

    # -- http ------------------------------------------------------------
    def _serve(self):
        import json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import urlparse, parse_qs
        viewer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="text/html"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path == "/map.png":
                    self._send(200, viewer._map_png or b"", "image/png")
                elif u.path == "/frame.png":
                    self._send(200, viewer._frame_png or b"", "image/png")
                elif u.path == "/state":
                    st = viewer.system.stats()
                    st.pop("stage_times", None)
                    self._send(200, json.dumps(st).encode(),
                               "application/json")
                elif u.path == "/toggle":
                    k = q.get("key", [""])[0]
                    if k in viewer.toggles:
                        viewer.toggles[k] = not viewer.toggles[k]
                    self._send(200, b"ok", "text/plain")
                elif u.path == "/action":
                    do = q.get("do", [""])[0]
                    if do == "reset":
                        viewer.system.reset()
                    elif do == "localization":
                        viewer.system.activate_localization_mode()
                    elif do == "mapping":
                        viewer.system.deactivate_localization_mode()
                    self._send(200, b"ok", "text/plain")
                else:
                    page = ("<html><head><title>orbslam3_jax</title>"
                            "<meta http-equiv='refresh' content='2'></head>"
                            "<body style='background:#111;color:#ddd;"
                            "font-family:monospace'>"
                            "<h3>orbslam3_jax live viewer</h3>"
                            "<a href='/toggle?key=show_points'>points</a> | "
                            "<a href='/toggle?key=show_graph'>graph</a> | "
                            "<a href='/action?do=localization'>localization"
                            "</a> | <a href='/action?do=mapping'>mapping</a>"
                            " | <a href='/action?do=reset'>RESET</a><br>"
                            "<img src='/map.png' height='420'> "
                            "<img src='/frame.png' height='420'>"
                            "</body></html>").encode()
                    self._send(200, page)

        try:
            self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), H)
            self._httpd.serve_forever(poll_interval=0.3)
        except OSError:
            pass   # port busy: viewer disabled, SLAM unaffected

    def close(self):
        self._stop = True
        if self._httpd is not None:
            try:
                self._httpd.shutdown()
            except Exception:
                pass
