"""Adaptive-gate ablation harness (VERDICT r4 Weak #7 / Next #2).

The tracker carries several empirically-tuned gates with no reference
counterpart (TrackingParams.gate_*). Each was justified on one fixture;
they interact, and r4's divergence gate broke the stereo Atlas-merge
fixture while passing every mono test. This harness runs a fixture MATRIX
with each gate individually toggled off (plus all-on / all-off) and prints
per-cell tracking health, so a gate tuned on one fixture is always checked
against the others.

Usage:  python scripts/gate_ablation.py [--frames N] [--fast]
Output: one table row per (fixture, config): ATE, n_lost, keyframes.
A gate whose removal IMPROVES a fixture (or whose presence breaks one) is
a finding; the expected picture is all-on ≥ every single-off cell.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


GATES = ("gate_divergence", "gate_ema_floor", "gate_init_split", "gate_anchor")


def run_mono_walk(n_frames, seed, **gate_kw):
    """The bench walk: revisit leg exercises the divergence/EMA gates."""
    from orbslam3_jax.models.system import SlamSystem
    from orbslam3_jax.models.tracking import TrackingParams
    from orbslam3_jax.utils.datasets import RoomScene, walk_trajectory
    from orbslam3_jax.utils.evaluation import evaluate_trajectory

    scene = RoomScene(seed=seed, n_clutter=4)
    poses = walk_trajectory(n_frames, period=max(80, (2 * n_frames) // 3))
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=1024,
                      seed=0,
                      tracking_params=TrackingParams(kf_interval_override=5,
                                                     **gate_kw))
    for i, (R, t) in enumerate(poses):
        slam.track_monocular(scene.render(R, t), ts=i / 20.0)
    gt = np.array([-R.T @ t for (R, t) in poses])
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    sel = ~lost
    ate = float("nan")
    if sel.sum() > n_frames // 2:
        ate, _ = evaluate_trajectory(np.arange(n_frames) / 20.0, gt,
                                     ts[sel], t_wc[sel], with_scale=True)
    st = slam.stats()
    slam.shutdown(print_times=False)
    return {"ate": ate, "n_lost": int(lost.sum()),
            "n_kf": st.get("n_keyframes", -1)}


def run_stereo_traverse(n_frames, seed, **gate_kw):
    """Stereo lateral traverse (the fixture class r4's gate regression
    broke: tests/test_atlas.py stereo phase-1 traverse)."""
    from orbslam3_jax.models.system import SlamSystem
    from orbslam3_jax.models.tracking import TrackingParams
    from orbslam3_jax.utils.datasets import RoomScene
    from orbslam3_jax.utils.evaluation import evaluate_trajectory

    scene = RoomScene(seed=seed, depth=6.0, half_w=5.0, half_h=2.5)
    baseline = 0.11
    poses = []
    for i in range(n_frames):
        x = 2.2 * np.sin(2 * np.pi * i / max(60, n_frames))
        c = np.array([x, 0.15 * np.sin(0.2 * i), 2.0])
        yaw = 0.2 * np.sin(2 * np.pi * i / max(60, n_frames) + 0.5)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        poses.append((R_wc.T, -R_wc.T @ c))
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      seed=0, bf=baseline * scene.K[0], th_depth=40.0,
                      tracking_params=TrackingParams(kf_interval_override=5,
                                                     **gate_kw))
    for i, (R, t) in enumerate(poses):
        il = scene.render(R, t)
        Rr, tr = scene.stereo_pose(R, t, baseline)
        slam.track_stereo(il, scene.render(Rr, tr), ts=i / 20.0)
    gt = np.array([-R.T @ t for (R, t) in poses])
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    sel = ~lost
    ate = float("nan")
    if sel.sum() > n_frames // 2:
        ate, _ = evaluate_trajectory(np.arange(n_frames) / 20.0, gt,
                                     ts[sel], t_wc[sel], with_scale=False)
    st = slam.stats()
    slam.shutdown(print_times=False)
    return {"ate": ate, "n_lost": int(lost.sum()),
            "n_kf": st.get("n_keyframes", -1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--fast", action="store_true",
                    help="80 frames, walk fixture only")
    args = ap.parse_args()
    n = 80 if args.fast else args.frames

    fixtures = {"mono_walk": run_mono_walk}
    if not args.fast:
        fixtures["stereo_traverse"] = run_stereo_traverse

    configs = [("all_on", {})]
    configs += [(f"no_{g.removeprefix('gate_')}", {g: False}) for g in GATES]
    configs.append(("all_off", {g: False for g in GATES}))

    print(f"{'fixture':<16} {'config':<16} {'ate':>8} {'lost':>5} {'kf':>4}")
    findings = []
    base = {}
    for fname, fn in fixtures.items():
        for cname, kw in configs:
            r = fn(n, seed=1, **kw)
            print(f"{fname:<16} {cname:<16} {r['ate']:>8.4f} "
                  f"{r['n_lost']:>5d} {r['n_kf']:>4d}", flush=True)
            if cname == "all_on":
                base[fname] = r
            else:
                b = base[fname]
                # a gate whose removal materially improves a fixture is a
                # misfire signal on that fixture class
                if (np.isfinite(r["ate"]) and np.isfinite(b["ate"])
                        and r["ate"] < 0.5 * b["ate"] - 1e-3) or \
                        r["n_lost"] + 5 < b["n_lost"]:
                    findings.append((fname, cname, b, r))
    print()
    if findings:
        print("FINDINGS (gate removal improved a fixture):")
        for fname, cname, b, r in findings:
            print(f"  {fname}/{cname}: ate {b['ate']:.4f}->{r['ate']:.4f}, "
                  f"lost {b['n_lost']}->{r['n_lost']}")
        sys.exit(1)
    print("no gate misfires detected (all-on >= every ablation)")


if __name__ == "__main__":
    main()
