#!/usr/bin/env python
"""EuRoC dataset driver (the reference's Examples/ mains, e.g.
Examples/Monocular-Inertial/mono_inertial_euroc.cc:40-218).

Usage:
  python examples/run_euroc.py SETTINGS.yaml SEQ_DIR --mode mono|stereo|mono_vi \
      [--out traj.txt] [--gt groundtruth.csv] [--max-frames N] [--render map.png]

SEQ_DIR is the EuRoC sequence root containing mav0/.
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


from orbslam3_jax.utils.config import load_config, system_from_config
from orbslam3_jax.utils.datasets import load_euroc_images, load_euroc_imu
from orbslam3_jax.utils.evaluation import evaluate_trajectory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dirs", nargs="+",
                    help="one or more sequence roots; several = a multi-"
                    "session Atlas run (reference ChangeDataset, "
                    "mono_inertial_euroc.cc:192-197)")
    ap.add_argument("--mode", default="mono",
                    choices=["mono", "stereo", "mono_vi", "stereo_vi"])
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--render", default=None)
    args = ap.parse_args()

    import cv2
    slam = system_from_config(args.settings)
    # EuRoC stereo pairs are unrectified; the reference examples rectify with
    # the LEFT./RIGHT. YAML blocks before TrackStereo
    # (Examples/Stereo/stereo_euroc.cc:92-118)
    rect = None
    if args.mode.startswith("stereo"):
        rect = load_config(args.settings).stereo_rectify_maps()
    t_start = time.perf_counter()
    n_done = 0
    for si, seq_dir in enumerate(args.seq_dirs):
        stamps, paths = load_euroc_images(seq_dir, "cam0")
        if args.mode.startswith("stereo"):
            stamps_r, paths_r = load_euroc_images(seq_dir, "cam1")
        if args.mode.endswith("_vi"):
            imu_ts, gyro, acc = load_euroc_imu(seq_dir)
            cursor = 0
        if si > 0:
            print(f"-- session {si + 1}/{len(args.seq_dirs)}: {seq_dir} "
                  "(timestamp-gap handling spawns/merges Atlas sub-maps)")
        n = len(stamps) if not args.max_frames else min(args.max_frames, len(stamps))
        for i in range(n):
            img = cv2.imread(paths[i], cv2.IMREAD_GRAYSCALE).astype(np.float32)
            ts = stamps[i]
            if args.mode.endswith("_vi"):
                end = np.searchsorted(imu_ts, ts, side="right")
                slam.tracker.grab_imu(imu_ts[cursor:end], gyro[cursor:end], acc[cursor:end])
                cursor = end
            if args.mode.startswith("stereo"):
                img_r = cv2.imread(paths_r[i], cv2.IMREAD_GRAYSCALE).astype(np.float32)
                if rect is not None:
                    img = cv2.remap(img, rect[0][0], rect[0][1], cv2.INTER_LINEAR)
                    img_r = cv2.remap(img_r, rect[1][0], rect[1][1], cv2.INTER_LINEAR)
                info = slam.track_stereo(img, img_r, ts)
            else:
                info = slam.track_monocular(img, ts)
            n_done += 1
            if i % 50 == 0:
                print(f"[{i}/{n}] {info} "
                      f"({n_done / (time.perf_counter() - t_start):.1f} fps)",
                      flush=True)

    slam.save_trajectory_tum(args.out)
    print("stats:", slam.stats())
    if args.render:
        from orbslam3_jax.models.viewer import render_map
        _, _, t_wc, _ = slam.export_trajectory()
        render_map(slam.map, args.render, trajectory=t_wc)
    if args.gt:
        gt = np.loadtxt(args.gt, delimiter=",", comments="#")
        ate, n_assoc = evaluate_trajectory(
            gt[:, 0] * 1e-9, gt[:, 1:4],
            *(lambda e: (e[0], e[2]))(slam.export_trajectory()),
            with_scale=args.mode == "mono")
        print(f"RMS ATE: {ate:.4f} m over {n_assoc} associations")


if __name__ == "__main__":
    main()
