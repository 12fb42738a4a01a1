#!/usr/bin/env python
"""TUM RGB-D dataset driver (the reference's Examples/RGB-D/rgbd_tum.cc main).

Usage:
  python examples/run_tum_rgbd.py SETTINGS.yaml SEQ_DIR \
      [--out traj.txt] [--gt groundtruth.txt] [--max-frames N]

SEQ_DIR is a TUM RGB-D sequence dir (rgb.txt, depth.txt, rgb/, depth/).
RGB/depth pairs are associated inline by nearest timestamp (the reference
ships evaluation/associate.py for this). Depth images are uint16 scaled by
the YAML's DepthMapFactor (5000 for TUM).
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


from orbslam3_jax.utils.config import load_config, system_from_config
from orbslam3_jax.utils.datasets import load_tum_rgbd
from orbslam3_jax.utils.evaluation import evaluate_trajectory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None,
                    help="TUM groundtruth.txt (ts tx ty tz qx qy qz qw)")
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args()

    import cv2
    cfg = load_config(args.settings)
    slam = system_from_config(args.settings)
    stamps, rgb_paths, depth_paths = load_tum_rgbd(args.seq_dir)
    n = len(stamps) if not args.max_frames else min(args.max_frames, len(stamps))
    t_start = time.perf_counter()
    for i in range(n):
        img = cv2.imread(rgb_paths[i], cv2.IMREAD_GRAYSCALE).astype(np.float32)
        depth = cv2.imread(depth_paths[i], cv2.IMREAD_UNCHANGED).astype(np.float32)
        depth /= cfg.depth_map_factor
        info = slam.track_rgbd(img, depth, stamps[i])
        if i % 50 == 0:
            print(f"[{i}/{n}] {info} "
                  f"({(i + 1) / (time.perf_counter() - t_start):.1f} fps)",
                  flush=True)

    slam.save_trajectory_tum(args.out)
    print("stats:", slam.stats())
    if args.gt:
        gt = np.loadtxt(args.gt, comments="#")
        ts, _, est_t, _ = slam.export_trajectory()
        ate, n_assoc = evaluate_trajectory(gt[:, 0], gt[:, 1:4], ts, est_t,
                                           with_scale=False)
        print(f"RMS ATE: {ate:.4f} m over {n_assoc} associations")


if __name__ == "__main__":
    main()
