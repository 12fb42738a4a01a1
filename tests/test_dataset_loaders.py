"""Dataset-layout loaders (KITTI odometry, TUM RGB-D association)."""
import os

import numpy as np

from orbslam3_jax.utils.datasets import load_kitti_sequence, load_tum_rgbd


def test_kitti_layout(tmp_path):
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    (seq / "times.txt").write_text("0.0\n0.1\n0.2\n")
    ts, left, right = load_kitti_sequence(str(seq))
    assert len(ts) == 3 and ts[2] == 0.2
    assert left[1].endswith("image_0/000001.png")
    assert right[2].endswith("image_1/000002.png")


def test_tum_rgbd_association(tmp_path):
    seq = tmp_path / "fr1"
    seq.mkdir()
    (seq / "rgb.txt").write_text(
        "# comment\n1.00 rgb/1.00.png\n1.05 rgb/1.05.png\n1.50 rgb/1.50.png\n")
    (seq / "depth.txt").write_text(
        "1.01 depth/1.01.png\n1.06 depth/1.06.png\n2.00 depth/2.00.png\n")
    ts, rgb, depth = load_tum_rgbd(str(seq), max_dt=0.02)
    # 1.00↔1.01 and 1.05↔1.06 pair; 1.50 has no depth within 20 ms
    assert len(ts) == 2
    assert rgb[0].endswith("rgb/1.00.png") and depth[0].endswith("depth/1.01.png")
    assert rgb[1].endswith("rgb/1.05.png") and depth[1].endswith("depth/1.06.png")
