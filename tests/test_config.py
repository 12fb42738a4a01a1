import numpy as np
import pytest

from orbslam3_jax.utils.config import load_config

EUROC_YAML = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
IMU.GyroWalk: 1.9e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200
"""


def test_load_euroc_style_yaml(tmp_path):
    p = tmp_path / "EuRoC.yaml"
    p.write_text(EUROC_YAML)
    cfg = load_config(str(p))
    assert cfg.camera_type == "PinHole"
    assert abs(cfg.K[0] - 458.654) < 1e-3
    assert abs(cfg.D[0] + 0.28340811) < 1e-6
    assert cfg.n_features == 1000
    assert cfg.has_imu
    assert cfg.imu_freq == 200


def test_missing_required_key_raises(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text('%YAML:1.0\nCamera.fx: 100.0\n')
    with pytest.raises(ValueError):
        load_config(str(p))


RECT_BLOCK = """
LEFT.width: 752
LEFT.height: 480
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0.0, 367.45, 0.0, 0.0, 435.2, 252.2, 0.0, 0.0, 0.0, 1.0, 0.0]
RIGHT.width: 752
RIGHT.height: 480
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1.0]
RIGHT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
RIGHT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0.0, 367.45, -47.9, 0.0, 435.2, 252.2, 0.0, 0.0, 0.0, 1.0, 0.0]
"""


def test_stereo_rectification_maps(tmp_path):
    """LEFT./RIGHT. rectification blocks (reference
    Examples/Stereo/stereo_euroc.cc:92-118) produce valid remap maps."""
    p = tmp_path / "EuRoC_stereo.yaml"
    p.write_text(EUROC_YAML + RECT_BLOCK)
    cfg = load_config(str(p))
    assert cfg.rect_left is not None and cfg.rect_right is not None
    maps = cfg.stereo_rectify_maps()
    assert maps is not None
    (m1x, m1y), (m2x, m2y) = maps
    assert m1x.shape == (480, 752)
    import numpy as np
    # the map must be a plausible pixel mapping (finite, in-range center)
    assert np.isfinite(m1x).all()
    assert abs(m1x[240, 376] - 376) < 40 and abs(m1y[240, 376] - 240) < 40
