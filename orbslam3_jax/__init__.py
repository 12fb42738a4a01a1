"""orbslam3_jax — a JAX visual / visual-inertial / multi-map SLAM framework.

A from-scratch rebuild of the capability surface of ORB-SLAM3 (reference:
UZ-SLAMLab ORB-SLAM3 V0.4 fork) as a host state machine over accelerator
kernels:

- Device compute is fixed-shape, batched, functional JAX/XLA; the host runs
  the asynchronous SLAM state machine.
- The reference's pointer-graph map model (KeyFrame/MapPoint objects,
  covisibility graph) becomes masked structure-of-arrays pools with static
  capacities, so every algorithm (matching, triangulation, bundle adjustment,
  pose-graph optimization) is a jitted kernel over dense arrays.
- g2o is replaced by our own Gauss-Newton / Levenberg-Marquardt solvers with
  block-sparse Schur complement (`ops/ba.py`), DBoW2 by an array-form binary
  vocabulary (`ops/vocab.py`), and the ORB extractor by batched pyramid
  FAST+BRIEF kernels (`ops/features.py`).
- Multi-device scaling shards map points (landmark Schur blocks) over a
  `jax.sharding.Mesh` (`parallel/`), with `psum` reductions for the pose
  system — the data-parallel analogue of the reference's thread-level
  pipeline (reference src/System.cc:135-161).
"""

__version__ = "0.1.0"

# SLAM geometry (pose LM, triangulation, Schur BA) is numerically fragile:
# accelerator matmuls may default to reduced-precision passes (TF32 on an
# NVIDIA GPU, about 10 mantissa bits), which corrupt normal equations and
# projection chains. "highest" keeps every matmul in plain float32; the few
# contractions that are measured safe at lower precision ask for it
# explicitly (ops/ba.py). The FLOP-heavy kernels (Hamming matching, FAST)
# are integer/boolean and unaffected by this setting.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")
