"""Test configuration: an 8-device virtual CPU mesh unless told otherwise.

The suite runs on the CPU backend by default (JAX_PLATFORMS=cpu); the
multi-device sharding tests run on 8 virtual CPU devices
(xla_force_host_platform_device_count). Tests marked ``gpu`` need a card:
run them on one with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
Elsewhere they skip, decided inside the ``gpu`` fixture.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


import pytest


@pytest.fixture
def gpu():
    """The first GPU, or a skip where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; run with JAX_PLATFORMS=cuda,cpu on a card")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    The XLA:CPU backend segfaults inside LLVM codegen once a single process
    has accumulated enough large compiled programs (reproduced
    deterministically: the 29th test's first extractor compile crashes after
    the first 28 tests' compilations, regardless of codegen threading).
    Clearing the jit caches per module keeps the compiler healthy; modules
    recompile what they share (a few seconds each)."""
    yield
    import gc
    import jax
    jax.clear_caches()
    gc.collect()


def dense_tracking_params(**kw):
    """Tracking params for the short synthetic fixtures: their per-frame
    motion is much larger than a real 20 fps camera's and rendered features
    don't churn the way real ones do, so the reference c2 condition rarely
    fires — pin a fixed 5-frame keyframe cadence instead (the effective
    density the reference reaches on real imagery)."""
    from orbslam3_jax.models.tracking import TrackingParams
    kw.setdefault("kf_interval_override", 5)
    return TrackingParams(**kw)
