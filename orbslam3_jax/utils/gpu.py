"""The device check shared by the measurement entry points (bench.py,
chip_smoke.py): they measure the GPU or nothing, never a CPU fallback."""
from __future__ import annotations

import subprocess


def require_gpu(n_devices: int = 1):
    """Return ``jax.devices()`` when the default backend is a GPU with at
    least ``n_devices`` devices; raise RuntimeError otherwise."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].device_kind!r} on "
            f"platform {devs[0].platform!r}")
    if len(devs) < n_devices:
        raise RuntimeError(f"{n_devices} GPUs needed, JAX sees {len(devs)}")
    return devs


def card_name_and_power_limit() -> list[str]:
    """One "name, power.limit" line per card, as nvidia-smi reports them
    (a card set below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
