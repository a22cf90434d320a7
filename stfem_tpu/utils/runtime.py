"""Process-level runtime helpers shared by bench.py, chip_smoke.py and the
CLI drivers: the persistent compile cache, the device guard, and the
device description every measured result carries."""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

# <checkout>/.jax_cache (listed in .gitignore): a fixed path, because the
# path is part of the cache key and a directory that moves never hits
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def configure_compile_cache() -> str:
    """Persistent compile cache.  When JAX_COMPILATION_CACHE_DIR is set,
    JAX reads it itself and no directory is set here; otherwise the cache
    goes to DEFAULT_CACHE_DIR.  Returns the directory in use."""
    import jax

    # the ~10 per-level setup compiles take 0.5-3 s each; cache them too
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or None
    where there is no nvidia-smi (the only child process this runs)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info() -> dict:
    """platform, device_kind and device count as JAX reports them, plus the
    card's name and power limit (None off a GPU)."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit()}


class NoAcceleratorError(RuntimeError):
    """Raised where a measurement would otherwise fall back to the CPU."""


def require_gpu() -> None:
    """Refuse to measure anywhere but on a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise NoAcceleratorError(
            f"JAX found no GPU (default platform: {platform}); device "
            f"timings are only taken on the card")


def peak_bytes_in_use(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")
