"""Device runtime layer.

The analog of the reference's OpenCL wrapper (include/host/OpenCL.hpp):
where that wraps Xilinx device discovery, DDR-bank buffer placement,
xclbin programming, and queue synchronization, the JAX equivalents are

* device discovery            -> :func:`devices` / :class:`DeviceContext`
* ``Buffer::CopyFromHost``    -> :meth:`DeviceContext.to_device`
* ``Buffer::CopyToHost``      -> :meth:`DeviceContext.to_host`
* xclbin ``Program``          -> jit compilation + the persistent
                                 compilation cache (:func:`enable_compilation_cache`)
* ``Context::Finish`` (ns)    -> :meth:`DeviceContext.finish`
* compute-unit addressing     -> the mesh in :mod:`mpx.parallel.mesh`

There is deliberately no buffer-bank management: XLA owns device memory
placement.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import numpy as np

from mpx.utils.logging import Logger

_CACHE_ENABLED = False

# The in-checkout cache directory used when JAX_COMPILATION_CACHE_DIR is
# unset: a fixed path, because the path is part of the cache key.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _cpu_cache_suffix() -> str:
    """Per-machine subdirectory for CPU-backend caches.

    XLA:CPU persists AOT-compiled executables whose machine features are
    baked in at compile time; loading one on a host with different
    features logs ``cpu_aot_loader`` errors and can SIGILL/segfault.
    Accelerator executables are device-keyed, so only CPU runs get it."""
    try:
        import hashlib

        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith("flags")]
        digest = hashlib.sha256(flags[0].encode()).hexdigest()[:8]
        return f"cpu-{digest}"
    except Exception:
        return "cpu-unknown"


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR``
    when set (and nothing else), otherwise ``DEFAULT_CACHE_DIR`` inside
    the checkout — with a per-machine subdirectory on the CPU backend
    only (see _cpu_cache_suffix)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return os.path.join(DEFAULT_CACHE_DIR, _cpu_cache_suffix())
    return DEFAULT_CACHE_DIR


def enable_compilation_cache():
    """Persist compiled executables across processes (the analog of
    shipping a prebuilt xclbin instead of re-synthesizing) in
    :func:`compilation_cache_dir`.  Safe to call repeatedly."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED:
        return
    path = compilation_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _CACHE_ENABLED = True
        Logger.verbose_log(f"compilation cache at {path}")
    except Exception as e:  # cache support is best-effort
        Logger.warning(f"compilation cache unavailable: {e}")


def devices(platform: Optional[str] = None):
    return jax.devices(platform) if platform else jax.devices()


class DeviceContext:
    """Thin staging/synchronization helper around one device."""

    def __init__(self, device=None):
        self.device = device if device is not None else jax.devices()[0]
        self._pending = []

    def to_device(self, array, dtype=None):
        arr = np.asarray(array, dtype=dtype) if dtype else np.asarray(array)
        out = jax.device_put(arr, self.device)
        self._pending.append(out)
        return out

    @staticmethod
    def to_host(array) -> np.ndarray:
        return np.asarray(array)

    def finish(self, *values) -> int:
        """Block until all tracked (and passed) values are ready; returns
        elapsed nanoseconds (Context::Finish analog, OpenCL.hpp:85-89)."""
        t0 = time.perf_counter_ns()
        jax.block_until_ready(list(values) + self._pending)
        self._pending.clear()
        return time.perf_counter_ns() - t0

    @property
    def platform(self) -> str:
        return self.device.platform

    def memory_stats(self) -> dict:
        try:
            return dict(self.device.memory_stats() or {})
        except Exception:
            return {}
