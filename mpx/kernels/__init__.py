"""Kernel backends.

Two implementations of the same band-sweep contract (see
:mod:`mpx.kernels.common`):

* ``mxu`` — the correlation tile as a unit-normalized-windows matmul;
  puts the O(n^2 m) FLOPs on the device's matrix units (cuBLAS on the
  GPU, BLAS on the CPU).  The default on every backend.
* ``xla`` — pure jnp/lax.scan SCAMP recurrence; the behavioral analog
  of the reference's Vanilla kernel (kernel/MatrixProfileKernelVanilla.cpp);
  O(1) work per pair, preferable for very large m.

``resolve_kernel`` implements the 'auto' policy: the matmul kernel for
every m the reference supports, the hybrid tier for float64 and for
large float32 self-joins, and the recurrence for f64 beyond MXU_MAX_M.
"""

from __future__ import annotations

import numpy as np

from mpx.kernels.common import BandOut, band_geometry
from mpx.kernels.xla import sweep_band_xla

# Hybrid-tier eligibility ceiling: the hybrid's f32 matmul sweeps pay an
# O(m)-HLO compile cost (minutes beyond m~4096, amortized by the
# persistent cache); past it the strict f64 recurrence takes over.
MXU_MAX_M = 4096

# Minimum profile width for routing float32 'auto' through the hybrid
# tier: its two-pass sweeps write no P tile in pass A and touch ~1 row
# per job in pass B, but carry fixed host work (f64 stats + rescore).
# The crossover against the one-pass tile is not yet measured on the
# GPU; 2^19 is the value the tier was introduced with.
HYBRID32_MIN_W = 1 << 19

# Sweep kernels a caller may name (besides 'auto' and 'hybrid').
SWEEP_KERNELS = ("mxu", "xla")


def check_kernel(kernel: str, allowed=("auto", "hybrid") + SWEEP_KERNELS):
    """Raise a ValueError naming the valid choices for an unknown (or
    removed) kernel name."""
    if kernel not in allowed:
        raise ValueError(
            f"unknown kernel {kernel!r}; choose one of {', '.join(allowed)}"
        )


def resolve_kernel(
    kernel: str,
    dtype,
    m: int = 0,
    allow_hybrid: bool = False,
    w: int = 0,
) -> str:
    check_kernel(kernel)
    if kernel != "auto":
        return kernel
    if np.dtype(dtype) == np.dtype(np.float64):
        if allow_hybrid and (not m or m <= MXU_MAX_M):
            # The hybrid tier (f32 matmul sweeps + exact host-f64
            # rescoring, mpx.hybrid) computes the identical exact
            # profile.  Whether native f64 matmuls beat it on the GPU is
            # an open measurement (ROADMAP speed item 3).
            return "hybrid"
        if m and m > MXU_MAX_M:
            # at large m the O(1) recurrence wins for the strict tier
            return "xla"
        return "mxu"
    if (
        np.dtype(dtype) == np.dtype(np.float32)
        and allow_hybrid
        and (not m or m <= MXU_MAX_M)
        and w >= HYBRID32_MIN_W
    ):
        # Large float32 self-joins: the hybrid tier is exact (f64-true
        # values cast to f32) and avoids materializing every P tile.
        return "hybrid"
    return "mxu"


def get_sweep_fn(kernel: str):
    check_kernel(kernel, SWEEP_KERNELS)
    if kernel == "xla":
        return sweep_band_xla
    from mpx.kernels.mxu import sweep_band_mxu

    return sweep_band_mxu


__all__ = [
    "BandOut", "band_geometry", "check_kernel", "resolve_kernel",
    "get_sweep_fn", "sweep_band_xla", "SWEEP_KERNELS",
]
