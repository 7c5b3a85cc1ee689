"""Runtime configuration.

The reference bakes every parameter into the bitstream at compile time via
CMake cache variables validated in CMakeLists.txt:54-94 (n, m, w, t, dtype,
kernel, replication).  mpx collapses this two-tier config into one runtime
dataclass whose shape-like fields become jit static arguments:

* ``m``          — subsequence length (MP_SIZE_M)
* ``dtype``      — compute dtype (MP_DATA_TYPE: double/float)
* ``kernel``     — 'auto' | 'mxu' | 'xla' | 'hybrid' (MP_KERNEL analog)
* ``chunk``      — diagonals per job, the host-chunk analog (MP_SIZE_W)
* ``band``       — rows per job; new in mpx: QT is re-seeded exactly at
  every band start (closed form on the MXU), which removes the global
  row-serial dependence and makes every (band x chunk) job independent —
  the enabler for one-compile scheduling, sharding, and checkpointing.
* ``tile_rows`` / ``tile_cols`` — tile of the band geometry (MP_SIZE_T
  analog).  No kernel reads them any more: they only constrain ``band``
  / ``chunk`` (multiples of the tile) and the rounding in ``shrink_to``;
  the tiers pass them on as ``tr``/``tc`` into ``BandGeometry``
* ``num_shards`` — device count for the sharded path (MP_KERNEL_REPL)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mpx.dtypes import canonical_dtype
from mpx.kernels import check_kernel
from mpx.types import JobGrid

@dataclasses.dataclass(frozen=True)
class MatrixProfileConfig:
    m: int = 32
    dtype: str = "float32"
    kernel: str = "auto"
    band: int = 4096
    chunk: int = 16384
    tile_rows: int = 8
    tile_cols: int = 2048
    num_shards: Optional[int] = None
    # Fixed-point input tier (the reference's ap_fixed dtypes,
    # CMakeLists.txt:71 / ArbitraryPrecisionFixed.hpp:18-37): quantize
    # the input series to this ap grid before computing.  Set
    # automatically when ``dtype`` names an ap format ('ap16'/'ap24' ->
    # float32 compute, 'ap32'/'ap64' -> float64); see mpx/io/apfixed.py.
    input_quant: Optional[str] = None
    # Multi-chip input strategy: 'jobs' replicates the O(n) statistics
    # and shards the job list; 'ring' shards the inputs themselves and
    # rotates column blocks between devices (O(n / num_shards) memory
    # per device).
    shard_mode: str = "jobs"
    # Jobs per device dispatch: a positive count splits the job scan
    # into groups of that many jobs (merged on device).  None or 0 runs
    # every job in one dispatch.
    dispatch_group: Optional[int] = None

    def __post_init__(self):
        # ap_fixed dtype names select the quantized-input tier with the
        # narrowest exact compute dtype (ap16/ap24 mantissas fit f32;
        # ap32/ap64 need f64 — routed through the hybrid tier).
        key = self.dtype.lower() if isinstance(self.dtype, str) else None
        if key in ("ap16", "ap24", "ap32", "ap64"):
            if self.input_quant not in (None, key):
                raise ValueError(
                    f"dtype={self.dtype!r} conflicts with "
                    f"input_quant={self.input_quant!r}"
                )
            object.__setattr__(self, "input_quant", key)
            object.__setattr__(
                self, "dtype",
                "float32" if key in ("ap16", "ap24") else "float64",
            )
        elif self.input_quant is not None:
            from mpx.io.apfixed import get_format

            get_format(self.input_quant)  # raises on unknown
        canonical_dtype(self.dtype)  # raises on unsupported
        check_kernel(self.kernel)
        if self.shard_mode not in ("jobs", "ring"):
            raise ValueError(
                f"shard_mode must be 'jobs' or 'ring', got {self.shard_mode!r}"
            )
        if self.m < 4:
            raise ValueError("m must be >= 4 (exclusion zone is m/4)")
        for name in ("band", "chunk", "tile_rows", "tile_cols"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be positive")
        # Tiles never exceed the job extent (small-problem configs keep
        # the large defaults usable).
        object.__setattr__(self, "tile_rows", min(self.tile_rows, self.band))
        object.__setattr__(self, "tile_cols", min(self.tile_cols, self.chunk))
        if self.band % self.tile_rows != 0:
            raise ValueError("band must be a multiple of tile_rows")
        if self.chunk % self.tile_cols != 0:
            raise ValueError("chunk must be a multiple of tile_cols")

    def validate_series(self, n: int, T=None):
        if n < self.m:
            raise ValueError(f"series length n={n} must be >= m={self.m}")
        if n - self.m + 1 < 2:
            raise ValueError("need at least 2 subsequences for a self-join")
        if T is not None:
            import numpy as np

            Tn = np.asarray(T)
            if not np.isfinite(Tn).all():
                bad = int(np.nonzero(~np.isfinite(Tn))[0][0])
                raise ValueError(
                    f"series contains a non-finite value at index {bad}; "
                    f"NaN/inf would silently poison every correlation "
                    f"(the reference computes garbage on such input)"
                )

    def shrink_to(self, w: int) -> "MatrixProfileConfig":
        """Clamp band/chunk (and tiles) to the actual profile width so tiny
        inputs do not pay for full-size padded jobs."""
        band = min(self.band, _round_up(w, self.tile_rows))
        chunk = min(self.chunk, _round_up(w, self.tile_cols))
        if band == self.band and chunk == self.chunk:
            return self
        return dataclasses.replace(self, band=band, chunk=chunk)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def make_job_grid(w: int, band: int, chunk: int) -> JobGrid:
    """Decompose the upper triangle of the (w x w) join into jobs.

    Chunk k0 covers diagonals [k0, k0+chunk) and rows [0, w - k0); bands
    cut those rows into height-``band`` strips.  This is the analog of the
    reference's iteration loop over diagonal chunks
    (host/MatrixProfileHost.cpp:101-128) with the added band split."""
    r0s, k0s = [], []
    for k0 in range(0, w, chunk):
        for r0 in range(0, w - k0, band):
            r0s.append(r0)
            k0s.append(k0)
    return JobGrid(
        r0=np.asarray(r0s, dtype=np.int32),
        k0=np.asarray(k0s, dtype=np.int32),
        band=band,
        chunk=chunk,
    )


def pad_jobs(r0s: np.ndarray, c0s: np.ndarray, multiple: int,
             dummy_r0: int) -> tuple:
    """Pad raw (r0, c0) job arrays to a multiple of ``multiple`` with
    dummy jobs whose rows are entirely out of range (the rectangle-grid
    analog of :func:`pad_job_grid`; idempotent merges make them no-ops)."""
    pad = -r0s.shape[0] % multiple
    if not pad:
        return r0s, c0s
    return (np.concatenate([r0s, np.full(pad, dummy_r0, np.int32)]),
            np.concatenate([c0s, np.zeros(pad, np.int32)]))


def pad_job_grid(grid: JobGrid, multiple: int, dummy_r0: int) -> JobGrid:
    """Pad the job list to a multiple (for even sharding) with dummy jobs
    whose rows are entirely out of range; max-merges make them no-ops."""
    num = grid.r0.shape[0]
    padded = _round_up(num, multiple)
    if padded == num:
        return grid
    pad = padded - num
    return JobGrid(
        r0=np.concatenate([grid.r0, np.full(pad, dummy_r0, np.int32)]),
        k0=np.concatenate([grid.k0, np.zeros(pad, np.int32)]),
        band=grid.band,
        chunk=grid.chunk,
    )
