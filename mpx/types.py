"""Core data containers (struct-of-arrays).

The analog of the reference's kernel ABI packs
(include/kernel/DataPacks.hpp:11-28, include/Config.hpp.in:61-73): instead of
an array-of-structs ``InputDataPack{QT, df, dg, inv}`` per subsequence, mpx
keeps four parallel vectors (device-friendly struct-of-arrays), plus the raw
series and rolling means needed for exact QT band re-seeding.

Aggregates (``OutputDataPack``'s ``aggregate_t{value, index}``) become a
(value array, int32 index array) pair.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import numpy as np


class Stats(NamedTuple):
    """Precomputed per-subsequence statistics (padded, device-resident).

    All arrays have length ``padded_w`` >= n - m + 1; the pad region is
    zero-filled so out-of-range lanes behave like the reference's
    ``InputDataPack(0)`` (kernel/MatrixProfileKernelVanilla.cpp:52-53).
    ``T`` is padded to ``padded_w + m - 1`` for window extraction.

    ``windows`` optionally holds the unit-normalized window matrix
    ``(padded_w, m)`` (zero rows for zero-variance/padded windows) so the
    MXU kernel can slice operand panels instead of rebuilding them per
    job (~25-35%% faster; HBM-resident, built only when it fits the
    budget — see precompute_statistics).
    """

    T: jax.Array      # (padded_w + m - 1,) raw series
    mu: jax.Array     # (padded_w,) rolling means
    df: jax.Array     # (padded_w,) update coefficients
    dg: jax.Array     # (padded_w,)
    inv: jax.Array    # (padded_w,) inverse centered norms
    qt0: jax.Array    # (padded_w,) first-row dot products QT(0, c)
    windows: Optional[jax.Array] = None  # (padded_w, m) normalized windows


class Aggregates(NamedTuple):
    """Row/column-merged (max-correlation, neighbor-index) aggregates."""

    value: jax.Array  # Pearson correlations, aggregate-initialized
    index: jax.Array  # int32 neighbor indices, -1-initialized


class JobGrid(NamedTuple):
    """Static decomposition of the upper-triangular join into
    (row-band r0, diagonal-chunk k0) jobs — the schedule unit for both the
    single-chip scan and the multi-chip sharding (the analog of the
    reference's host iteration loop, host/MatrixProfileHost.cpp:101-128,
    and its MP_KERNEL_REPL round-robin)."""

    r0: np.ndarray        # (num_jobs,) int32 band start rows
    k0: np.ndarray        # (num_jobs,) int32 chunk start diagonals
    band: int             # S: rows per band
    chunk: int            # W: diagonals per chunk
