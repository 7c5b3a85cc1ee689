"""Shared band-sweep kernel contract.

A *job* sweeps a row band ``r0 .. r0+S`` against a diagonal chunk
``k0 .. k0+W`` of the upper-triangular self-join.  Coordinates:

* lane ``j`` of the QT carry tracks diagonal ``k0 + j`` (diagonal-aligned,
  like the reference kernels' QT buffer, kernel/MatrixProfileKernelVanilla.cpp:27);
* at local row ``i`` the lane touches column ``c0 + i + j`` with
  ``c0 = r0 + k0``;
* the column-aggregate state is column-aligned: lane ``j`` accumulates
  column ``c0 + j`` over the whole band (the reference's shifting
  double-buffer, kernel/MatrixProfileKernelVanilla.cpp:92-96, and its
  expired-column streaming protocol collapse into one static window).

Outputs (all (value, index) aggregate pairs):

* ``row`` — (S,)      row aggregates for rows r0..r0+S
* ``col`` — (S + W,)  column aggregates for columns c0..c0+S+W

The driver max-merges these windows into global row/column profiles
(the UpdateAggregates analog), so jobs may be scheduled in any order,
across grid steps or across chips.

Masking rules (per pair (r, c), diag k = c - r):

* in-bounds:      r <= w-1 and c <= w-1   (w = n - m + 1)
* exclusion zone: k >= m // 4             (MatrixProfileReference.hpp:72-79)
* finite stats:   inv[r] and inv[c] finite — zero-variance subsequences
  never match (documented deviation: the reference lets inf/NaN
  correlations poison comparisons for degenerate inputs; mpx skips them).

Masked pairs contribute the aggregate init (-1e12), never 0: the reference
kernels mask with P=0 (kernel/MatrixProfileKernelVanilla.cpp:84), which can
beat genuine negative correlations — a bug mpx does not reproduce.
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from mpx.types import Aggregates


class BandOut(NamedTuple):
    row: Aggregates  # (S,)      rows r0 .. r0+S
    col: Aggregates  # (S + W,)  columns c0 .. c0+S+W


class BandGeometry(NamedTuple):
    S: int      # band rows
    W: int      # chunk diagonals
    m: int      # subsequence length
    w: int      # row-axis profile width (n - m + 1 of the query series)
    excl: int   # exclusion zone m // 4 (negative: none — AB-joins)
    tr: int     # tile rows (MP_SIZE_T analog); no kernel reads it
    tc: int     # tile diagonals; no kernel reads it
    wc: int     # column-axis profile width (== w for self-joins)


def band_geometry(
    S: int, W: int, m: int, w: int, tr: int = 8, tc: int = 2048,
    wc: int | None = None, excl: int | None = None,
) -> BandGeometry:
    tr = min(tr, S)
    tc = min(tc, W)
    if S % tr or W % tc:
        raise ValueError(f"band {S} / chunk {W} must tile by ({tr}, {tc})")
    return BandGeometry(
        S=S, W=W, m=m, w=w,
        excl=m // 4 if excl is None else excl,
        tr=tr, tc=tc,
        wc=w if wc is None else wc,
    )


def seed_qt(stats, r0, c0, W: int, m: int):
    """Exact QT seed for row r0 against columns [c0, c0+W):

    ``QT(r0, c) = sum_j (T[r0+j] - mu[r0]) (T[c+j] - mu[c])``.  This closed
    form (a 1-D convolution -> MXU) replaces the reference's row-serial QT
    carry between chunks and makes bands independent.

    Numerically it is evaluated in a cancellation-resistant form: with a
    *centered* query ``qc = T[r0:r0+m] - mu[r0]`` and the column segment
    re-based to its own mean ``g``,

        QT(r0, c) = SDP(qc, T[seg] - g) - (mu[c] - g) * sum(qc).

    The naive ``SDP(q, T) - m*mu_r*mu_c`` subtracts two terms of order
    ``m * amplitude^2`` to produce a result of order ``m * deviation^2`` —
    in float32 that destroys the seed for long, drifting series.  Centering
    both operands makes every product O(local deviation), so the float32
    error stays ~sqrt(m) ulps of the *result*."""
    import jax.numpy as jnp
    from mpx.ops.precompute import sliding_dot_product

    q = jax.lax.dynamic_slice(stats.T, (r0,), (m,))
    seg = jax.lax.dynamic_slice(stats.T, (c0,), (W + m - 1,))
    mu_r = jax.lax.dynamic_slice(stats.mu, (r0,), (1,))[0]
    mu_c = jax.lax.dynamic_slice(stats.mu, (c0,), (W,))

    qc = q - mu_r
    g = jnp.mean(seg)
    sdp = sliding_dot_product(qc, seg - g)
    # sum(qc) is ~0 up to rounding; the correction keeps the identity exact.
    return sdp - (mu_c - g) * jnp.sum(qc)
