"""Sum-threshold and frequency profiles (SCAMP SUM_THRESH analog).

Beyond reference parity: the reference computes only the 1-NN profile
(host/MatrixProfileHost.cpp:54-160), but the wider SCAMP family also
ships *aggregate* profile types — per window, the SUM of correlations
above a threshold (SUM_THRESH) and the COUNT of neighbors above it
(FREQUENCY_THRESH).  These turn the join into a density measure: high
sums mark windows whose shape recurs often (background rhythms), near
-zero sums mark isolated shapes — complementary to the 1-NN discord
view, and the standard tool for "how common is this pattern?" queries.

The (S x W) correlation tile is the SAME unit-window matmul the 1-NN
tiers use (kernels/mxu._job_correlations); only the
epilogue changes — instead of (max, iota-min index) reductions, a
masked sum and a popcount per row and per column, accumulated into
carried (L,) arrays by one lax.scan over the identical upper-triangle
job grid (each valid pair is visited exactly once, so add-merging is
exact where max-merging was idempotent).  The threshold rides as a
traced scalar — one compiled executable serves every threshold.

Semantics (matching SCAMP): a pair contributes its Pearson correlation
``P(r, c)`` to BOTH windows' sums iff ``P > threshold``; exclusion
zone, bounds, and degenerate (zero-variance) windows are masked exactly
like the 1-NN tiers (kernels/common.py masking rules).  float32 sums
accumulate ~sqrt(count) ulp error; the float64 dtype routes through the
XLA-emulated exact path like every other mpx tier.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import canonical_dtype, needs_x64, x64_scope
from mpx.kernels import band_geometry
from mpx.kernels.mxu import _job_correlations


def _add_window(acc, win, offset):
    seg = jax.lax.dynamic_slice(acc, (offset,), (win.shape[0],))
    return jax.lax.dynamic_update_slice(acc, seg + win, (offset,))


@partial(jax.jit, static_argnames=("S", "W", "m", "w", "dt", "tr", "tc"))
def _run_thresh_jobs(stats, threshold, r0s, k0s, sums0, cnts0, *,
                     S: int, W: int, m: int, w: int, dt,
                     tr: int = 8, tc: int = 2048):
    """One dispatch: scan a job-group, adding into carried (L,) arrays.

    The caller loops over dispatch groups, feeding each dispatch's
    accumulators into the next (same contract as driver run_jobs
    grouping); dummy padding jobs (r0 >= w) mask to zero contribution.
    """
    dtype = jnp.dtype(dt)
    geom = band_geometry(S, W, m, w, tr, tc)
    thr = threshold.astype(dtype)

    def body(carry, job):
        sums, cnts = carry
        r0, k0 = job
        c0 = r0 + k0
        P, valid, _, _ = _job_correlations(stats, r0, c0, geom, dtype)
        hit = valid & (P > thr)
        Ph = jnp.where(hit, P, jnp.zeros((), dtype))
        sums = _add_window(sums, jnp.sum(Ph, axis=1), r0)
        sums = _add_window(sums, jnp.sum(Ph, axis=0), c0)
        # explicit int32 accumulator: x64 scope would promote to int64
        cnts = _add_window(cnts, jnp.sum(hit, axis=1, dtype=jnp.int32), r0)
        cnts = _add_window(cnts, jnp.sum(hit, axis=0, dtype=jnp.int32), c0)
        return (sums, cnts), None

    (sums, cnts), _ = jax.lax.scan(body, (sums0, cnts0), (r0s, k0s))
    return sums, cnts


def compute_sum_thresh(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    threshold: float = 0.0,
):
    """Sum-threshold + frequency profile of the self-join of ``T``.

    Returns ``(sums, counts)``: per window, the sum of Pearson
    correlations to every non-trivial neighbor with correlation
    strictly above ``threshold``, and how many such neighbors exist.
    Same config knobs (band/chunk/dtype/input_quant) as the 1-NN
    driver; the threshold is a runtime scalar (no recompile per value).
    """
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if not -1.0 <= threshold <= 1.0:
        raise ValueError(f"threshold must be in [-1, 1], got {threshold}")
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the sum-threshold tier is single-device; "
                         "drop num_shards")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the sum-threshold tier has one kernel "
                         "(windows matmul); use kernel='auto'")
    T = np.asarray(T)
    n = T.shape[0]
    config.validate_series(n, T)
    if config.input_quant is not None:
        from mpx.io.apfixed import quantize

        T = quantize(np.asarray(T, np.float64), config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)

    from mpx.config import pad_job_grid
    from mpx.ops.precompute import precompute_statistics

    grid = make_job_grid(w, S, W)
    # Dispatch grouping, same policy as the 1-NN driver: an explicit
    # config.dispatch_group cuts the job list into dispatches whose
    # accumulators carry device-to-device; otherwise one dispatch.
    group = config.dispatch_group
    njobs = grid.r0.shape[0]
    if not group or group >= njobs:
        group = njobs
    grid = pad_job_grid(grid, group, dummy_r0=w)
    with x64_scope(needs_x64(dt)):
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt,
                                      matmul_only=True)
        thr = jnp.asarray(float(threshold),
                          jnp.float64 if needs_x64(dt) else jnp.float32)
        L = w + S + W
        sums = jnp.zeros(L, canonical_dtype(config.dtype))
        cnts = jnp.zeros(L, jnp.int32)
        for off in range(0, grid.r0.shape[0], group):
            sums, cnts = _run_thresh_jobs(
                stats, thr,
                jnp.asarray(grid.r0[off : off + group]),
                jnp.asarray(grid.k0[off : off + group]),
                sums, cnts,
                S=S, W=W, m=m, w=w, dt=str(dt),
                tr=config.tile_rows, tc=config.tile_cols,
            )
        return np.asarray(sums)[:w], np.asarray(cnts)[:w]


@partial(jax.jit, static_argnames=("S", "W", "m", "wa", "wb", "dt",
                                   "tr", "tc"))
def _run_thresh_ab_jobs(stats_a, stats_b, threshold, r0s, c0s,
                        sums0, cnts0, *, S: int, W: int, m: int,
                        wa: int, wb: int, dt, tr: int = 8, tc: int = 2048):
    """AB variant of :func:`_run_thresh_jobs`: rectangle tiles (rows from
    A, columns from B), no exclusion zone, contributions credited to the
    A side only (pyscamp.abjoin_sum semantics)."""
    dtype = jnp.dtype(dt)
    geom = band_geometry(S, W, m, wa, tr, tc, wc=wb, excl=0)
    thr = threshold.astype(dtype)

    def body(carry, job):
        sums, cnts = carry
        r0, c0 = job
        P, valid, _, _ = _job_correlations(stats_a, r0, c0, geom, dtype,
                                           stats_c=stats_b, two_sided=True)
        hit = valid & (P > thr)
        Ph = jnp.where(hit, P, jnp.zeros((), dtype))
        sums = _add_window(sums, jnp.sum(Ph, axis=1), r0)
        cnts = _add_window(cnts, jnp.sum(hit, axis=1, dtype=jnp.int32), r0)
        return (sums, cnts), None

    (sums, cnts), _ = jax.lax.scan(body, (sums0, cnts0), (r0s, c0s))
    return sums, cnts


def compute_sum_thresh_ab(
    A,
    B,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    threshold: float = 0.0,
):
    """Sum-threshold + frequency profile of the AB-join: per window of
    ``A``, the sum of its Pearson correlations to every window of ``B``
    strictly above ``threshold``, and the count of such neighbors.
    No exclusion zone (the series are distinct), matching the AB 1-NN
    tier's masking (mpx/abjoin.py)."""
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if not -1.0 <= threshold <= 1.0:
        raise ValueError(f"threshold must be in [-1, 1], got {threshold}")
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the sum-threshold tier is single-device; "
                         "drop num_shards")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the sum-threshold tier has one kernel "
                         "(windows matmul); use kernel='auto'")
    A, B = np.asarray(A), np.asarray(B)
    config.validate_series(A.shape[0], A)
    config.validate_series(B.shape[0], B)
    if config.input_quant is not None:
        from mpx.io.apfixed import quantize

        A = quantize(np.asarray(A, np.float64), config.input_quant)
        B = quantize(np.asarray(B, np.float64), config.input_quant)
    wa = A.shape[0] - m + 1
    wb = B.shape[0] - m + 1
    config = config.shrink_to(max(wa, wb))
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)

    from mpx.ops.precompute import precompute_statistics

    rr, cc = np.meshgrid(np.arange(0, wa, S, dtype=np.int32),
                         np.arange(0, wb, W, dtype=np.int32))
    r0s, c0s = rr.ravel(), cc.ravel()
    group = config.dispatch_group
    njobs = r0s.shape[0]
    if not group or group >= njobs:
        group = njobs
    from mpx.config import pad_jobs

    r0s, c0s = pad_jobs(r0s, c0s, group, dummy_r0=wa)

    with x64_scope(needs_x64(dt)):
        stats_a = precompute_statistics(A, m, band=S, chunk=W, dtype=dt,
                                        matmul_only=True)
        stats_b = precompute_statistics(B, m, band=S, chunk=W, dtype=dt,
                                        matmul_only=True)
        thr = jnp.asarray(float(threshold),
                          jnp.float64 if needs_x64(dt) else jnp.float32)
        L = wa + S + W
        sums = jnp.zeros(L, dt)
        cnts = jnp.zeros(L, jnp.int32)
        for off in range(0, r0s.shape[0], group):
            sums, cnts = _run_thresh_ab_jobs(
                stats_a, stats_b, thr,
                jnp.asarray(r0s[off : off + group]),
                jnp.asarray(c0s[off : off + group]),
                sums, cnts,
                S=S, W=W, m=m, wa=wa, wb=wb, dt=str(dt),
                tr=config.tile_rows, tc=config.tile_cols,
            )
        return np.asarray(sums)[:wa], np.asarray(cnts)[:wa]


def brute_force_sum_thresh_ab(A, B, m: int, threshold: float = 0.0):
    """O(wa * wb * m) numpy oracle for the AB sum-threshold profile."""
    from mpx.ops.precompute import precompute_statistics_numpy

    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    sa = precompute_statistics_numpy(A, m)
    sb = precompute_statistics_numpy(B, m)
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    Ua = np.stack([A[i : i + m] for i in range(wa)])
    Ua = (Ua - sa["mu"][:, None]) * np.where(
        np.isfinite(sa["inv"]), sa["inv"], 0.0)[:, None]
    Ub = np.stack([B[i : i + m] for i in range(wb)])
    Ub = (Ub - sb["mu"][:, None]) * np.where(
        np.isfinite(sb["inv"]), sb["inv"], 0.0)[:, None]
    P = Ua @ Ub.T
    valid = np.isfinite(sa["inv"])[:, None] & np.isfinite(sb["inv"])[None, :]
    hit = valid & (P > threshold)
    Ph = np.where(hit, P, 0.0)
    return Ph.sum(axis=1), hit.sum(axis=1).astype(np.int64)


def brute_force_sum_thresh(T, m: int, threshold: float = 0.0):
    """O(n^2) numpy oracle: masked correlation-matrix sum/count."""
    from mpx.reference import (
        exclusion_zone,
        znormalized_distance_matrix,
    )

    T = np.asarray(T, np.float64)
    D = znormalized_distance_matrix(T, m)
    w = D.shape[0]
    P = 1.0 - (D * D) / (2.0 * m)
    i, j = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    valid = (np.abs(i - j) >= exclusion_zone(m)) & np.isfinite(P)
    hit = valid & (P > threshold)
    Ph = np.where(hit, P, 0.0)
    return Ph.sum(axis=1), hit.sum(axis=1).astype(np.int64)
