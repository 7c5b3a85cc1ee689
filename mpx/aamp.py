"""Non-normalized (raw Euclidean) matrix profiles — the AAMP variant.

Beyond reference parity: the reference (and mpx's default tiers) use
z-normalized distances; for signals where amplitude/offset matter (e.g.
already-detrended or physical-unit data) the community's standard
alternative is the raw Euclidean profile (AAMP).

Device-first: with raw windows ``W_r`` and squared norms ``ssq``,

    D^2(r, c) = ssq_r + ssq_c - 2 * (W_r . W_c)

so an (S x W) tile is still ONE MXU matmul of raw window panels.  The
min-distance reduction folds into the existing max-merge machinery by
carrying per-row aggregates ``A_row(r) = max_c (2 dot - ssq_c)`` (then
``D^2 = ssq_r - A_row``) and symmetrically per column — same carried
(L,) arrays, same iota-min tie rule, one lax.scan over the job grid.

No variance in sight: constant windows are perfectly valid here (their
raw distance is well-defined), so there is no degenerate-window masking
— only bounds and the trivial-match exclusion zone.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import canonical_dtype, needs_x64, x64_scope
from mpx.kernels.mxu import _PRECISION

_BIG_I = np.int32(2**30)


def _window_ssq(T64: np.ndarray, m: int) -> np.ndarray:
    """Centered-free squared window norms, float64 (two-pass blocked)."""
    w = T64.shape[0] - m + 1
    wins = np.lib.stride_tricks.sliding_window_view(T64, m)
    out = np.empty(w, np.float64)
    blk = 1 << 16
    for o in range(0, w, blk):
        v = wins[o : o + blk]
        out[o : o + blk] = np.einsum("ij,ij->i", v, v)
    return out


def _raw_panel(Tp, o, count: int, m: int):
    Tseg = jax.lax.dynamic_slice(Tp, (o,), (count + m - 1,))
    return jnp.stack([Tseg[j : j + count] for j in range(m)], axis=1)


@partial(jax.jit, static_argnames=("S", "W", "m", "w", "excl", "dt"))
def _run_aamp_jobs(Tp, ssq, r0s, k0s, *,
                   S: int, W: int, m: int, w: int, excl: int, dt):
    from mpx.ops.aggregates import (
        init_aggregates,
        merge_aggregates,
        merge_window,
    )
    from mpx.types import Aggregates

    dtype = jnp.dtype(dt)
    L = w + S + W
    # The aggregate floor must be -inf: raw-space values 2*dot - ssq_c
    # are unbounded below (unlike correlations in [-1, 1]), so the
    # z-norm tiers' -1e12 sentinel would clobber valid large-amplitude
    # pairs.  merge_window's strict-> rule keeps dummy jobs inert.
    init = -jnp.inf
    rows_g = init_aggregates(L, dtype, init)
    cols_g = init_aggregates(L, dtype, init)

    def body(carry, job):
        rows_g, cols_g = carry
        r0, k0 = job
        c0 = r0 + k0
        Wr = _raw_panel(Tp, r0, S, m)
        Wc = _raw_panel(Tp, c0, W, m)
        sr = jax.lax.dynamic_slice(ssq, (r0,), (S,))
        sc = jax.lax.dynamic_slice(ssq, (c0,), (W,))
        dot = jax.lax.dot_general(
            Wr, Wc, (((1,), (1,)), ((), ())),
            preferred_element_type=dtype, precision=_PRECISION,
        )
        rows = r0 + jnp.arange(S, dtype=jnp.int32)[:, None]
        cols = c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = (cols - rows >= excl) & (rows <= w - 1) & (cols <= w - 1)

        # row side: A(r) = max_c (2 dot - ssq_c)  ->  D^2 = ssq_r - A
        Mr = jnp.where(valid, 2.0 * dot - sc[None, :], -jnp.inf)
        row_v = jnp.max(Mr, axis=1)
        ri = jnp.min(jnp.where(Mr == row_v[:, None], cols, _BIG_I), axis=1)
        row_i = jnp.where(jnp.isfinite(row_v), ri.astype(jnp.int32),
                          jnp.int32(-1))
        # column side: A(c) = max_r (2 dot - ssq_r)
        Mc = jnp.where(valid, 2.0 * dot - sr[:, None], -jnp.inf)
        col_v = jnp.max(Mc, axis=0)
        ci = jnp.min(jnp.where(Mc == col_v[None, :], rows, _BIG_I), axis=0)
        col_i = jnp.where(jnp.isfinite(col_v), ci.astype(jnp.int32),
                          jnp.int32(-1))

        rows_g = merge_window(rows_g, Aggregates(row_v, row_i), r0)
        cols_g = merge_window(cols_g, Aggregates(col_v, col_i), c0)
        return (rows_g, cols_g), None

    (rows_g, cols_g), _ = jax.lax.scan(body, (rows_g, cols_g), (r0s, k0s))

    # final row/col merge and distance conversion, all on device
    merged = merge_aggregates(
        Aggregates(rows_g.value[:w], rows_g.index[:w]),
        Aggregates(cols_g.value[:w], cols_g.index[:w]),
    )
    D2 = jnp.where(jnp.isfinite(merged.value),
                   ssq[:w] - merged.value, jnp.inf)
    return jnp.sqrt(jnp.maximum(D2, 0.0)), merged.index.astype(jnp.int32)


@partial(jax.jit, static_argnames=("S", "W", "m", "wa", "wb", "dt"))
def _run_aamp_ab_jobs(TpA, ssqA, TpB, ssqB, r0s, c0s, *,
                      S: int, W: int, m: int, wa: int, wb: int, dt):
    """Raw-Euclidean AB-join sweep: one (S x W) raw-windows matmul per
    (r0, c0) job, min-distance folded into the max-merge machinery like
    the self-join above (A_row(r) = max_c (2 dot - ssq_c)); no exclusion
    zone (cross-series pairs are never trivial matches)."""
    from mpx.ops.aggregates import init_aggregates, merge_window
    from mpx.types import Aggregates

    dtype = jnp.dtype(dt)
    rows_g = init_aggregates(wa + S, dtype, -jnp.inf)
    cols_g = init_aggregates(wb + W, dtype, -jnp.inf)

    def body(carry, job):
        rows_g, cols_g = carry
        r0, c0 = job
        Wr = _raw_panel(TpA, r0, S, m)
        Wc = _raw_panel(TpB, c0, W, m)
        sr = jax.lax.dynamic_slice(ssqA, (r0,), (S,))
        sc = jax.lax.dynamic_slice(ssqB, (c0,), (W,))
        dot = jax.lax.dot_general(
            Wr, Wc, (((1,), (1,)), ((), ())),
            preferred_element_type=dtype, precision=_PRECISION,
        )
        rows = r0 + jnp.arange(S, dtype=jnp.int32)[:, None]
        cols = c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = (rows <= wa - 1) & (cols <= wb - 1)

        Mr = jnp.where(valid, 2.0 * dot - sc[None, :], -jnp.inf)
        row_v = jnp.max(Mr, axis=1)
        ri = jnp.min(jnp.where(Mr == row_v[:, None], cols, _BIG_I), axis=1)
        row_i = jnp.where(jnp.isfinite(row_v), ri.astype(jnp.int32),
                          jnp.int32(-1))
        Mc = jnp.where(valid, 2.0 * dot - sr[:, None], -jnp.inf)
        col_v = jnp.max(Mc, axis=0)
        ci = jnp.min(jnp.where(Mc == col_v[None, :], rows, _BIG_I), axis=0)
        col_i = jnp.where(jnp.isfinite(col_v), ci.astype(jnp.int32),
                          jnp.int32(-1))

        rows_g = merge_window(rows_g, Aggregates(row_v, row_i), r0)
        cols_g = merge_window(cols_g, Aggregates(col_v, col_i), c0)
        return (rows_g, cols_g), None

    (rows_g, cols_g), _ = jax.lax.scan(body, (rows_g, cols_g), (r0s, c0s))

    def fin(agg, ssq, w):
        D2 = jnp.where(jnp.isfinite(agg.value[:w]),
                       ssq[:w] - agg.value[:w], jnp.inf)
        return jnp.sqrt(jnp.maximum(D2, 0.0)), agg.index[:w]

    Da, Ia = fin(rows_g, ssqA, wa)
    Db, Ib = fin(cols_g, ssqB, wb)
    return Da, Ia, Db, Ib


def compute_aamp_ab_join(
    A,
    B,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
):
    """Raw-Euclidean AB-join: both directional profiles of A vs B
    without z-normalization (the AAMP counterpart of
    :func:`mpx.abjoin.compute_ab_join`; STUMPY's ``aampdist`` consumes
    exactly these two profiles).

    Returns an :class:`mpx.abjoin.ABJoinResult` (mp_a, mpi_a, mp_b,
    mpi_b) as numpy arrays — ``mp_a[i]`` is the smallest raw distance
    from A window i to ANY B window (no exclusion zone)."""
    from mpx.abjoin import ABJoinResult

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the raw-distance (AAMP) tier has one kernel "
                         "(raw-windows matmul); use kernel='auto'")
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    config.validate_series(A64.shape[0], A64)
    config.validate_series(B64.shape[0], B64)
    wa = A64.shape[0] - m + 1
    wb = B64.shape[0] - m + 1
    config = config.shrink_to(max(wa, wb))
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)

    # Raw distance uses a - b, so a shift COMMON to both series cancels:
    # center by the joint mean before the compute-dtype cast (same
    # conditioning rationale as the self-join above).
    g = np.concatenate([A64, B64]).mean()
    A64 = A64 - g
    B64 = B64 - g

    def stage(T64, w, count):
        pw = -(-w // count) * count
        ssq = np.zeros(pw, dt)
        ssq[:w] = _window_ssq(T64, m).astype(dt)
        Tp = np.zeros(pw + m - 1, dt)
        Tp[: T64.shape[0]] = T64.astype(dt)
        return jnp.asarray(Tp), jnp.asarray(ssq)

    r0s, c0s = np.meshgrid(np.arange(0, wa, S, dtype=np.int32),
                           np.arange(0, wb, W, dtype=np.int32),
                           indexing="ij")
    with x64_scope(needs_x64(dt)):
        TpA, ssqA = stage(A64, wa, S)
        TpB, ssqB = stage(B64, wb, W)
        Da, Ia, Db, Ib = _run_aamp_ab_jobs(
            TpA, ssqA, TpB, ssqB,
            jnp.asarray(r0s.ravel()), jnp.asarray(c0s.ravel()),
            S=S, W=W, m=m, wa=wa, wb=wb, dt=str(dt),
        )
        return ABJoinResult(
            mp_a=np.asarray(Da), mpi_a=np.asarray(Ia),
            mp_b=np.asarray(Db), mpi_b=np.asarray(Ib),
        )


def aamp_mpdist(A, B, m: int, *, threshold: float = 0.05,
                config: Optional[MatrixProfileConfig] = None) -> float:
    """Raw-Euclidean MPdist (STUMPY's ``aampdist``): the k-th smallest
    value of the concatenated raw ABBA profiles, k = ceil(threshold *
    (len(A) + len(B)))."""
    from mpx.analysis import mpdist_from_profiles

    res = compute_aamp_ab_join(A, B, m, config=config)
    return mpdist_from_profiles(
        res.mp_a, res.mp_b,
        np.asarray(A).shape[0], np.asarray(B).shape[0],
        threshold=threshold,
    )


def compute_aamp_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
):
    """Raw-Euclidean (non-normalized) self-join profile of ``T``.

    Returns (D, I): ``D[i]`` = the smallest raw Euclidean distance from
    window i to any window outside the exclusion zone, ``I[i]`` its
    index.  Same job schedule/config knobs as the z-normalized driver.
    """
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the raw-distance (AAMP) tier is single-device; "
                         "drop num_shards")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the raw-distance (AAMP) tier has one kernel "
                         "(raw-windows matmul); use kernel='auto'")
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

    from mpx.ops.precompute import _padded_width

    pw = _padded_width(w, S, W)
    # Raw Euclidean distance is invariant under a global constant shift
    # (both windows move together), so center the series in f64 BEFORE
    # the compute-dtype cast: products become O(local deviation) instead
    # of O(m * amplitude^2) and the f32 tier stays conditioned on long
    # drifting series (same hazard class as kernels/common.py:seed_qt).
    T64 = np.asarray(T, np.float64)
    T64 = T64 - T64.mean()
    ssq = np.zeros(pw, dt)
    ssq[:w] = _window_ssq(T64, m).astype(dt)
    Tp = np.zeros(pw + m - 1, dt)
    Tp[:n] = T64.astype(dt)

    grid = make_job_grid(w, S, W)
    with x64_scope(needs_x64(dt)):
        D, I = _run_aamp_jobs(
            jnp.asarray(Tp), jnp.asarray(ssq),
            jnp.asarray(grid.r0), jnp.asarray(grid.k0),
            S=S, W=W, m=m, w=w, excl=m // 4, dt=str(dt),
        )
        return np.asarray(D), np.asarray(I)
