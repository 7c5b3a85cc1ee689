"""Top-k nearest-neighbor matrix profile.

For every subsequence, the k nearest non-trivial neighbors (sorted by
distance), not just the single best — the k-NN generalization common in
the matrix-profile ecosystem (the reference computes k=1 only).

Rides the same MXU job decomposition: per job, ``lax.top_k`` over the
correlation block's rows/columns; partial top-k windows merge across
jobs by concat + re-top_k.  No deduplication is needed anywhere: within
a row, different jobs cover disjoint columns; and at the final merge the
row side holds neighbors at later indices (c > r) while the column side
holds earlier ones (c < r) — disjoint by construction.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import (
    AGGREGATE_INIT,
    INDEX_INIT,
    canonical_dtype,
    needs_x64,
    x64_scope,
)
from mpx.ops.precompute import precompute_statistics
from mpx.types import Stats


def _topk_desc(values, indices, k):
    """Top-k by value (descending correlation); returns (vals, idxs)."""
    v, pos = jax.lax.top_k(values, k)
    return v, jnp.take_along_axis(indices, pos, axis=-1)


def _merge_topk(gv, gi, wv, wi, offset, S, k):
    """Merge a job's (S, k) top-k window into the global (L, k) arrays."""
    zero = np.int32(0)
    cur_v = jax.lax.dynamic_slice(gv, (offset, zero), (S, k))
    cur_i = jax.lax.dynamic_slice(gi, (offset, zero), (S, k))
    cat_v = jnp.concatenate([cur_v, wv], axis=1)
    cat_i = jnp.concatenate([cur_i, wi], axis=1)
    mv, mi = _topk_desc(cat_v, cat_i, k)
    gv = jax.lax.dynamic_update_slice(gv, mv, (offset, zero))
    gi = jax.lax.dynamic_update_slice(gi, mi, (offset, zero))
    return gv, gi


def _job_topk(stats: Stats, r0, k0, *, S, W, m, w, excl, k, dt):
    from mpx.kernels.mxu import _windows

    init_v = jnp.asarray(AGGREGATE_INIT, dt)
    c0 = r0 + k0
    inv_r = jax.lax.dynamic_slice(stats.inv, (r0,), (S,))
    inv_c = jax.lax.dynamic_slice(stats.inv, (c0,), (W,))
    fin_r = jnp.isfinite(inv_r)
    fin_c = jnp.isfinite(inv_c)
    if stats.windows is not None:
        zero = np.int32(0)
        Ur = jax.lax.dynamic_slice(stats.windows, (r0, zero), (S, m))
        Uc = jax.lax.dynamic_slice(stats.windows, (c0, zero), (W, m))
    else:
        Tr = jax.lax.dynamic_slice(stats.T, (r0,), (S + m - 1,))
        Tc = jax.lax.dynamic_slice(stats.T, (c0,), (W + m - 1,))
        mu_r = jax.lax.dynamic_slice(stats.mu, (r0,), (S,))
        mu_c = jax.lax.dynamic_slice(stats.mu, (c0,), (W,))
        Ur = _windows(Tr, mu_r, jnp.where(fin_r, inv_r, 0), S, m)
        Uc = _windows(Tc, mu_c, jnp.where(fin_c, inv_c, 0), W, m)

    P = jax.lax.dot_general(
        Ur, Uc, (((1,), (1,)), ((), ())),
        preferred_element_type=dt,
        precision=jax.lax.Precision.HIGHEST,
    )
    rows = r0 + jnp.arange(S, dtype=jnp.int32)[:, None]
    cols = c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = (
        (cols - rows >= excl)
        & (rows <= w - 1)
        & (cols <= w - 1)
        & fin_r[:, None]
        & fin_c[None, :]
    )
    Pm = jnp.where(valid, P, init_v)

    colmat = jnp.broadcast_to(cols, (S, W))
    rowmat = jnp.broadcast_to(rows, (S, W))
    rv, ri = _topk_desc(Pm, colmat, k)            # (S, k)
    cv, ci = _topk_desc(Pm.T, rowmat.T, k)        # (W, k)
    return rv, ri, cv, ci


@partial(
    jax.jit,
    static_argnames=("S", "W", "m", "w", "excl", "k", "dtype", "corr"),
)
def _run_topk_jobs(stats, r0s, k0s, *, S, W, m, w, excl, k, dtype,
                   corr=False):
    dt = canonical_dtype(dtype)
    L = w + S + W
    rows_v = jnp.full((L, k), AGGREGATE_INIT, dt)
    rows_i = jnp.full((L, k), INDEX_INIT, jnp.int32)
    cols_v = jnp.full((L, k), AGGREGATE_INIT, dt)
    cols_i = jnp.full((L, k), INDEX_INIT, jnp.int32)

    def body(carry, job):
        rows_v, rows_i, cols_v, cols_i = carry
        r0, k0 = job
        rv, ri, cv, ci = _job_topk(
            stats, r0, k0, S=S, W=W, m=m, w=w, excl=excl, k=k, dt=dt
        )
        rows_v, rows_i = _merge_topk(rows_v, rows_i, rv, ri, r0, S, k)
        cols_v, cols_i = _merge_topk(cols_v, cols_i, cv, ci, r0 + k0, W, k)
        return (rows_v, rows_i, cols_v, cols_i), None

    (rows_v, rows_i, cols_v, cols_i), _ = jax.lax.scan(
        body, (rows_v, rows_i, cols_v, cols_i), (r0s, k0s)
    )
    # Final merge: row side (later neighbors) + column side (earlier
    # neighbors) are disjoint candidate sets per subsequence.
    cat_v = jnp.concatenate([rows_v[:w], cols_v[:w]], axis=1)
    cat_i = jnp.concatenate([rows_i[:w], cols_i[:w]], axis=1)
    v, i = _topk_desc(cat_v, cat_i, k)
    if corr:
        # Correlation-space output (the hybrid f64 tier derives its
        # suspect threshold from the k-th value; converting through
        # sqrt and back would cost rounding slack).
        return v, i
    d = jnp.sqrt(jnp.maximum(2.0 * m * (1.0 - v), 0.0))
    d = jnp.where(i >= 0, d, jnp.inf)
    return d, i


def _job_topk_ab(stats_a, stats_b, r0, c0, geom, k, dt):
    """Row-side top-k of one AB rectangle tile (A rows, B columns)."""
    from mpx.kernels.mxu import _job_correlations

    init_v = jnp.asarray(AGGREGATE_INIT, dt)
    P, valid, _, cols = _job_correlations(
        stats_a, r0, c0, geom, dt, stats_c=stats_b, two_sided=True)
    Pm = jnp.where(valid, P, init_v)
    colmat = jnp.broadcast_to(cols, Pm.shape)
    return _topk_desc(Pm, colmat, k)


@partial(
    jax.jit,
    static_argnames=("S", "W", "m", "wa", "wb", "k", "dtype", "tr", "tc"),
)
def _run_topk_ab_jobs(stats_a, stats_b, r0s, c0s, *, S, W, m, wa, wb, k,
                      dtype, tr=8, tc=2048):
    from mpx.kernels import band_geometry

    dt = canonical_dtype(dtype)
    geom = band_geometry(S, W, m, wa, tr, tc, wc=wb, excl=0)
    L = wa + S
    rows_v = jnp.full((L, k), AGGREGATE_INIT, dt)
    rows_i = jnp.full((L, k), INDEX_INIT, jnp.int32)

    def body(carry, job):
        rows_v, rows_i = carry
        r0, c0 = job
        rv, ri = _job_topk_ab(stats_a, stats_b, r0, c0, geom, k, dt)
        rows_v, rows_i = _merge_topk(rows_v, rows_i, rv, ri, r0, S, k)
        return (rows_v, rows_i), None

    (rows_v, rows_i), _ = jax.lax.scan(body, (rows_v, rows_i), (r0s, c0s))
    v, i = rows_v[:wa], rows_i[:wa]
    d = jnp.sqrt(jnp.maximum(2.0 * m * (1.0 - v), 0.0))
    d = jnp.where(i >= 0, d, jnp.inf)
    return d, i


def compute_topk_ab(
    A,
    B,
    m: Optional[int] = None,
    k: int = 4,
    config: Optional[MatrixProfileConfig] = None,
):
    """k-NN AB-join: for each window of ``A``, its ``k`` nearest
    neighbors in ``B`` — (distances (wa, k), indices (wa, k)), rows
    ascending by distance; missing neighbors are (inf, -1).  No
    exclusion zone (the series are distinct), matching the AB 1-NN
    tier.  float64 routes through the strict emulated device path (the
    hybrid's capture machinery is self-join-shaped); one scan, no
    dispatch grouping — same envelope as the self-join k-NN tier."""
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if k < 1:
        raise ValueError("k must be >= 1")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the AB k-NN tier has one kernel (windows "
                         "matmul); use kernel='auto'")
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
    if k > W:
        raise ValueError(f"k={k} exceeds the job extent chunk={W}")
    dt = canonical_dtype(config.dtype)

    rr, cc = np.meshgrid(np.arange(0, wa, S, dtype=np.int32),
                         np.arange(0, wb, W, dtype=np.int32))
    r0s, c0s = rr.ravel(), cc.ravel()

    with x64_scope(needs_x64(dt)):
        stats_a = precompute_statistics(A, m, band=S, chunk=W, dtype=dt,
                                        matmul_only=True)
        stats_b = precompute_statistics(B, m, band=S, chunk=W, dtype=dt,
                                        matmul_only=True)
        D, I = _run_topk_ab_jobs(
            stats_a, stats_b, jnp.asarray(r0s), jnp.asarray(c0s),
            S=S, W=W, m=m, wa=wa, wb=wb, k=k, dtype=str(dt),
            tr=config.tile_rows, tc=config.tile_cols,
        )
        jax.block_until_ready((D, I))
    return D, I


def brute_force_topk_ab(A, B, m: int, k: int):
    """O(wa * wb * m) numpy oracle: per-A-window k best B neighbors."""
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
    P = np.where(valid, P, -np.inf)
    kk = min(k, wb)
    order = np.argsort(-P, axis=1)[:, :kk]
    vals = np.take_along_axis(P, order, axis=1)
    D = np.sqrt(np.maximum(2.0 * m * (1.0 - vals), 0.0))
    I = np.where(np.isfinite(vals), order, -1)
    D = np.where(np.isfinite(vals), D, np.inf)
    if kk < k:
        D = np.pad(D, ((0, 0), (0, k - kk)), constant_values=np.inf)
        I = np.pad(I, ((0, 0), (0, k - kk)), constant_values=-1)
    return D, I


def compute_topk_profile(
    T,
    m: Optional[int] = None,
    k: int = 4,
    config: Optional[MatrixProfileConfig] = None,
):
    """k-NN matrix profile: (distances (w, k), indices (w, k)), each row
    sorted by ascending distance; missing neighbors are (inf, -1)."""
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if k < 1:
        raise ValueError("k must be >= 1")

    T = np.asarray(T) if not isinstance(T, jax.Array) else T
    n = T.shape[0]
    config.validate_series(n, T)
    if config.input_quant is not None:
        # ap_fixed input tier (see mpx/io/apfixed.py).
        from mpx.io.apfixed import quantize

        T = quantize(np.asarray(T), config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    if k > min(S, W):
        raise ValueError(f"k={k} exceeds the job extent min(band, chunk)")
    dt = canonical_dtype(config.dtype)

    # Double precision routes to the hybrid tier (f32 MXU sweeps + exact
    # host-f64 rescoring with per-row threshold descent) for the capture
    # width it supports; kernel='mxu'/'xla' forces the strict emulated
    # device path (also required for k > 8).
    if (
        dt == np.dtype(np.float64)
        and config.kernel in ("auto", "hybrid")
        and k <= 8
    ):
        from mpx.hybrid import compute_topk_profile_f64_hybrid

        return compute_topk_profile_f64_hybrid(T, k, config)

    stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt)
    grid = make_job_grid(w, S, W)

    with x64_scope(needs_x64(dt)):
        D, I = _run_topk_jobs(
            stats,
            jnp.asarray(grid.r0),
            jnp.asarray(grid.k0),
            S=S,
            W=W,
            m=m,
            w=w,
            excl=m // 4,
            k=k,
            dtype=str(dt),
        )
        jax.block_until_ready((D, I))
    return D, I
