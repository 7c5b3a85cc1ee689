"""Pooled distance-matrix summaries (SCAMP matrix-summaries analog).

Beyond reference parity (the reference emits only the 1-NN profile —
host/MatrixProfileHost.cpp:54-160), the wider SCAMP family can reduce
the full (w x w) pairwise matrix to an (mheight x mwidth) summary whose
cell holds the MAXIMUM Pearson correlation (equivalently the minimum
z-normalized distance) over all subsequence pairs that pool into it —
the standard way to *visualize* the whole join as a heatmap at any n.

The (S x S) correlation tile is the SAME unit-window matmul every other
tier uses (kernels/mxu._job_correlations); only the epilogue changes.
Pooling exploits that global pool indices are sorted along each tile
axis, so it never needs segment_max/scatter:

* ``pool < S``  — shift-buffer reshape: the tile is placed at offset
  ``o % pool`` inside a ``K*pool``-long buffer and max-reduced by a
  plain reshape (pool boundaries become static);
* ``pool >= S`` — the tile spans at most two pooled cells; two masked
  max passes split at the single crossing.

Each upper-triangle tile contributes twice (forward and transposed), so
one sweep fills the full symmetric matrix; AB-joins sweep the full
rectangle grid once.  Merges are idempotent maxima — jobs group into
watchdog-safe dispatches exactly like the 1-NN driver.

Masking matches kernels/common.py: exclusion zone |c - r| >= m // 4
(self-joins), series bounds, and zero-variance windows never match.
Cells whose every pair is masked read as correlation -1.0 (distance
``sqrt(4m)``) — the "nothing here" floor, documented rather than NaN so
heatmaps stay finite.  Compute is float32 on the MXU at the module
default precision; a pooled max of f32 correlations is a visualization
summary, so there is no f64 tier here.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid, pad_jobs
from mpx.kernels import band_geometry
from mpx.kernels.mxu import _job_correlations

# Neutral element for the pooled max: strictly below any genuine
# correlation (>= -1), so empty cells are detectable and clamp to -1.
_NEUTRAL = -2.0


def _pool_rows(X, o, pool: int, K: int):
    """Max-pool axis 0 of ``X`` (S, C) by ``pool`` at global offset ``o``.

    Global pool ids (o + i) // pool are sorted in i, so the result is a
    contiguous (K, C) block starting at pooled row ``o // pool``.  K is
    the static span bound (S - 1) // pool + 2."""
    S = X.shape[0]
    if pool == 1:
        # identity pooling; pad to the static K = S + 1 span
        return jnp.pad(X, ((0, K - S), (0, 0)), constant_values=_NEUTRAL)
    sh = o % pool
    if pool >= S:
        # the tile crosses at most one pool boundary: split at it
        i = jnp.arange(S)[:, None]
        first = i < (pool - sh)
        m0 = jnp.max(jnp.where(first, X, _NEUTRAL), axis=0)
        m1 = jnp.max(jnp.where(first, _NEUTRAL, X), axis=0)
        out = jnp.stack([m0, m1], axis=0)
        return jnp.pad(out, ((0, K - 2), (0, 0)), constant_values=_NEUTRAL)
    buf = jnp.full((K * pool, X.shape[1]), _NEUTRAL, X.dtype)
    buf = jax.lax.dynamic_update_slice(buf, X, (sh, 0))
    return buf.reshape(K, pool, X.shape[1]).max(axis=1)


def _span(S: int, pool: int) -> int:
    """Static bound on distinct pooled cells a length-S tile can touch."""
    return S + 1 if pool == 1 else (S - 1) // pool + 2


def _pool_tile(X, ro, co, ph: int, pw: int, Kr: int, Kc: int):
    """Max-pool a (S, S) tile into its (Kr, Kc) pooled block."""
    Xc = _pool_rows(X.T, co, pw, Kc)      # (Kc, S): columns pooled
    return _pool_rows(Xc.T, ro, ph, Kr)   # (Kr, Kc)


def _place_max(out, pooled, pr0, pc0):
    """max-merge a pooled block into the padded carry at (pr0, pc0)."""
    placed = jnp.full(out.shape, _NEUTRAL, out.dtype)
    placed = jax.lax.dynamic_update_slice(placed, pooled, (pr0, pc0))
    return jnp.maximum(out, placed)


@partial(jax.jit, static_argnames=(
    "S", "m", "w", "wc", "ph", "pw", "excl", "mirror", "tr", "tc"))
def _run_matrix_jobs(stats, stats_c, r0s, c0s, out0, *,
                     S: int, m: int, w: int, wc: int, ph: int, pw: int,
                     excl: int, mirror: bool, tr: int = 8, tc: int = 2048):
    """One dispatch: scan a job group, max-merging pooled blocks into the
    carried padded output.  ``mirror=True`` (self-joins) also merges the
    transposed tile so one upper-triangle sweep fills the full matrix."""
    geom = band_geometry(S, S, m, w, tr, tc, wc=wc, excl=excl)
    Kr, Kc = _span(S, ph), _span(S, pw)

    def body(out, job):
        r0, c0 = job
        P, valid, _, _ = _job_correlations(
            stats, r0, c0, geom, jnp.float32,
            stats_c=stats_c, two_sided=True)
        X = jnp.where(valid, P, jnp.asarray(_NEUTRAL, P.dtype))
        out = _place_max(out, _pool_tile(X, r0, c0, ph, pw, Kr, Kc),
                         r0 // ph, c0 // pw)
        if mirror:
            out = _place_max(out, _pool_tile(X.T, c0, r0, ph, pw, Kr, Kc),
                             c0 // ph, r0 // pw)
        return out, None

    out, _ = jax.lax.scan(body, out0, (r0s, c0s))
    return out


def pooled_matrix(
    A,
    m: Optional[int] = None,
    *,
    mwidth: int = 50,
    mheight: int = 50,
    B=None,
    pearson: bool = False,
    config: Optional[MatrixProfileConfig] = None,
) -> np.ndarray:
    """(mheight, mwidth) pooled summary of the self-join of ``A`` (or the
    AB-join rows-from-A x cols-from-B when ``B`` is given).

    Cell [i, j] covers subsequence rows ``i*ceil(w/mheight) ...`` and
    columns ``j*ceil(wc/mwidth) ...`` and holds the maximum Pearson
    correlation over its valid pairs (``pearson=True``) or the matching
    minimum z-normalized distance ``sqrt(2m(1 - p))`` (default).  Cells
    with no valid pair read -1.0 / ``sqrt(4m)``."""
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if mwidth < 1 or mheight < 1:
        raise ValueError("mwidth/mheight must be >= 1")
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the matrix-summary tier is single-device; "
                         "drop num_shards")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the matrix-summary tier has one kernel "
                         "(windows matmul); use kernel='auto'")

    A = np.asarray(A)
    config.validate_series(A.shape[0], A)
    if config.input_quant is not None:
        from mpx.io.apfixed import quantize

        A = quantize(np.asarray(A, np.float64), config.input_quant)
        if B is not None:
            B = quantize(np.asarray(B, np.float64), config.input_quant)
    w = A.shape[0] - m + 1
    if B is not None:
        B = np.asarray(B)
        config.validate_series(B.shape[0], B)
        wc = B.shape[0] - m + 1
    else:
        wc = w

    config = config.shrink_to(max(w, wc))
    S = min(config.band, config.chunk)
    ph = -(-w // mheight)
    pw = -(-wc // mwidth)

    from mpx.ops.precompute import precompute_statistics

    if B is None:
        grid = make_job_grid(w, S, S)
        r0s = grid.r0
        c0s = (grid.r0 + grid.k0).astype(np.int32)
        excl, mirror = m // 4, True
    else:
        rr, cc = np.meshgrid(np.arange(0, w, S, dtype=np.int32),
                             np.arange(0, wc, S, dtype=np.int32))
        r0s, c0s = rr.ravel(), cc.ravel()
        excl, mirror = 0, False

    group = config.dispatch_group
    njobs = r0s.shape[0]
    if not group or group >= njobs:
        group = njobs
    # dummy jobs with out-of-range rows mask to all-neutral tiles
    r0s, c0s = pad_jobs(r0s, c0s, group, dummy_r0=w)

    stats = precompute_statistics(A, m, band=S, chunk=S,
                                  dtype=jnp.float32, matmul_only=True)
    stats_c = None
    if B is not None:
        stats_c = precompute_statistics(B, m, band=S, chunk=S,
                                        dtype=jnp.float32, matmul_only=True)

    Kr, Kc = _span(S, ph), _span(S, pw)
    out = jnp.full((mheight + Kr, mwidth + Kc), _NEUTRAL, jnp.float32)
    for off in range(0, r0s.shape[0], group):
        out = _run_matrix_jobs(
            stats, stats_c,
            jnp.asarray(r0s[off : off + group]),
            jnp.asarray(c0s[off : off + group]),
            out,
            S=S, m=m, w=w, wc=wc, ph=ph, pw=pw, excl=excl, mirror=mirror,
            tr=config.tile_rows, tc=config.tile_cols,
        )
    corr = np.asarray(out)[:mheight, :mwidth].astype(np.float64)
    corr = np.clip(corr, -1.0, 1.0)  # empty cells clamp to the -1 floor
    if pearson:
        return corr
    return np.sqrt(np.maximum(2.0 * m * (1.0 - corr), 0.0))


def brute_force_pooled_matrix(A, m: int, *, mwidth: int = 50,
                              mheight: int = 50, B=None,
                              pearson: bool = False) -> np.ndarray:
    """O(w * wc * m) numpy oracle for tests: exact pooled maxima from the
    dense pairwise correlation matrix."""
    A = np.asarray(A, np.float64)
    from mpx.ops.precompute import precompute_statistics_numpy

    sa = precompute_statistics_numpy(A, m)
    w = A.shape[0] - m + 1
    Ua = np.stack([A[i : i + m] for i in range(w)])
    Ua = (Ua - sa["mu"][:, None]) * np.where(
        np.isfinite(sa["inv"]), sa["inv"], 0.0)[:, None]
    fin_a = np.isfinite(sa["inv"])
    if B is None:
        Ub, fin_b, wc, excl = Ua, fin_a, w, m // 4
    else:
        B = np.asarray(B, np.float64)
        sb = precompute_statistics_numpy(B, m)
        wc = B.shape[0] - m + 1
        Ub = np.stack([B[i : i + m] for i in range(wc)])
        Ub = (Ub - sb["mu"][:, None]) * np.where(
            np.isfinite(sb["inv"]), sb["inv"], 0.0)[:, None]
        fin_b = np.isfinite(sb["inv"])
        excl = 0
    P = Ua @ Ub.T
    r = np.arange(w)[:, None]
    c = np.arange(wc)[None, :]
    valid = (np.abs(c - r) >= excl) & fin_a[:, None] & fin_b[None, :]
    P = np.where(valid, P, _NEUTRAL)
    ph = -(-w // mheight)
    pw = -(-wc // mwidth)
    out = np.full((mheight, mwidth), _NEUTRAL)
    for i in range(w):
        pi = i // ph
        seg = P[i]
        for j in range(mwidth):
            blk = seg[j * pw : (j + 1) * pw]
            if blk.size:
                out[pi, j] = max(out[pi, j], blk.max())
    out = np.clip(out, -1.0, 1.0)
    if pearson:
        return out
    return np.sqrt(np.maximum(2.0 * m * (1.0 - out), 0.0))
