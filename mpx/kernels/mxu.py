"""Matmul band sweep (kernel "mxu"): the correlation block as a windows matmul.

The Pearson correlation of two z-normalized subsequences is a dot
product: with ``u_i = (T[i:i+m] - mu_i) * inv_i`` (unit-normalized
windows), ``P(r, c) = u_r . u_c``.  A whole (S x W) tile of the join is
therefore ONE matmul ``U_r @ U_c^T`` (a library GEMM: cuBLAS on the GPU,
BLAS on the CPU).  Compared to the SCAMP O(1) diagonal recurrence this
does ``2m`` FLOPs per pair instead of ~10, but a GEMM runs far closer to
the device's peak than an elementwise recurrence (the recurrence kernel
remains for very large m and for the protocol analogy with the HLS
design).

No recurrence also means no seeding, better numerics (errors are
~sqrt(m) ulps of an O(1) result — no QT drift over rows), and pure-XLA
portability (any backend, f32/f64).

Same job contract as the other backends (BandOut), except the job is the
*rectangle* rows [r0, r0+S) x columns [c0, c0+W) rather than a diagonal
rhombus, so the column output covers (W,) at offset c0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mpx.dtypes import AGGREGATE_INIT, INDEX_INIT
from mpx.kernels.common import BandGeometry, BandOut
from mpx.types import Aggregates, Stats

# f32 matmul precision: HIGHEST is true fp32.  On the GPU, DEFAULT and
# HIGH run in TF32 (10 mantissa bits), far outside the distance
# tolerance; tests/test_precision_guard.py enforces this.
_PRECISION = jax.lax.Precision.HIGHEST


def _windows(Tseg: jax.Array, mu, inv, count: int, m: int):
    """Unit-normalized window matrix (count, m) from a series segment of
    length count + m - 1 via m static shifted slices (no gather)."""
    cols = [Tseg[j : j + count] for j in range(m)]
    Wm = jnp.stack(cols, axis=1)
    return (Wm - mu[:, None]) * inv[:, None]


def _panel(stats: Stats, o, count: int, m: int):
    """Unit-normalized window panel (count, m) at offset ``o`` plus the
    finite (non-degenerate) mask."""
    inv = jax.lax.dynamic_slice(stats.inv, (o,), (count,))
    # Zero-variance windows have inv = inf; their operand rows are zeroed
    # (masked by callers) so inf/NaN never enters the matmul.
    fin = jnp.isfinite(inv)
    if stats.windows is not None:
        # Slice the precomputed normalized-windows matrix (saves the
        # per-job window construction; see Stats.windows).
        zero = np.int32(0)  # bare 0 traces as i64 under x64 scope
        U = jax.lax.dynamic_slice(stats.windows, (o, zero), (count, m))
    else:
        Tseg = jax.lax.dynamic_slice(stats.T, (o,), (count + m - 1,))
        mu = jax.lax.dynamic_slice(stats.mu, (o,), (count,))
        U = _windows(Tseg, mu, jnp.where(fin, inv, 0), count, m)
    return U, fin


def _job_correlations(stats: Stats, r0, c0, geom: BandGeometry, dt,
                      stats_c: Stats | None = None, precision=None,
                      rg=0, cg=0, two_sided: bool = False):
    """The shared (S x W) correlation tile: unit-window panels
    matmul -> validity mask.  Returns (P, valid, rows, cols).

    ``stats_c`` selects a different statistics set for the column axis
    (AB-joins: rows from A, columns from B; geom.excl < 0 and geom.wc
    carry the AB semantics).  Default: self-join.  ``precision``
    overrides the module default (the hybrid's opt-in cascade sweeps
    with bf16 operands under a correspondingly wider bound).

    ``rg``/``cg`` are *global* index offsets added on top of the local
    slice offsets ``r0``/``c0`` (sharded-input tiers slice device-local
    statistics blocks but mask and report globally); ``two_sided``
    applies the exclusion zone as ``|c - r| >= excl`` — required by
    rectangle sweeps whose tiles straddle the main diagonal (the ring
    tier's shard-pair blocks), where the upper-triangle convention
    ``c - r >= excl`` does not hold."""
    S, W, m, w, excl = geom.S, geom.W, geom.m, geom.w, geom.excl
    Ur, fin_r = _panel(stats, r0, S, m)
    Uc, fin_c = _panel(stats if stats_c is None else stats_c, c0, W, m)

    P = jax.lax.dot_general(
        Ur,
        Uc,
        (((1,), (1,)), ((), ())),
        preferred_element_type=dt,
        precision=_PRECISION if precision is None else precision,
    )

    rows = rg + r0 + jnp.arange(S, dtype=jnp.int32)[:, None]
    cols = cg + c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
    delta = cols - rows
    zone = jnp.abs(delta) >= excl if two_sided else delta >= excl
    valid = (
        zone
        & (rows <= w - 1)
        & (cols <= geom.wc - 1)
        & fin_r[:, None]
        & fin_c[None, :]
    )
    return P, valid, rows, cols


def sweep_band_mxu(stats: Stats, r0, k0, geom: BandGeometry, dtype,
                   stats_c: Stats | None = None, precision=None,
                   rg=0, cg=0, two_sided: bool = False) -> BandOut:
    S, W = geom.S, geom.W
    dt = jnp.dtype(dtype)
    init_v = jnp.asarray(AGGREGATE_INIT, dt)
    c0 = r0 + k0
    P, valid, rows, cols = _job_correlations(stats, r0, c0, geom, dt,
                                             stats_c, precision,
                                             rg=rg, cg=cg,
                                             two_sided=two_sided)
    Pm = jnp.where(valid, P, init_v)

    # max + first-occurrence index via an iota-min over the tie mask.
    # XLA fuses the mask/eq/where into the reduction reads.  Tie-break =
    # smallest index = argmax's first-occurrence semantics.
    big = np.int32(2**30)
    row_v = jnp.max(Pm, axis=1)
    ri = jnp.min(jnp.where(Pm == row_v[:, None], cols, big), axis=1)
    row_i = jnp.where(row_v > init_v, ri.astype(jnp.int32), jnp.int32(INDEX_INIT))
    col_v = jnp.max(Pm, axis=0)
    ci = jnp.min(jnp.where(Pm == col_v[None, :], rows, big), axis=0)
    col_i = jnp.where(col_v > init_v, ci.astype(jnp.int32), jnp.int32(INDEX_INIT))
    return BandOut(
        row=Aggregates(row_v, row_i),
        col=Aggregates(col_v, col_i),
    )


def sweep_band_max(stats: Stats, r0, k0, geom: BandGeometry, dtype,
                   stats_c: Stats | None = None, precision=None,
                   rg=0, cg=0, two_sided: bool = False):
    """Value-only band sweep: per-row and per-column max correlation,
    no argmax.  Pass A of the hybrid tier needs only the maxima (to set
    the suspect threshold); dropping the two tie-index reductions saves
    HBM epilogue traffic.  Returns ((S,) row maxes, (W,) col maxes)."""
    dt = jnp.dtype(dtype)
    init_v = jnp.asarray(AGGREGATE_INIT, dt)
    c0 = r0 + k0
    P, valid, _, _ = _job_correlations(stats, r0, c0, geom, dt, stats_c,
                                       precision, rg=rg, cg=cg,
                                       two_sided=two_sided)
    Pm = jnp.where(valid, P, init_v)
    return jnp.max(Pm, axis=1), jnp.max(Pm, axis=0)


# Sentinels for suspect-index capture (min-merged / max-merged).
SUSPECT_MIN_INIT = np.int32(2**30)
SUSPECT_MAX_INIT = np.int32(-1)


# Suspect capture width per side: the K smallest and K largest suspect
# indices are kept per subsequence, so any count <= 2K is captured
# completely (measured at the 1M showcase: cnt <= 8 covers 99.96% of
# the >4-suspect rows, cutting the device pass C to a few hundred rows).
SUSPECT_K = 4


class SuspectWindow(NamedTuple):
    """Per-subsequence suspect summary over one job's rows or columns:
    how many valid pairs reach the caller-provided correlation threshold,
    plus the SUSPECT_K smallest (mn, ascending) and SUSPECT_K largest
    (mx, descending) neighbor indices among them.  All fields merge
    associatively across jobs (sum / k-smallest / k-largest), so the
    captured set is exact whenever the global count is <= 2*SUSPECT_K."""

    cnt: jax.Array  # (k,) int32 number of suspects
    mn: jax.Array   # (k, SUSPECT_K) int32 ascending (SUSPECT_MIN_INIT pad)
    mx: jax.Array   # (k, SUSPECT_K) int32 descending (SUSPECT_MAX_INIT pad)


class SuspectOut(NamedTuple):
    row: SuspectWindow  # (S,)  subsequences r0 .. r0+S, suspects among columns
    col: SuspectWindow  # (W,)  subsequences c0 .. c0+W, suspects among rows


def _suspect_reduce(mask, idx, axis) -> SuspectWindow:
    cnt = jnp.sum(mask, axis=axis, dtype=jnp.int32)
    lo = jnp.where(mask, idx, SUSPECT_MIN_INIT)
    hi = jnp.where(mask, idx, SUSPECT_MAX_INIT)
    mns, mxs = [], []
    for _ in range(SUSPECT_K):
        mn_k = jnp.min(lo, axis=axis)
        mx_k = jnp.max(hi, axis=axis)
        mns.append(mn_k)
        mxs.append(mx_k)
        lo = jnp.where(idx == jnp.expand_dims(mn_k, axis), SUSPECT_MIN_INIT, lo)
        hi = jnp.where(idx == jnp.expand_dims(mx_k, axis), SUSPECT_MAX_INIT, hi)
    return SuspectWindow(cnt, jnp.stack(mns, -1), jnp.stack(mxs, -1))


def _dense_merge_cols(idx, win: SuspectWindow, F: int, L: int) -> SuspectWindow:
    """Scatter a gathered (F,) suspect summary back to a dense (L,)
    window (init elsewhere) via a one-hot matmul — exact because slot
    indices are unique and every encoded integer is < 2^24.

    Index fields are shifted by +1 so 0 means "missing": the max-merged
    fields' init is already -1 (-> 0), the min-merged fields' init
    (2^30, not f32-exact) is mapped to 0 explicitly.

    HIGHEST precision is REQUIRED on every index-carrying one-hot
    matmul in this module: a reduced-precision matmul (TF32 keeps 10
    mantissa bits, bf16 8) silently rounds integers past 2^11 (2^9) —
    encoded suspect indices would come back corrupted (once observed
    with bf16 at n=16384: the last band's capture slots quantized to
    multiples of 64)."""
    K = SUSPECT_K
    enc_mn = jnp.where(win.mn == SUSPECT_MIN_INIT, 0, win.mn + 1)
    enc_mx = win.mx + 1  # SUSPECT_MAX_INIT == -1 -> 0
    M = jnp.concatenate(
        [win.cnt[:, None], enc_mn, enc_mx], axis=1
    ).astype(jnp.float32)  # (F, 1 + 2K)
    onehot = (idx[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :])
    D = jax.lax.dot_general(
        onehot.astype(jnp.float32), M, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)  # (L, 1 + 2K)
    mn = D[:, 1 : 1 + K]
    return SuspectWindow(
        cnt=D[:, 0],
        mn=jnp.where(mn > 0, mn - 1, SUSPECT_MIN_INIT),
        mx=D[:, 1 + K :] - 1,
    )


def _flagged_indices(flags, F: int, L: int):
    """Indices of the first F set flags, ascending, padded with L —
    the contract of ``jnp.nonzero(size=F, fill_value=L)``, which lowers
    to a sort.  This cumsum + one-hot matmul formulation avoids it: each
    flagged element knows its output slot (prefix count), so a (L, F)
    slot one-hot contracted with the index iota yields the compacted
    indices exactly (values < 2^24 are f32-exact).  Whether a gather or
    nonzero is cheaper on the GPU is open (ROADMAP)."""
    pos = jnp.cumsum(flags.astype(jnp.int32)) - 1
    pos = jnp.where(flags, pos, -1)
    onehot = pos[:, None] == jnp.arange(F, dtype=jnp.int32)[None, :]
    idx = jax.lax.dot_general(
        jnp.arange(L, dtype=jnp.float32)[None, :],
        onehot.astype(jnp.float32),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST: index-carrying (see _dense_merge_cols)
        precision=jax.lax.Precision.HIGHEST,
    )[0].astype(jnp.int32)
    valid = jnp.arange(F, dtype=jnp.int32) < jnp.sum(flags, dtype=jnp.int32)
    return jnp.where(valid, idx, L)


def _onehot_rows(idx, U, F: int, L: int):
    """Compact rows ``U[idx]`` (idx (F,) int32 in [0, L], L = padded)
    via a one-hot matmul: exact (each output sums one row) at HIGHEST.
    Out-of-range slots yield zeros."""
    onehot = (idx[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :]).astype(
        U.dtype
    )
    return jax.lax.dot_general(
        onehot, U, (((1,), (0,)), ((), ())),
        preferred_element_type=U.dtype,
        # HIGHEST: a TF32 matmul would round the copied panel values
        # (2^-11 relative), blowing the sweep's margin error budget
        precision=jax.lax.Precision.HIGHEST,
    )


def sweep_band_suspects_sparse(
    stats: Stats, r0, k0, jrow: jax.Array, jcol: jax.Array,
    geom: BandGeometry, thr: jax.Array, F: int,
    stats_c: Stats | None = None, thr_col: jax.Array | None = None,
    precision=None, rg=0, cg=0, two_sided: bool = False,
):
    """Sparse pass-B job: re-examine ONLY the rows/columns whose pass-A
    per-job maxima (``jrow`` (S,), ``jcol`` (W,)) reach the suspect
    threshold.  A row below its threshold provably contains no suspect
    in this job (its job maximum already falls short), so the dense
    (S x W) re-sweep collapses to two skinny gathered matmuls of at most
    ``F`` flagged rows / columns.

    ``rg``/``cg``/``two_sided`` carry the sharded-inputs ring tier's
    global coordinates and exclusion-zone shape (see
    sweep_band_suspects_fused); the defaults keep the single-device
    job-grid behavior.

    Returns (dense (S,) row window, dense (W,) col window, overflow) —
    init values everywhere unflagged; ``overflow`` is True when more
    than F rows or columns were flagged (the caller must then re-sweep
    the whole job densely; the sparse windows are still returned but
    carry only the first F slots' captures)."""
    dt = jnp.float32
    S, W, m, w, excl, wc = geom.S, geom.W, geom.m, geom.w, geom.excl, geom.wc
    st_c = stats if stats_c is None else stats_c
    thr_c_arr = thr if thr_col is None else thr_col
    c0 = r0 + k0

    thr_r = jax.lax.dynamic_slice(thr, (r0,), (S,))
    thr_cw = jax.lax.dynamic_slice(thr_c_arr, (c0,), (W,))
    # jrow/jcol are the u16-encoded (round-up) pass-A job maxima; the
    # decoded values upper-bound the f32 truth, so the flag sets are a
    # conservative superset (see mpx.hybrid._encode_max_u16).
    dec = lambda q: q.astype(jnp.float32) * jnp.float32(2.0 / 65535.0) - 1.0
    flags_r = dec(jrow) >= thr_r
    flags_c = dec(jcol) >= thr_cw
    over = (jnp.sum(flags_r, dtype=jnp.int32) > F) | (
        jnp.sum(flags_c, dtype=jnp.int32) > F
    )

    idx_r = _flagged_indices(flags_r, F, S)
    idx_c = _flagged_indices(flags_c, F, W)
    pad_r = idx_r < S
    pad_c = idx_c < W
    rows_f = rg + r0 + jnp.where(pad_r, idx_r, 0)
    cols_f = cg + c0 + jnp.where(pad_c, idx_c, 0)

    # Dense panels (same operands the dense sweep reads).
    Uc, fin_c = _panel(st_c, c0, W, m)
    Ur, fin_r = _panel(stats, r0, S, m)

    # Flagged operand panels (F, m), compacted from the LOCAL job
    # panels by a one-hot matmul — each output row sums exactly one
    # panel row (f32-exact) — instead of row gathers from the ~1M-row
    # windows table.  Padded slots (idx = S/W)
    # compact to zero rows; the fin masks already exclude them.
    Uf_r = _onehot_rows(idx_r, Ur, F, S)
    Uf_c = _onehot_rows(idx_c, Uc, F, W)
    fin_fr = fin_r[jnp.minimum(idx_r, S - 1)] & pad_r
    fin_fc = fin_c[jnp.minimum(idx_c, W - 1)] & pad_c
    thr_fr = jnp.where(pad_r, thr_r[jnp.minimum(idx_r, S - 1)], jnp.inf)
    thr_fc = jnp.where(pad_c, thr_cw[jnp.minimum(idx_c, W - 1)], jnp.inf)

    dot = lambda A, B: jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())),
        preferred_element_type=dt,
        precision=_PRECISION if precision is None else precision,
    )
    zone = (
        (lambda d: jnp.abs(d) >= excl) if two_sided
        else (lambda d: d >= excl)
    )

    # Row side: flagged rows x all W columns (global coordinates).
    P_r = dot(Uf_r, Uc)  # (F, W)
    cols_w = cg + c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid_r = (
        zone(cols_w - rows_f[:, None])
        & (rows_f[:, None] <= w - 1)
        & (cols_w <= wc - 1)
        & fin_fr[:, None]
        & fin_c[None, :]
    )
    hit_r = valid_r & (P_r >= thr_fr[:, None])
    win_r = _suspect_reduce(hit_r, jnp.broadcast_to(cols_w, (F, W)), axis=1)

    # Column side: flagged columns x all S rows.
    P_c = dot(Uf_c, Ur)  # (F, S)
    rows_w = rg + r0 + jnp.arange(S, dtype=jnp.int32)[None, :]
    valid_c = (
        zone(cols_f[:, None] - rows_w)
        & (rows_w <= w - 1)
        & (cols_f[:, None] <= wc - 1)
        & fin_fc[:, None]
        & fin_r[None, :]
    )
    hit_c = valid_c & (P_c >= thr_fc[:, None])
    win_c = _suspect_reduce(hit_c, jnp.broadcast_to(rows_w, (F, S)), axis=1)

    return (
        _dense_merge_cols(idx_r, win_r, F, S),
        _dense_merge_cols(idx_c, win_c, F, W),
        over,
    )


def sweep_band_suspects_fused(
    stats: Stats, r0, k0, geom: BandGeometry, thr: jax.Array, F: int,
    stats_c: Stats | None = None, thr_col: jax.Array | None = None,
    precision=None, rg=0, cg=0, two_sided: bool = False,
):
    """Pass-B job WITHOUT stored pass-A captures: recompute the tile's
    per-row/per-column maxima inline (one dense matmul + two fused
    reductions), flag rows/columns against ``thr``, then capture the
    flagged rows'/columns' suspects with the skinny gathered machinery
    of sweep_band_suspects_sparse.  The sharded-inputs ring tier uses
    this: storing per-job captures across rotation steps would cost
    O(jobs * (S + W)) per device, while the inline recompute adds only
    the two reduction passes (~30% over a value sweep) instead of the
    dense capture's ~9 sequential passes over the (S, W) tile.

    Flag soundness: a row's dense-tile job maximum upper-bounds every
    pair the margin argument needs (mpx.hybrid module docstring), and
    the skinny re-evaluation error is covered by the same margin — the
    true f64 argmax is always captured.

    Returns (dense (S,) row window, dense (W,) col window, overflow);
    on overflow the caller must re-sweep the job densely."""
    dt = jnp.float32
    S, W, m, w, excl, wc = geom.S, geom.W, geom.m, geom.w, geom.excl, geom.wc
    st_c = stats if stats_c is None else stats_c
    thr_c_arr = thr if thr_col is None else thr_col
    c0 = r0 + k0
    init = jnp.float32(AGGREGATE_INIT)

    P, valid, _, _ = _job_correlations(stats, r0, c0, geom, dt, stats_c,
                                       precision, rg=rg, cg=cg,
                                       two_sided=two_sided)
    Pm = jnp.where(valid, P, init)
    rv = jnp.max(Pm, axis=1)
    cv = jnp.max(Pm, axis=0)

    thr_r = jax.lax.dynamic_slice(thr, (r0,), (S,))
    thr_cw = jax.lax.dynamic_slice(thr_c_arr, (c0,), (W,))
    flags_r = rv >= thr_r
    flags_c = cv >= thr_cw
    over = (jnp.sum(flags_r, dtype=jnp.int32) > F) | (
        jnp.sum(flags_c, dtype=jnp.int32) > F
    )

    idx_r = _flagged_indices(flags_r, F, S)
    idx_c = _flagged_indices(flags_c, F, W)
    pad_r = idx_r < S
    pad_c = idx_c < W
    rows_f = rg + r0 + jnp.where(pad_r, idx_r, 0)
    cols_f = cg + c0 + jnp.where(pad_c, idx_c, 0)

    Ur, fin_r = _panel(stats, r0, S, m)
    Uc, fin_c = _panel(st_c, c0, W, m)
    Uf_r = _onehot_rows(idx_r, Ur, F, S)
    Uf_c = _onehot_rows(idx_c, Uc, F, W)
    fin_fr = fin_r[jnp.minimum(idx_r, S - 1)] & pad_r
    fin_fc = fin_c[jnp.minimum(idx_c, W - 1)] & pad_c
    thr_fr = jnp.where(pad_r, thr_r[jnp.minimum(idx_r, S - 1)], jnp.inf)
    thr_fc = jnp.where(pad_c, thr_cw[jnp.minimum(idx_c, W - 1)], jnp.inf)

    dot = lambda A, B: jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())),
        preferred_element_type=dt,
        precision=_PRECISION if precision is None else precision,
    )
    zone = (
        (lambda d: jnp.abs(d) >= excl) if two_sided
        else (lambda d: d >= excl)
    )

    # Row side: flagged rows x all W columns (global coordinates).
    P_r = dot(Uf_r, Uc)  # (F, W)
    cols_w = cg + c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid_r = (
        zone(cols_w - rows_f[:, None])
        & (rows_f[:, None] <= w - 1)
        & (cols_w <= wc - 1)
        & fin_fr[:, None]
        & fin_c[None, :]
    )
    hit_r = valid_r & (P_r >= thr_fr[:, None])
    win_r = _suspect_reduce(hit_r, jnp.broadcast_to(cols_w, (F, W)), axis=1)

    # Column side: flagged columns x all S rows.
    P_c = dot(Uf_c, Ur)  # (F, S)
    rows_w = rg + r0 + jnp.arange(S, dtype=jnp.int32)[None, :]
    valid_c = (
        zone(cols_f[:, None] - rows_w)
        & (rows_w <= w - 1)
        & (cols_f[:, None] <= wc - 1)
        & fin_fc[:, None]
        & fin_r[None, :]
    )
    hit_c = valid_c & (P_c >= thr_fc[:, None])
    win_c = _suspect_reduce(hit_c, jnp.broadcast_to(rows_w, (F, S)), axis=1)

    return (
        _dense_merge_cols(idx_r, win_r, F, S),
        _dense_merge_cols(idx_c, win_c, F, W),
        over,
    )


def _scatter_dense_max(idx, vals, F: int, L: int):
    """Scatter a gathered (F,) f32 max vector back to a dense (L,) array
    (AGGREGATE_INIT elsewhere) via a one-hot matmul: slot indices are
    unique, so each output sums at most one value (exact).  A ones
    column rides along as the touched-slot indicator."""
    onehot = (idx[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :]).astype(
        jnp.float32
    )
    VI = jnp.stack([vals, jnp.ones((F,), jnp.float32)], axis=1)  # (F, 2)
    D = jax.lax.dot_general(
        onehot, VI, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST: a TF32 matmul would round the scattered maxima
        precision=jax.lax.Precision.HIGHEST,
    )  # (L, 2)
    return jnp.where(D[:, 1] > 0, D[:, 0], jnp.float32(AGGREGATE_INIT))


def sweep_band_refine_sparse(
    stats: Stats, r0, k0, jrow: jax.Array, jcol: jax.Array,
    geom: BandGeometry, gthr: jax.Array, F: int,
    stats_c: Stats | None = None, gthr_col: jax.Array | None = None,
    precision=None,
):
    """Cascade refine stage (A2): re-examine at full precision ONLY the
    rows/columns whose low-precision (bf16 pass A1) job maxima ``jrow``
    / ``jcol`` (u16-encoded) reach the refine threshold ``gthr`` (the
    approximate global max minus twice the bf16 error bound plus the
    suspect margin — see mpx.hybrid.run_max_jobs).  For each flagged
    row/column the exact per-job maximum is recomputed with skinny
    gathered matmuls and scattered to dense (S,) / (W,) f32 arrays
    (AGGREGATE_INIT elsewhere: unflagged rows provably hold neither the
    global max nor any suspect in this job).

    Returns (dense row maxima (S,), dense col maxima (W,), overflow)."""
    dt = jnp.float32
    S, W, m, w, excl, wc = geom.S, geom.W, geom.m, geom.w, geom.excl, geom.wc
    st_c = stats if stats_c is None else stats_c
    gthr_c_arr = gthr if gthr_col is None else gthr_col
    c0 = r0 + k0

    thr_r = jax.lax.dynamic_slice(gthr, (r0,), (S,))
    thr_cw = jax.lax.dynamic_slice(gthr_c_arr, (c0,), (W,))
    dec = lambda q: q.astype(jnp.float32) * jnp.float32(2.0 / 65535.0) - 1.0
    flags_r = dec(jrow) >= thr_r
    flags_c = dec(jcol) >= thr_cw
    over = (jnp.sum(flags_r, dtype=jnp.int32) > F) | (
        jnp.sum(flags_c, dtype=jnp.int32) > F
    )

    idx_r = _flagged_indices(flags_r, F, S)
    idx_c = _flagged_indices(flags_c, F, W)
    pad_r = idx_r < S
    pad_c = idx_c < W
    rows_f = r0 + jnp.where(pad_r, idx_r, 0)
    cols_f = c0 + jnp.where(pad_c, idx_c, 0)

    Uc, fin_c = _panel(st_c, c0, W, m)
    Ur, fin_r = _panel(stats, r0, S, m)
    # Local one-hot compaction instead of windows-table row gathers
    # (see sweep_band_suspects_sparse).
    Uf_r = _onehot_rows(idx_r, Ur, F, S)
    Uf_c = _onehot_rows(idx_c, Uc, F, W)
    fin_fr = fin_r[jnp.minimum(idx_r, S - 1)] & pad_r
    fin_fc = fin_c[jnp.minimum(idx_c, W - 1)] & pad_c

    dot = lambda A, B: jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())),
        preferred_element_type=dt,
        precision=_PRECISION if precision is None else precision,
    )
    init = jnp.float32(AGGREGATE_INIT)

    P_r = dot(Uf_r, Uc)  # (F, W)
    cols_w = c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid_r = (
        (cols_w - rows_f[:, None] >= excl)
        & (rows_f[:, None] <= w - 1)
        & (cols_w <= wc - 1)
        & fin_fr[:, None]
        & fin_c[None, :]
    )
    max_r = jnp.max(jnp.where(valid_r, P_r, init), axis=1)  # (F,)

    P_c = dot(Uf_c, Ur)  # (F, S)
    rows_w = r0 + jnp.arange(S, dtype=jnp.int32)[None, :]
    valid_c = (
        (cols_f[:, None] - rows_w >= excl)
        & (rows_w <= w - 1)
        & (cols_f[:, None] <= wc - 1)
        & fin_fc[:, None]
        & fin_r[None, :]
    )
    max_c = jnp.max(jnp.where(valid_c, P_c, init), axis=1)  # (F,)

    return (
        _scatter_dense_max(idx_r, max_r, F, S),
        _scatter_dense_max(idx_c, max_c, F, W),
        over,
    )


def sweep_band_suspects(
    stats: Stats, r0, k0, geom: BandGeometry, dtype, thr: jax.Array,
    stats_c: Stats | None = None, thr_col: jax.Array | None = None,
    precision=None, rg=0, cg=0, two_sided: bool = False,
) -> SuspectOut:
    """Stage-2 sweep of the hybrid double tier: recompute the f32
    correlation tile and summarize, per subsequence, every pair whose
    correlation reaches ``thr`` (its global f32 maximum minus the hybrid
    margin).  The job grid covers each valid pair exactly once (see
    mpx.config.make_job_grid), so counts sum correctly across jobs.

    AB-joins pass ``stats_c``/``thr_col`` for the column (target) axis;
    self-joins use one statistics set and one threshold array.
    ``thr``/``thr_col`` are indexed with the LOCAL offsets (r0 / c0);
    sharded-input callers pass device-local threshold blocks."""
    dt = jnp.dtype(dtype)
    c0 = r0 + k0
    S, W = geom.S, geom.W
    P, valid, rows, cols = _job_correlations(stats, r0, c0, geom, dt, stats_c,
                                             precision, rg=rg, cg=cg,
                                             two_sided=two_sided)
    thr_r = jax.lax.dynamic_slice(thr, (r0,), (S,))
    thr_c = jax.lax.dynamic_slice(
        thr if thr_col is None else thr_col, (c0,), (W,)
    )
    hit_r = valid & (P >= thr_r[:, None])
    hit_c = valid & (P >= thr_c[None, :])
    bcols = jnp.broadcast_to(cols, (S, W))
    brows = jnp.broadcast_to(rows, (S, W))
    return SuspectOut(
        row=_suspect_reduce(hit_r, bcols, axis=1),
        col=_suspect_reduce(hit_c, brows, axis=0),
    )
