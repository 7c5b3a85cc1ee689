"""Pure-XLA band sweep (lax.scan over rows).

The portable kernel backend: runs on any backend, supports float64, and is
used as the reference-protocol analog of the Vanilla HLS kernel
(kernel/MatrixProfileKernelVanilla.cpp:57-106).  Each scan step processes
one row of the band against all W diagonals as full-width vector ops — the
direct translation of the II=1 inner loop into vector-width SIMD, with
the 8x8 TreeReduce dependency-breaking machinery replaced by plain jnp
reductions (an FPGA-II artifact with no accelerator equivalent; SURVEY
§2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mpx.dtypes import AGGREGATE_INIT, INDEX_INIT
from mpx.kernels.common import BandGeometry, BandOut, seed_qt
from mpx.types import Aggregates, Stats


def sweep_band_xla(
    stats: Stats, r0, k0, geom: BandGeometry, dtype
) -> BandOut:
    S, W, m, w, excl = geom.S, geom.W, geom.m, geom.w, geom.excl
    dt = jnp.dtype(dtype)
    init_v = jnp.asarray(AGGREGATE_INIT, dt)
    c0 = r0 + k0

    # Per-job input windows (the MemoryToStream analog,
    # kernel/MatrixProfileKernelTiled.cpp:38-90 — here just slices).
    df_r = jax.lax.dynamic_slice(stats.df, (r0,), (S,))
    dg_r = jax.lax.dynamic_slice(stats.dg, (r0,), (S,))
    inv_r = jax.lax.dynamic_slice(stats.inv, (r0,), (S,))
    df_c = jax.lax.dynamic_slice(stats.df, (c0,), (W + S,))
    dg_c = jax.lax.dynamic_slice(stats.dg, (c0,), (W + S,))
    inv_c = jax.lax.dynamic_slice(stats.inv, (c0,), (W + S,))

    qt_seed = seed_qt(stats, r0, c0, W, m)

    lanes_w = jnp.arange(W, dtype=jnp.int32)
    diag_ok = (k0 + lanes_w) >= excl
    lanes_ws = jnp.arange(W + S, dtype=jnp.int32)
    col_ok = ((c0 + lanes_ws) <= w - 1) & jnp.isfinite(inv_c)
    rows_s = jnp.arange(S, dtype=jnp.int32)
    row_ok = ((r0 + rows_s) <= w - 1) & jnp.isfinite(inv_r)

    def step(carry, i):
        qt, cv, ci = carry

        dgc = jax.lax.dynamic_slice(dg_c, (i,), (W,))
        dfc = jax.lax.dynamic_slice(df_c, (i,), (W,))
        invc = jax.lax.dynamic_slice(inv_c, (i,), (W,))
        cok = jax.lax.dynamic_slice(col_ok, (i,), (W,))

        # SCAMP O(1) diagonal update (row 0 of the band uses the exact
        # closed-form seed directly, like the reference kernel uses the
        # driver-provided first-row QT).
        upd = df_r[i] * dgc + dfc * dg_r[i]
        qt = jnp.where(i > 0, qt + upd, qt)

        p = qt * inv_r[i] * invc
        valid = diag_ok & cok & row_ok[i]
        pm = jnp.where(valid, p, init_v)

        # Row aggregate: max + first-occurrence argmax.
        rv = jnp.max(pm)
        ri = jnp.where(
            rv > init_v,
            (c0 + i + jnp.argmax(pm)).astype(jnp.int32),
            jnp.int32(INDEX_INIT),
        )

        # Column aggregates: shift the column-aligned carry by one lane
        # (lane 0 = expiring column c0 + i - 1 was emitted last row),
        # then max-update with this row's correlations.
        cvs = jnp.concatenate([cv[1:], jnp.full((1,), init_v, dt)])
        cis = jnp.concatenate([ci[1:], jnp.full((1,), INDEX_INIT, jnp.int32)])
        better = pm > cvs
        cv = jnp.where(better, pm, cvs)
        ci = jnp.where(better, (r0 + i).astype(jnp.int32), cis)

        return (qt, cv, ci), (rv, ri, cv[0], ci[0])

    carry0 = (
        qt_seed.astype(dt),
        jnp.full((W,), init_v, dt),
        jnp.full((W,), INDEX_INIT, jnp.int32),
    )
    (qt, cv, ci), (row_v, row_i, exp_v, exp_i) = jax.lax.scan(
        step, carry0, rows_s
    )

    # Column window [c0, c0+S+W): the S expired columns streamed out per
    # row followed by the surviving tail window (shifted once more; its
    # last lane, column c0+S+W-1, is never touched by this band).
    col_v = jnp.concatenate([exp_v, cv[1:], jnp.full((1,), init_v, dt)])
    col_i = jnp.concatenate(
        [exp_i, ci[1:], jnp.full((1,), INDEX_INIT, jnp.int32)]
    )
    return BandOut(
        row=Aggregates(row_v, row_i),
        col=Aggregates(col_v, col_i),
    )
