"""Fused pan-profile kernel: every window length in ONE sweep.

The naive pan profile (SKIMP, Madrid et al. 2019 — and mpx's
``method='exact'`` path) runs R independent O(n^2 * m_r) joins.  This
kernel exploits the algebra of centered dot products to sweep ALL R
window lengths in a single pass over the O(n^2) pair grid, carrying the
centered cross-product panel across levels:

    C_r(i, j) = sum_{k < m_r} (T[i+k] - mu_r[i]) (T[j+k] - mu_r[j])

satisfies the exact update (mu' = mu_{r+1}, dmu = mu' - mu)

    C_{r+1} = C_r + dA @ dB^T - m_{r+1} * outer(dmu_i, dmu_j)

where dA/dB are the *new* window columns [m_r, m_{r+1}) centered at the
OLD means.  (Proof: expand sum (a-mu')(b-nu') with mu' = mu + dmu and
use sum_{k<m'} (a_k - mu) = m' dmu.)  Per level the work added is a
skinny (S, dm) x (dm, W) matmul plus a rank-1 correction and the usual
masked max/argmax epilogue — so the matmul volume for the whole pan is
O(n^2 * m_max) instead of O(n^2 * sum(m_r)), and the O(n) statistics
stage on device once instead of once per row.

Numerics: the carry accumulates f32 rounding per level on top of the
HIGHEST-precision (true fp32) matmuls — on the GPU, DEFAULT and HIGH
would run in TF32 and lose ~1e-3 relative per product.  For
log-spaced levels the correction terms are bounded by ~0.5x the carry
magnitude, so the error stays O(levels * eps_f32) relative — validated
against the exact per-m golden at 2e-3 in tests/test_pan.py.  The pan
surface is an f32 product by design; ``compute_pan_profile`` routes
float64 requests to the exact per-m path.

Reference analog: none (the reference fixes one m per bitstream build —
CMakeLists.txt:33-46); this is the capability SKIMP adds on top.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mpx.dtypes import AGGREGATE_INIT
from mpx.ops.aggregates import init_aggregates, merge_window, postcompute
from mpx.types import Aggregates


class PanStats(NamedTuple):
    """Device-resident multi-level statistics.

    ``mu``/``inv`` rows are per level (inv = +inf beyond w_r and for
    degenerate windows — the same not-finite convention as Stats);
    ``dmu`` rows are mu_{r+1} - mu_r computed in f64 host-side (the
    difference of close means loses too much in f32)."""

    T: jax.Array    # (pw + m_max - 1,) f32, zero-padded
    mu: jax.Array   # (R, pw) f32
    dmu: jax.Array  # (R-1, pw) f32
    inv: jax.Array  # (R, pw) f32, +inf where invalid


def build_pan_stats(T, ms: Sequence[int], band: int, chunk: int) -> PanStats:
    """Host-side per-level statistics (native C++/numpy f64 two-pass,
    exact), staged to the device once for the whole pan."""
    from mpx.ops.precompute import _padded_width, precompute_statistics_numpy
    from mpx import native

    T64 = np.asarray(T, np.float64)
    n = T64.shape[0]
    ms = [int(m) for m in ms]
    m_max = ms[-1]
    w0 = n - ms[0] + 1
    pw = _padded_width(w0, band, chunk)
    R = len(ms)

    mu = np.zeros((R, pw), np.float64)
    inv = np.full((R, pw), np.inf, np.float64)
    for r, m in enumerate(ms):
        s = (native.precompute(T64, m) if native.is_available()
             else precompute_statistics_numpy(T64, m))
        wr = n - m + 1
        mu[r, :wr] = s["mu"]
        inv[r, :wr] = s["inv"]
    dmu = mu[1:] - mu[:-1]

    # + _PANEL_BLOCK padding: _raw_panel reads blocked column segments
    # up to the rounded-up panel width.
    Tp = np.zeros(pw + _panel_width(m_max) - 1, np.float32)
    Tp[:n] = T64.astype(np.float32)
    return PanStats(
        T=jnp.asarray(Tp),
        mu=jnp.asarray(mu.astype(np.float32)),
        dmu=jnp.asarray(dmu.astype(np.float32)),
        inv=jnp.asarray(inv.astype(np.float32)),
    )


# Columns per raw-panel build block: HLO cost is O(block) once (traced
# one block body), runtime is m/block map steps — the balance between a
# full stacked-slices build (O(m_max) HLO -> minutes of compile at
# pan-scale m) and a per-column loop (thousands of
# serialized while iterations per job).
_PANEL_BLOCK = 128


def _panel_width(m_max: int) -> int:
    return ((m_max + _PANEL_BLOCK - 1) // _PANEL_BLOCK) * _PANEL_BLOCK


def _raw_panel(Tseg: jax.Array, count: int, m_pad: int) -> jax.Array:
    """(count, m_pad) raw window matrix — column j is Tseg[j : j+count].
    ``m_pad`` must be a _PANEL_BLOCK multiple and Tseg must hold
    count + m_pad - 1 values (build_pan_stats pads the series so)."""
    nb = m_pad // _PANEL_BLOCK

    def blk(i):
        o = i * _PANEL_BLOCK
        seg = jax.lax.dynamic_slice(
            Tseg, (o,), (count + _PANEL_BLOCK - 1,)
        )
        return jnp.stack(
            [seg[j : j + count] for j in range(_PANEL_BLOCK)], axis=1
        )

    out = jax.lax.map(blk, jnp.arange(nb, dtype=jnp.int32))
    return jnp.moveaxis(out, 0, 1).reshape(count, m_pad)


def _level_epilogue(C, inv_r, inv_c, rows, cols, m, w):
    """Masked P + row/col max/argmax for one level (the mxu epilogue)."""
    init_v = jnp.float32(AGGREGATE_INIT)
    fin_r = jnp.isfinite(inv_r)
    fin_c = jnp.isfinite(inv_c)
    P = C * jnp.where(fin_r, inv_r, 0)[:, None] * jnp.where(fin_c, inv_c, 0)[None, :]
    valid = (
        (cols - rows >= m // 4)
        & (rows <= w - 1)
        & (cols <= w - 1)
        & fin_r[:, None]
        & fin_c[None, :]
    )
    Pm = jnp.where(valid, P, init_v)
    big = np.int32(2**30)
    row_v = jnp.max(Pm, axis=1)
    ri = jnp.min(jnp.where(Pm == row_v[:, None], cols, big), axis=1)
    row_i = jnp.where(row_v > init_v, ri.astype(jnp.int32), jnp.int32(-1))
    col_v = jnp.max(Pm, axis=0)
    ci = jnp.min(jnp.where(Pm == col_v[None, :], rows, big), axis=0)
    col_i = jnp.where(col_v > init_v, ci.astype(jnp.int32), jnp.int32(-1))
    return Aggregates(row_v, row_i), Aggregates(col_v, col_i)


def _pan_job(ps: PanStats, r0, c0, *, S, W, ms, n, prec):
    """All-level aggregates for one (S x W) rectangle of the pair grid."""
    R = len(ms)
    m_max = ms[-1]
    dot = lambda A, B: jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=prec,
    )

    m_pad = _panel_width(m_max)
    Tr = jax.lax.dynamic_slice(ps.T, (r0,), (S + m_pad - 1,))
    Tc = jax.lax.dynamic_slice(ps.T, (c0,), (W + m_pad - 1,))
    rawA = _raw_panel(Tr, S, m_pad)
    rawB = _raw_panel(Tc, W, m_pad)
    rows = r0 + jnp.arange(S, dtype=jnp.int32)[:, None]
    cols = c0 + jnp.arange(W, dtype=jnp.int32)[None, :]

    lev = lambda M, idx, o, count: jax.lax.dynamic_slice(
        M, (idx, o), (1, count)
    )[0]

    mu_r = lev(ps.mu, 0, r0, S)
    mu_c = lev(ps.mu, 0, c0, W)
    A0 = rawA[:, : ms[0]] - mu_r[:, None]
    B0 = rawB[:, : ms[0]] - mu_c[:, None]
    C = dot(A0, B0)

    outs = []
    for r in range(R):
        m = ms[r]
        wr = n - m + 1
        outs.append(_level_epilogue(
            C, lev(ps.inv, r, r0, S), lev(ps.inv, r, c0, W),
            rows, cols, m, wr,
        ))
        if r + 1 < R:
            m2 = ms[r + 1]
            mu_r = lev(ps.mu, r, r0, S)
            mu_c = lev(ps.mu, r, c0, W)
            dA = rawA[:, m:m2] - mu_r[:, None]
            dB = rawB[:, m:m2] - mu_c[:, None]
            dmu_r = lev(ps.dmu, r, r0, S)
            dmu_c = lev(ps.dmu, r, c0, W)
            C = C + dot(dA, dB) - jnp.float32(m2) * dmu_r[:, None] * dmu_c[None, :]
    return outs


@partial(jax.jit, static_argnames=("S", "W", "ms", "n", "L"))
def _run_pan_group(ps: PanStats, r0s, k0s, carry_rows, carry_cols, *,
                   S: int, W: int, ms: tuple, n: int, L: int):
    """Scan the job list, merging every level's window aggregates into
    the carried (R, L) global aggregate stacks."""
    prec = jax.lax.Precision.HIGHEST

    def body(carry, job):
        rows, cols = carry
        r0, k0 = job
        outs = _pan_job(ps, r0, r0 + k0, S=S, W=W, ms=ms, n=n, prec=prec)
        for r, (wrow, wcol) in enumerate(outs):
            rr = merge_window(
                Aggregates(rows.value[r], rows.index[r]), wrow, r0)
            cc = merge_window(
                Aggregates(cols.value[r], cols.index[r]), wcol, r0 + k0)
            rows = Aggregates(rows.value.at[r].set(rr.value),
                              rows.index.at[r].set(rr.index))
            cols = Aggregates(cols.value.at[r].set(cc.value),
                              cols.index.at[r].set(cc.index))
        return (rows, cols), None

    (carry_rows, carry_cols), _ = jax.lax.scan(
        body, (carry_rows, carry_cols), (r0s, k0s))
    return carry_rows, carry_cols


def run_pan_jobs(T, ms: Sequence[int], *, band: int, chunk: int,
                 profile=None):
    """Compute the full pan profile surface on one device, in one
    dispatch.

    Returns (PMP (R, w0) f64 distances — +inf beyond each level's width
    — and PMPI (R, w0) int32)."""
    from mpx.config import make_job_grid
    from mpx.utils.profile import phase as _phase

    ms = tuple(int(m) for m in ms)
    if sorted(set(ms)) != list(ms):
        raise ValueError("ms must be strictly ascending")
    T = np.asarray(T)
    n = T.shape[0]
    R = len(ms)
    w0 = n - ms[0] + 1
    L = w0 + band + chunk

    with _phase(profile, "1. Pre-Computation [pan host]"):
        ps = build_pan_stats(T, ms, band, chunk)
        grid = make_job_grid(w0, band, chunk)

    rows = Aggregates(
        value=jnp.stack([init_aggregates(L, jnp.float32, AGGREGATE_INIT).value] * R),
        index=jnp.stack([init_aggregates(L, jnp.float32, AGGREGATE_INIT).index] * R),
    )
    cols = rows

    with _phase(profile, f"2. Compute [pan x{R} levels]"):
        rows, cols = _run_pan_group(
            ps, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
            rows, cols, S=band, W=chunk, ms=ms, n=n, L=L,
        )
        jax.block_until_ready((rows, cols))

    with _phase(profile, "3. Post-Computation [pan]"):
        PMP = np.full((R, w0), np.inf, np.float64)
        PMPI = np.full((R, w0), -1, np.int32)
        outs = [
            postcompute(Aggregates(rows.value[r], rows.index[r]),
                        Aggregates(cols.value[r], cols.index[r]),
                        ms[r], n - ms[r] + 1)
            for r in range(R)
        ]
        outs = jax.block_until_ready(outs)
        for r, (MP, MPI) in enumerate(outs):
            wr = n - ms[r] + 1
            PMP[r, :wr] = np.asarray(MP, np.float64)
            PMPI[r, :wr] = np.asarray(MPI)
    return PMP, PMPI
