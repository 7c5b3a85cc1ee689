"""Hybrid double-precision tier: f32 device sweeps + exact f64 rescoring.

The reference's flagship configuration is the double-precision 1M-point
self-join (/root/reference/README.md:35, CMakeLists.txt:11).  This
module computes the exact f64 profile with all O(n^2) work in f32
matmul sweeps on the device and only O(n) exact f64 work on the host
(whether native f64 matmuls beat it on the GPU is an open measurement,
ROADMAP speed item 3):

1. **Pass A** — the standard f32 max/argmax sweep (mpx.driver.run_jobs)
   yields each subsequence's maximum f32 correlation ``gmax32``.
2. **Pass B** — a SPARSE second sweep: pass A also records each job's
   per-row/per-column maxima, so only the rows/columns whose job
   maximum reaches ``thr = gmax32 - margin`` are re-examined (skinny
   gathered matmuls; sweep_band_suspects_sparse), counting every valid
   pair at the threshold and capturing the SUSPECT_K smallest and
   largest such neighbor indices (associative merges; the job grid
   covers each pair exactly once).  Jobs overflowing the flag budget
   fall back to the dense sweep (sweep_band_suspects), which is also
   used by the multi-chip sharded path.
3. **Rescore** — the captured suspects (<= 2*SUSPECT_K per
   subsequence) are rescored exactly in f64 on the host (native C++ or
   numpy; device gathers in emulated f64 are pathologically slow).
4. **Escalate** — subsequences whose count overflows the capture slots
   resolve by exact interval rescoring when the captured index bracket
   is narrow (correlation plateaus); the rest get a device pass C:
   their full profile row is recomputed blockwise on the device and the
   top-K=64 entries are rescored, with an on-device coverage count
   proving all suspects were captured.  Only a count > K
   (pathologically tied data) falls back to an exact f64 host scan of
   the whole row.

Correctness is deterministic given the f32 error bound ``margin``: with
``|P32 - P64| <= margin`` for every pair, the true f64 argmax c* has
``P32(c*) >= P64(c*) - margin >= gmax32 - 2*margin = thr`` (because
``gmax32 <= best64 + margin``), so c* is always a suspect; and any pair
below ``thr`` has ``P64 < gmax32 - margin <= best64``, so it can never
win.  The rescored values themselves are exact f64.  ``margin``
(default_margin) holds only for true-f32 products: every sweep runs at
HYBRID_PRECISION = HIGHEST.
"""

from __future__ import annotations

import itertools
import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import AGGREGATE_INIT, INDEX_INIT
from mpx.kernels import band_geometry
from mpx.kernels.mxu import (
    SUSPECT_K,
    SUSPECT_MAX_INIT,
    SUSPECT_MIN_INIT,
    SuspectWindow,
    sweep_band_suspects,
)
from mpx.utils.logging import Logger
from mpx.utils.profile import phase as _phase


# Matmul precision for the hybrid's f32 sweeps (passes A/B/C).  HIGHEST
# is true fp32 on every backend.  On the GPU, DEFAULT and HIGH both run
# in TF32 (10 mantissa bits): the per-pair error of a unit-normalized
# dot then reaches ~1e-3, an order of magnitude past default_margin, so
# pass B could miss the true neighbor.  tests/test_precision_guard.py
# keeps every f32 sweep at this precision.
HYBRID_PRECISION = "HIGHEST"


def default_margin(m: int) -> float:
    """f32 sweep error budget for HIGHEST-precision (true fp32) unit-
    window dots: linear in m with a floor for small m, >= 4x the
    worst-case per-pair error observed over a 5.5e11-pair n=2^20, m=256
    self-join (2.4e-5)."""
    return max(1e-4, 4e-7 * m)


def _prec(precision: Optional[str]):
    """Static precision name -> jax precision: a ``Precision`` member
    or a ``DotAlgorithmPreset`` name (None = module default)."""
    if precision is None:
        return None
    if hasattr(jax.lax.Precision, precision):
        return getattr(jax.lax.Precision, precision)
    return getattr(jax.lax.DotAlgorithmPreset, precision)


# Device-side f64 statistics for large hybrid runs (showcase lever,
# round 4): stage T only and compute mu/inv on device, overlapped with
# the host f64 stats.  auto = on from MPX_HYBRID_DEVICE_STATS_MIN_W
# (staging dominates pre-compute above that); 1/0 force on/off.
HYBRID_DEVICE_STATS_MIN_W = int(
    os.environ.get("MPX_HYBRID_DEVICE_STATS_MIN_W", 1 << 19)
)


def _sync_phases() -> bool:
    """MPX_HYBRID_SYNC_PHASES=1 restores a device sync at every phase
    boundary so profile reports attribute device time to the phase that
    dispatched it.  Default OFF: the end-to-end wall is what matters,
    and the syncs serialize work that otherwise overlaps (the pass-B
    routing dispatches enqueue behind pass A on the device queue)."""
    return os.environ.get("MPX_HYBRID_SYNC_PHASES", "0") not in ("0", "", "off")


def _device_stats_enabled(w: int) -> bool:
    env = os.environ.get("MPX_HYBRID_DEVICE_STATS", "auto")
    if env == "auto":
        return w >= HYBRID_DEVICE_STATS_MIN_W
    return env not in ("0", "off", "false")


def _reconcile_degenerate(stats, inv64: np.ndarray, w: int, dev_bad=None):
    """Force the device degeneracy mask to EXACTLY match the host
    two-pass classification (mpx/ops/precompute.py ZERO_VARIANCE_REL).

    Degenerate windows (inv = inf) are excluded from the join OUTRIGHT —
    unlike value rounding, which the pass-A/B margin absorbs — so a
    device/host disagreement would silently drop (or phantom-add) a
    window from the exact result.  The device's globally-centered cumsum
    variance can disagree with the host's two-pass form only within
    ~ulp of the threshold; fetch one byte per window, compare, and
    scatter-fix the (almost always zero) differences.

    ``dev_bad`` lets the caller pass a pre-dispatched device mask (see
    the optimistic-reconcile flow in compute_matrix_profile_f64_hybrid,
    which overlaps this check with the pass-A dispatch chain)."""
    if dev_bad is None:
        dev_bad = jnp.isinf(stats.inv)
    dev_bad = np.asarray(dev_bad)[:w]
    host_bad = np.isinf(inv64)
    diff = np.nonzero(dev_bad != host_bad)[0]
    if diff.size:
        Logger.info(
            f"hybrid device stats: reconciling {diff.size} degenerate-"
            f"window classification(s) with the host estimator"
        )
        fix = np.where(
            host_bad[diff], np.float32(np.inf), inv64[diff].astype(np.float32)
        )
        stats = stats._replace(
            inv=stats.inv.at[jnp.asarray(diff)].set(jnp.asarray(fix))
        )
    return stats


def _merge_sorted_k(a, b, ascending: bool):
    """First-K merge of two sorted (..., K) vectors via the merge-path
    identity ``merged[i] = max_{j+k=i} min(a[j], b[k])`` (min/max swap
    for descending) — pure elementwise column ops, no sort."""
    K = a.shape[-1]
    inner, outer = (
        (jnp.minimum, jnp.maximum) if ascending else (jnp.maximum, jnp.minimum)
    )
    cols = []
    for i in range(K):
        terms = [inner(a[..., j], b[..., i - j]) for j in range(i + 1)]
        acc = terms[0]
        for t in terms[1:]:
            acc = outer(acc, t)
        cols.append(acc)
    return jnp.stack(cols, axis=-1)


def _combine_suspects(a: SuspectWindow, b: SuspectWindow) -> SuspectWindow:
    """Elementwise merge of two suspect summaries over the same axis:
    cnt adds; the k-smallest (k-largest) of the union come from a
    merge network over the two sorted K-vectors — associative, so job /
    side order never matters."""
    return SuspectWindow(
        cnt=a.cnt + b.cnt,
        mn=_merge_sorted_k(a.mn, b.mn, ascending=True),
        mx=_merge_sorted_k(a.mx, b.mx, ascending=False),
    )


def _merge_suspects_at(g: SuspectWindow, win: SuspectWindow, offset) -> SuspectWindow:
    """Merge a job's suspect window into the global arrays at ``offset``."""
    size = win.cnt.shape[0]
    zero = np.int32(0)
    sl1 = lambda a: jax.lax.dynamic_slice(a, (offset,), (size,))
    sl2 = lambda a: jax.lax.dynamic_slice(a, (offset, zero), (size, SUSPECT_K))
    merged = _combine_suspects(
        SuspectWindow(cnt=sl1(g.cnt), mn=sl2(g.mn), mx=sl2(g.mx)), win
    )
    return SuspectWindow(
        cnt=jax.lax.dynamic_update_slice(g.cnt, merged.cnt, (offset,)),
        mn=jax.lax.dynamic_update_slice(g.mn, merged.mn, (offset, zero)),
        mx=jax.lax.dynamic_update_slice(g.mx, merged.mx, (offset, zero)),
    )


def _init_suspects(L: int) -> SuspectWindow:
    return SuspectWindow(
        cnt=jnp.zeros((L,), jnp.int32),
        mn=jnp.full((L, SUSPECT_K), SUSPECT_MIN_INIT, jnp.int32),
        mx=jnp.full((L, SUSPECT_K), SUSPECT_MAX_INIT, jnp.int32),
    )


@partial(jax.jit, static_argnames=("S", "W", "m", "w", "tr", "tc", "wc",
                                   "excl", "prec"))
def _suspect_jobs_group(stats, thr, r0s, k0s, rows_g, cols_g, *, S, W, m, w,
                        tr, tc, wc=None, excl=None, stats_c=None,
                        thr_col=None, prec=None):
    """One dispatch group of the pass-B suspect sweep (all merges are
    associative: sum counts, min/max index capture)."""
    geom = band_geometry(S, W, m, w, tr, tc, wc=wc, excl=excl)

    def body(carry, job):
        rows_g, cols_g = carry
        r0, k0 = job
        out = sweep_band_suspects(
            stats, r0, k0, geom, jnp.float32, thr, stats_c, thr_col,
            precision=_prec(prec),
        )
        rows_g = _merge_suspects_at(rows_g, out.row, r0)
        cols_g = _merge_suspects_at(cols_g, out.col, r0 + k0)
        return (rows_g, cols_g), None

    return jax.lax.scan(body, (rows_g, cols_g), (r0s, k0s))[0]


@partial(jax.jit, static_argnames=("w",))
def _fold_suspects(rows_g, cols_g, *, w):
    return _combine_suspects(
        jax.tree.map(lambda a: a[:w], rows_g),
        jax.tree.map(lambda a: a[:w], cols_g),
    )


def run_suspect_jobs(stats, thr, r0s, k0s, *, S, W, m, w, tr, tc,
                     wc=None, excl=None, stats_c=None, thr_col=None,
                     combine=True, ckpt=None, rows_g=None, cols_g=None):
    """Pass B: sweep all jobs (in checkpoint-sized groups under ``ckpt``), merging
    per-job suspect summaries into global row-axis and column-axis
    arrays.  Self-joins (combine=True) fold the two sides into one
    per-subsequence summary; AB-joins get (query, target) separately.

    ``ckpt`` persists state + done-mask per group; ``rows_g``/``cols_g``
    seed the merge from a loaded checkpoint (resume path)."""
    r0s = np.asarray(r0s, np.int32)
    k0s = np.asarray(k0s, np.int32)
    Lr = w + S
    Lc = (w if wc is None else wc) + W
    if rows_g is None:
        rows_g, cols_g = _init_suspects(Lr), _init_suspects(Lc)
    for gr, gk in _job_groups(r0s, k0s, w, ckpt):
        rows_g, cols_g = _suspect_jobs_group(
            stats, thr, jnp.asarray(gr), jnp.asarray(gk), rows_g, cols_g,
            S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
            stats_c=stats_c, thr_col=thr_col, prec=HYBRID_PRECISION,
        )
        if ckpt is not None:
            ckpt.mark_done_and_save(rows_g, cols_g, gr, gk)
    if combine:
        return _fold_suspects(rows_g, cols_g, w=w)
    return rows_g, cols_g


@partial(jax.jit,
         static_argnames=("S", "W", "m", "w", "tr", "tc", "wc", "excl", "F",
                          "prec"))
def _sparse_suspect_group(stats, thr, r0s, k0s, jrow_g, jcol_g, rows_g,
                          cols_g, *, S, W, m, w, tr, tc, F,
                          wc=None, excl=None, stats_c=None, thr_col=None,
                          prec=None):
    """One dispatch group of the SPARSE pass-B sweep: each job re-examines
    only the rows/columns whose pass-A job maxima reach the threshold
    (see mpx.kernels.mxu.sweep_band_suspects_sparse).  Jobs whose flagged
    count exceeds F contribute nothing here and are reported in the
    returned overflow mask for a dense re-sweep."""
    from mpx.kernels.mxu import sweep_band_suspects_sparse

    geom = band_geometry(S, W, m, w, tr, tc, wc=wc, excl=excl)

    def body(carry, job):
        rows_g, cols_g = carry
        r0, k0, jrow, jcol = job
        win_r, win_c, over = sweep_band_suspects_sparse(
            stats, r0, k0, jrow, jcol, geom, thr, F, stats_c, thr_col,
            precision=_prec(prec),
        )
        # Overflowed jobs are re-swept densely by the caller: drop their
        # partial captures entirely so nothing double-counts.
        keep_r = _init_suspects(S)
        keep_c = _init_suspects(W)
        win_r = jax.tree.map(
            lambda a, b: jnp.where(over, b, a), win_r, keep_r
        )
        win_c = jax.tree.map(
            lambda a, b: jnp.where(over, b, a), win_c, keep_c
        )
        rows_g = _merge_suspects_at(rows_g, win_r, r0)
        cols_g = _merge_suspects_at(cols_g, win_c, r0 + k0)
        return (rows_g, cols_g), over

    (rows_g, cols_g), overs = jax.lax.scan(
        body, (rows_g, cols_g), (r0s, k0s, jrow_g, jcol_g)
    )
    return rows_g, cols_g, overs


def _sparse_ok(stats, width: int) -> bool:
    """Sparse pass B needs the normalized-windows matrix (gathered row
    panels) and f32-exact index encoding in its one-hot merges."""
    return (
        stats.windows is not None
        and width < 2**23
        and os.environ.get("MPX_HYBRID_SPARSE", "1") != "0"
    )


def _sparse_budget(S: int, W: int) -> int:
    """Flagged-slot budget per job.  Expected flags per job are
    ~(suspects-per-subsequence x S / jobs-per-row-axis) — tens at the
    showcase geometry — but correlation plateaus (smooth data) inflate
    them, so budget generously: the skinny matmuls are cheap and
    overflow costs a dense job re-sweep.  Measured at the 1M showcase
    geometry (S=4096, W=16384): flags/job mean 67, p99 225, max 437 —
    budget 640 leaves ~1.5x headroom over the observed max."""
    env = os.environ.get("MPX_SPARSE_BUDGET")
    if env:
        return min(S, W, int(env))
    return min(S, W, max(256, (S + W) // 32))


def _encode_max_u16(v):
    """Round-up u16 quantization of a correlation in [-1, 1] (quantum
    2/65535 ~ 3e-5): decoded values are >= the f32 truth, so pass-B
    flags from encoded maxima are a conservative superset (the margin
    is >= 1.8e-4, so the over-flagging is <= ~8% of the suspect band).
    Halves the captured per-job maxima (the biggest pass-A HBM write).
    Out-of-range values clamp: AGGREGATE_INIT -> -1 (caught by the
    degenerate-row +inf threshold), >1 f32 rounding -> 1.0 (safe: any
    threshold is at least margin below 1)."""
    q = jnp.ceil((v + 1.0) * jnp.float32(65535.0 / 2.0))
    return jnp.clip(q, 0.0, 65535.0).astype(jnp.uint16)


def _decode_max_u16(q):
    return q.astype(jnp.float32) * jnp.float32(2.0 / 65535.0) - 1.0


@partial(jax.jit, static_argnames=("S", "W"))
def _flag_counts(thr, thr_col, r0s, k0s, jrow_g, jcol_g, *, S, W):
    """Exact per-job flagged row/column counts from pass A's captured
    (u16-encoded) maxima — the same comparisons the sparse kernel
    performs, so the tier routing below can never overflow a tier's
    panel budget."""

    def per_job(r0, k0, jrow, jcol):
        tr_ = jax.lax.dynamic_slice(thr, (r0,), (S,))
        tc_ = jax.lax.dynamic_slice(thr_col, (r0 + k0,), (W,))
        nr = jnp.sum(_decode_max_u16(jrow) >= tr_, dtype=jnp.int32)
        nc = jnp.sum(_decode_max_u16(jcol) >= tc_, dtype=jnp.int32)
        return jnp.maximum(nr, nc)

    return jax.vmap(per_job)(r0s, k0s, jrow_g, jcol_g)


def _sparse_tiers(F2: int):
    """Panel-width tiers (ascending), or None to let _route_tiers pick
    them ADAPTIVELY from the measured flag-count histogram (the
    default; see _choose_tiers).  Per-job sparse work is proportional
    to F (every F-shaped operand spans the full W), and at the showcase
    geometry the per-job flag counts are heavily skewed (mean 67, p99
    225 with F2=640), so running each job at the smallest sufficient F
    cuts pass B ~2-3x versus one maximal panel.  MPX_SPARSE_TIERS
    (comma-separated, e.g. "32,128,640") forces a fixed tier set for
    schedule experiments; MPX_SPARSE_ADAPTIVE=0 restores the legacy
    fixed {64, 256, F2} ladder.  Values are clamped to F2 and the
    largest tier is always F2 so routing semantics (overflow -> dense
    re-sweep) are unchanged."""
    env = os.environ.get("MPX_SPARSE_TIERS")
    if env:
        # clamp to [1, F2]: a zero/negative tier would build an empty or
        # negative-width panel downstream
        tiers = {min(int(t), F2) for t in env.split(",")
                 if t.strip() and int(t) >= 1}
        tiers.add(F2)
        return sorted(tiers)
    if os.environ.get("MPX_SPARSE_ADAPTIVE", "1") == "0":
        return sorted({min(64, F2), min(256, F2), F2})
    return None


# Fixed rung values for adaptive tier selection: a run picks a SUBSET,
# so the compiled-executable universe stays bounded (each (F, chunk)
# scan variant is jitted once and persists in the compile cache)
# while the subset adapts to the run's measured flag-count histogram.
_TIER_LADDER = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _choose_tiers(counts: np.ndarray, F2: int, S: int, W: int,
                  max_tiers: int = 5) -> list:
    """Work-minimizing tier subset of _TIER_LADDER (+F2) for the exact
    per-job flag counts.  A job assigned to tier F costs F*W of
    F-shaped sparse work (panel compaction, the (F, W) products and
    suspect reduces), and padded scan-chunk slots cost the same as real
    jobs, so the objective is sum over tiers of
    (padded population) * F, plus a small per-tier constant (64*F)
    covering the extra executable + dispatch chain.  Exhaustive search:
    the ladder has <= 11 rungs below F2 and subsets are capped at
    max_tiers, so <= ~400 candidate evaluations against the sorted
    count histogram."""
    counts = np.asarray(counts)
    counts = counts[(counts >= 0) & (counts <= F2)]
    if counts.size == 0:
        return [F2]
    cmin = int(counts.min())
    lower = [f for f in _TIER_LADDER if cmin <= f < F2]
    srt = np.sort(counts)
    best, best_cost = [F2], None
    for k in range(0, min(max_tiers - 1, len(lower)) + 1):
        for sub in itertools.combinations(lower, k):
            T = list(sub) + [F2]
            edges = np.searchsorted(srt, T, side="right")
            pops = np.diff(np.concatenate([[0], edges]))
            cost = 0
            for F, p in zip(T, pops):
                if p == 0:
                    continue
                padded = sum(
                    (sl.stop - sl.start) + pad
                    for sl, pad in _tier_chunks(int(p), F, S, W)
                )
                cost += (padded + 64) * F
            if best_cost is None or cost < best_cost:
                best, best_cost = T, cost
    return best


def _route_tiers(cap_groups, thr, thr_col, tiers, *, S, W, tag, F2=None):
    """Host tier assignment from exact per-job flag counts (computed on
    device with the same comparisons the sparse kernels perform, so a
    tier's panel budget can never overflow).  ``tiers=None`` picks the
    tier set adaptively from the fetched counts (_choose_tiers; ``F2``
    required).  Returns (tiers, tier_sel: F -> [(group_idx, job_idx)],
    over_jobs: [(r0s, k0s)])."""
    # Dispatch every group's count kernel first, then fetch them all in
    # ONE device_get: per-group fetches would each wait behind the
    # pass-A work still on the device queue.
    counts = jax.device_get([
        _flag_counts(thr, thr_col, gr, gk, jrow, jcol, S=S, W=W)
        for gr, gk, jrow, jcol in cap_groups
    ])
    if tiers is None:
        allc = (np.concatenate([np.asarray(c) for c in counts])
                if counts else np.empty(0, np.int32))
        tiers = _choose_tiers(allc, F2, S, W)
        Logger.verbose_log(f"hybrid {tag}: adaptive tiers {tiers}")
    over_jobs = []
    tier_sel = {F: [] for F in tiers}
    for gi, cnts in enumerate(counts):
        assigned = np.zeros(cnts.shape[0], bool)
        for F in tiers:
            sel = ~assigned & (cnts <= F)
            if sel.any():
                tier_sel[F].append((gi, np.nonzero(sel)[0].astype(np.int32)))
                assigned |= sel
        rest = np.nonzero(~assigned)[0]
        if rest.size:
            gr_h, gk_h = np.asarray(cap_groups[gi][0]), np.asarray(cap_groups[gi][1])
            over_jobs.append((gr_h[rest], gk_h[rest]))
    pops = {F: sum(idx.size for _, idx in tier_sel[F]) for F in tiers}
    Logger.verbose_log(
        f"hybrid {tag} tiers: "
        + ", ".join(f"F={F}: {pops[F]} jobs" for F in tiers)
        + f", dense: {sum(r.size for r, _ in over_jobs)} jobs"
    )
    return tiers, tier_sel, over_jobs


def _tier_batches(cap_groups, tier_sel_f, F, *, S, W, w):
    """Yield padded (r0s, k0s, jrow, jcol) scan batches
    for one tier's job selection.  Dummy pad jobs start at row w (their
    threshold slice is the +inf pad tail: no flags, every pair fails
    the bounds mask — init no-ops)."""
    take = lambda field, gi, idx: jnp.take(
        cap_groups[gi][field], jnp.asarray(idx), axis=0
    )
    cat = lambda field: jnp.concatenate(
        [take(field, gi, idx) for gi, idx in tier_sel_f]
    )
    gr_t, gk_t, jrow_t, jcol_t = cat(0), cat(1), cat(2), cat(3)
    for sl, pad in _tier_chunks(int(gr_t.shape[0]), F, S, W):
        args = (gr_t[sl], gk_t[sl], jrow_t[sl], jcol_t[sl])
        if pad:
            args = (
                jnp.concatenate([args[0], jnp.full((pad,), w, jnp.int32)]),
                jnp.concatenate([args[1], jnp.zeros((pad,), jnp.int32)]),
                jnp.concatenate([args[2], jnp.zeros((pad, S), jnp.uint16)]),
                jnp.concatenate([args[3], jnp.zeros((pad, W), jnp.uint16)]),
            )
        yield args


def _sparse_merge_factor(S, W, w, wc, stats_c, ckpt) -> int:
    """Pass-B job-pair merging factor (1 = off, 2 = pair k0-adjacent
    jobs into width-2W jobs).  DEFAULT OFF: on an earlier accelerator
    merging doubled pass B at the showcase — the per-job cost that is
    insensitive to the flag count F is NOT
    fixed w.r.t. W (the flag cumsum, the (W, F) compaction one-hot and
    the (F, W) suspect reduce all scale with W), so width-2W jobs pay
    ~2x per job while only halving the job count, and the ~2x flag
    counts push jobs into larger F tiers on top.  Kept as an
    experiment knob (MPX_SPARSE_MERGE=2): on hardware with a higher
    per-dispatch-step overhead to compute-throughput ratio the
    trade-off could flip.  Never merges for AB-joins (per-side thr/cap
    geometry) or under checkpointing (job identity keys the
    done-mask)."""
    env = os.environ.get("MPX_SPARSE_MERGE")
    if env is None:
        return 1
    if ckpt is not None or stats_c is not None or wc is not None:
        return 1
    return max(1, min(2, int(env)))


def _merge_cap_groups(cap_groups, *, S, W, w):
    """Pair pass-A captures of k0-adjacent jobs (same r0, k0 and k0+W)
    into width-2W merged jobs.  The merged captures stay a SOUND flag
    oracle: the merged per-row maximum is the elementwise max of the
    halves (a row's 2W-job max IS the max of its two W-job maxima, and
    the u16 round-up encoding is order-independent), and the column
    maxima concatenate positionally.  Returns (merged, rest) in the
    cap_groups format — merged entries carry (G, 2W) jcol panels and
    keep the LEFT half's (r0, k0) as the job identity."""
    entries = {}
    order = []
    for gi, (gr, gk, _, _) in enumerate(cap_groups):
        gr_h, gk_h = np.asarray(gr), np.asarray(gk)
        for ji in range(gr_h.shape[0]):
            r0, k0 = int(gr_h[ji]), int(gk_h[ji])
            if r0 >= w:  # group-pad dummy job: no flags, skip entirely
                continue
            entries[(r0, k0)] = (gi, ji)
            order.append((r0, k0))
    pairs, rest = [], []
    for r0, k0 in order:
        if (k0 // W) % 2 == 1:
            if (r0, k0 - W) not in entries:
                rest.append((r0, k0))
            continue
        if (r0, k0 + W) in entries:
            pairs.append((r0, k0))
        else:
            rest.append((r0, k0))
    if not pairs:
        return [], cap_groups

    # Flat (global-job-index) device views of the captures.
    jrow_all = jnp.concatenate([g[2] for g in cap_groups], axis=0)
    jcol_all = jnp.concatenate([g[3] for g in cap_groups], axis=0)
    offs = np.cumsum([0] + [np.asarray(g[0]).shape[0] for g in cap_groups])
    flat = lambda gj: offs[gj[0]] + gj[1]

    ia = jnp.asarray([flat(entries[(r0, k0)]) for r0, k0 in pairs],
                     dtype=jnp.int32)
    ib = jnp.asarray([flat(entries[(r0, k0 + W)]) for r0, k0 in pairs],
                     dtype=jnp.int32)
    jrow_m = jnp.maximum(jnp.take(jrow_all, ia, axis=0),
                         jnp.take(jrow_all, ib, axis=0))
    jcol_m = jnp.concatenate(
        [jnp.take(jcol_all, ia, axis=0), jnp.take(jcol_all, ib, axis=0)],
        axis=1,
    )
    r0m = np.asarray([p[0] for p in pairs], np.int32)
    k0m = np.asarray([p[1] for p in pairs], np.int32)
    merged = [(jnp.asarray(r0m), jnp.asarray(k0m), jrow_m, jcol_m)]

    rest_groups = []
    if rest:
        ir = jnp.asarray([flat(entries[rk]) for rk in rest], dtype=jnp.int32)
        rest_groups = [(
            jnp.asarray(np.asarray([rk[0] for rk in rest], np.int32)),
            jnp.asarray(np.asarray([rk[1] for rk in rest], np.int32)),
            jnp.take(jrow_all, ir, axis=0),
            jnp.take(jcol_all, ir, axis=0),
        )]
    return merged, rest_groups


def _pad_axis0(x, extra: int, fill=0.0):
    pad = [(0, extra)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad, constant_values=fill)


def run_suspect_jobs_sparse(stats, thr, cap_groups, *, S, W, m, w, tr, tc,
                            wc=None, excl=None, stats_c=None, thr_col=None,
                            combine=True, profile=None, ckpt=None):
    """Sparse pass B: consume pass A's per-job maxima to skip all
    unflagged rows/columns.  Jobs are routed to the smallest panel tier
    that fits their exact flag count; jobs exceeding the largest tier
    go straight to the dense re-sweep.  Same output contract as
    run_suspect_jobs.

    Self-join jobs can optionally be PAIRED into width-2W merged jobs
    (_merge_cap_groups) via MPX_SPARSE_MERGE=2 — an opt-in experiment,
    OFF by default (the F-insensitive per-job cost scales with W), see
    _sparse_merge_factor for the trade-off.

    ``ckpt`` persists the partial suspect state + job done-mask after
    every batch.  Jobs whose pass-A captures predate a resume
    (ckpt.uncaptured) join the dense re-sweep; sparse-overflow jobs
    stay pending in the mask until their dense re-sweep lands."""
    merge = _sparse_merge_factor(S, W, w, wc, stats_c, ckpt)
    Lr = w + S
    Lc = (w if wc is None else wc) + W * merge
    rows_g, cols_g = _init_suspects(Lr), _init_suspects(Lc)
    thr_c_arr = thr if thr_col is None else thr_col

    # (W_eff, groups, stats_col, thr_col_eff, expand_overflow)
    classes = []
    if merge == 2:
        merged, rest = _merge_cap_groups(cap_groups, S=S, W=W, w=w)
        if merged:
            # Width-2W column slices outrun the (w + S + W) statistics
            # padding by W - S rows; extend the column-side operands and
            # thresholds (+inf: padded rows never flag).
            stats_pad = stats._replace(
                T=_pad_axis0(stats.T, W),
                mu=_pad_axis0(stats.mu, W),
                inv=_pad_axis0(stats.inv, W, fill=np.inf),
                windows=(None if stats.windows is None
                         else _pad_axis0(stats.windows, W)),
            )
            thr_pad = _pad_axis0(thr_c_arr, W, fill=np.inf)
            classes.append((2 * W, merged, stats_pad, thr_pad, True))
        if rest:
            classes.append((W, rest, stats_c, thr_col, False))
    else:
        classes.append((W, cap_groups, stats_c, thr_col, False))

    over_jobs = []
    if ckpt is not None:
        for gr, gk in ckpt.uncaptured:
            gr, gk = np.asarray(gr), np.asarray(gk)
            real = gr < w  # drop group-pad dummy jobs
            if real.any():
                over_jobs.append((gr[real], gk[real]))

    for W_eff, groups, st_c_eff, thr_col_eff, expand in classes:
        F2 = _sparse_budget(S, W_eff)
        tiers = _sparse_tiers(F2)
        thr_c_eff = thr_c_arr if thr_col_eff is None else thr_col_eff
        tiers, tier_sel, over = _route_tiers(
            groups, thr, thr_c_eff, tiers, S=S, W=W_eff,
            tag=f"sparse pass B (W={W_eff})", F2=F2,
        )
        for gr_o, gk_o in over:
            if expand:
                over_jobs.append((np.concatenate([gr_o, gr_o]),
                                  np.concatenate([gk_o, gk_o + W])))
            else:
                over_jobs.append((gr_o, gk_o))
        for F in tiers:
            if not tier_sel[F]:
                continue
            for args in _tier_batches(groups, tier_sel[F], F,
                                      S=S, W=W_eff, w=w):
                rows_g, cols_g, overs = _sparse_suspect_group(
                    stats, thr, *args, rows_g, cols_g,
                    S=S, W=W_eff, m=m, w=w, tr=tr, tc=tc, F=F,
                    wc=wc, excl=excl, stats_c=st_c_eff,
                    thr_col=thr_col_eff,
                    prec=HYBRID_PRECISION,
                )
                # Routing by exact flag counts means a tier batch can
                # never overflow (see _route_tiers); ``overs`` is only
                # fetched under checkpointing, where it gates the
                # done-mask.  An unconditional fetch would add a device
                # sync per batch.
                if ckpt is not None:
                    ckpt.mark_done_and_save(
                        rows_g, cols_g, args[0], args[1],
                        keep=~np.asarray(overs),
                    )

    if over_jobs:
        ro = np.concatenate([r for r, _ in over_jobs])
        ko = np.concatenate([k for _, k in over_jobs])
        Logger.verbose_log(
            f"hybrid sparse pass B: {ro.shape[0]} job(s) to the dense "
            "re-sweep (flag-budget overflow or lost captures)"
        )
        with _phase(profile, "2. Compute [mxu f32 pass B dense overflow]"):
            for gr, gk in _job_groups(ro, ko, w, ckpt):
                rows_g, cols_g = _suspect_jobs_group(
                    stats, thr, jnp.asarray(gr), jnp.asarray(gk),
                    rows_g, cols_g,
                    S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
                    stats_c=stats_c, thr_col=thr_col, prec=HYBRID_PRECISION,
                )
                if ckpt is not None:
                    ckpt.mark_done_and_save(rows_g, cols_g, gr, gk)

    if combine:
        return _fold_suspects(rows_g, cols_g, w=w)
    return rows_g, cols_g


@partial(jax.jit,
         static_argnames=("S", "W", "m", "w", "tr", "tc", "wc", "excl",
                          "capture", "prec"))
def _max_jobs_group(stats, r0s, k0s, rmax, cmax, *, S, W, m, w, tr, tc,
                    wc=None, excl=None, stats_c=None, capture=False,
                    prec=None):
    """One dispatch group of the pass-A value-only max sweep, merging
    into carried (rmax, cmax) arrays (associative: groups in any order).

    ``capture=True`` additionally stacks each job's raw per-row / per-col
    maxima — the sparse pass B's skip oracle (a row whose job maximum
    misses the threshold provably holds no suspect in that job)."""
    from mpx.kernels.mxu import sweep_band_max

    geom = band_geometry(S, W, m, w, tr, tc, wc=wc, excl=excl)

    def body(carry, job):
        rmax, cmax = carry
        r0, k0 = job
        rv, cv = sweep_band_max(stats, r0, k0, geom, jnp.float32, stats_c,
                                precision=_prec(prec))
        rmax = jax.lax.dynamic_update_slice(
            rmax, jnp.maximum(jax.lax.dynamic_slice(rmax, (r0,), (S,)), rv), (r0,)
        )
        c0 = r0 + k0
        cmax = jax.lax.dynamic_update_slice(
            cmax, jnp.maximum(jax.lax.dynamic_slice(cmax, (c0,), (W,)), cv), (c0,)
        )
        ys = (_encode_max_u16(rv), _encode_max_u16(cv)) if capture else None
        return (rmax, cmax), ys

    carry, ys = jax.lax.scan(body, (rmax, cmax), (r0s, k0s))
    if capture:
        return carry, ys
    return carry


@partial(jax.jit, static_argnames=("w", "pw", "wc", "pwc", "combine"))
def _build_thr(rmax, cmax, margin, *, w, pw, wc=None, pwc=None, combine=True):
    """Fold pass-A maxima into suspect thresholds (pad tail = +inf).

    Rows with no valid pair at all (degenerate windows, or empty AB
    sides) keep the aggregate init as their max; their threshold is
    +inf so they never flag (init - 2*margin would flag them in every
    job — pure wasted panel slots)."""
    two_eps = jnp.float32(2.0) * margin.astype(jnp.float32)
    init = jnp.float32(AGGREGATE_INIT)

    def fold(gmax, width, padded):
        thr = jnp.where(gmax[:width] > init, gmax[:width] - two_eps, jnp.inf)
        full = jnp.full((padded,), jnp.inf, jnp.float32)
        return jax.lax.dynamic_update_slice(full, thr, (0,))

    if combine:
        return fold(jnp.maximum(rmax[:w], cmax[:w]), w, pw)
    return fold(rmax, w, pw), fold(cmax, wc, pwc)


# Upper bound on |P(bf16 operands) - P(HYBRID_PRECISION)| for unit-
# normalized window dots: operand bf16 rounding gives ~2*2^-8 worst
# case; the default carries ~4x headroom over the measured maximum.
# Overridable for experiments (the cascade stays CORRECT for any true
# bound <= this value — a too-small value is unsound, a larger one
# only widens the refine band).
BF16_SWEEP_BOUND = float(os.environ.get("MPX_BF16_SWEEP_BOUND", 0.02))


def _cascade_enabled(stats) -> bool:
    """Opt-in (MPX_HYBRID_CASCADE=1).  The bf16 A1 sweep is cheap, but
    the refine-flag density near each row's max is high on smooth data
    (about 10x pass B's flags per job at a sound bound), so A2 can cost
    more than it saves.  Kept as an option: on data whose near-max
    density is low (sharp, noisy series) or hardware with a wide
    bf16:fp32 matmul ratio (the GPU's is about 15:1) the cascade may
    win; the machinery is exact either way.  Not yet measured on the
    GPU (ROADMAP design debt 5)."""
    env = os.environ.get("MPX_HYBRID_CASCADE", "0")
    return env == "1" and stats.windows is not None


@partial(jax.jit,
         static_argnames=("S", "W", "m", "w", "tr", "tc", "wc", "excl", "F",
                          "prec"))
def _refine_group(stats, gthr, r0s, k0s, jrow_g, jcol_g, rmax, cmax, *,
                  S, W, m, w, tr, tc, F, wc=None, excl=None, stats_c=None,
                  gthr_col=None, prec=None):
    """One dispatch group of the cascade refine stage (A2): each job
    recomputes, at full precision, the per-job maxima of ONLY the
    rows/columns whose bf16 (A1) maxima reach the refine threshold,
    merges them into the exact global (rmax, cmax) carries, and emits
    the refined per-job maxima (u16) — the sparse pass-B skip oracle.
    Jobs whose flag count exceeds F contribute nothing and are reported
    in the overflow mask for a dense re-sweep."""
    from mpx.kernels.mxu import sweep_band_refine_sparse

    geom = band_geometry(S, W, m, w, tr, tc, wc=wc, excl=excl)
    init = jnp.float32(AGGREGATE_INIT)

    def body(carry, job):
        rmax, cmax = carry
        r0, k0, jrow, jcol = job
        rv, cv, over = sweep_band_refine_sparse(
            stats, r0, k0, jrow, jcol, geom, gthr, F, stats_c, gthr_col,
            precision=_prec(prec),
        )
        rv = jnp.where(over, init, rv)
        cv = jnp.where(over, init, cv)
        rmax = jax.lax.dynamic_update_slice(
            rmax, jnp.maximum(jax.lax.dynamic_slice(rmax, (r0,), (S,)), rv), (r0,)
        )
        c0 = r0 + k0
        cmax = jax.lax.dynamic_update_slice(
            cmax, jnp.maximum(jax.lax.dynamic_slice(cmax, (c0,), (W,)), cv), (c0,)
        )
        return (rmax, cmax), (_encode_max_u16(rv), _encode_max_u16(cv), over)

    (rmax, cmax), (jr2, jc2, overs) = jax.lax.scan(
        body, (rmax, cmax), (r0s, k0s, jrow_g, jcol_g)
    )
    return rmax, cmax, jr2, jc2, overs


def _job_groups(r0s, k0s, w, ckpt=None):
    """Split a pass's job list into dispatch groups.  Only checkpointed
    runs group (``ckpt.group_jobs`` jobs per group, the unit of work
    that is persisted); every other run sweeps all jobs in one
    dispatch."""
    njobs = r0s.shape[0]
    group = ckpt.group_jobs if ckpt is not None else 0
    if not group or njobs <= group:
        return [(r0s, k0s)]
    # Balance group sizes (padding straight to a group multiple can
    # waste most of a group of dummy compute), then pad the ceil-split
    # remainder with dummy jobs whose rows start at w: every pair fails
    # the bounds mask, so their merges are init no-ops.
    ngroups = -(-njobs // group)
    group = -(-njobs // ngroups)
    group = ((group + 63) // 64) * 64  # shape-bucket the size
    pad = (-njobs) % group
    if pad:
        r0s = np.concatenate([r0s, np.full(pad, w, np.int32)])
        k0s = np.concatenate([k0s, np.zeros(pad, np.int32)])
    return [
        (r0s[o : o + group], k0s[o : o + group])
        for o in range(0, njobs + pad, group)
    ]


# Jobs per sparse-tier scan chunk (a power of two: full chunks pad-free).
# It bounds the concatenated (jobs, S + W) captures one dispatch reads.
_TIER_CHUNK_JOBS = 1 << 16


def _tier_chunks(njobs: int, F: int, S: int, W: int) -> list:
    """Split a sparse tier's job list into scan chunks of at most
    _TIER_CHUNK_JOBS jobs as (slice, pad) pairs, each padded to a
    power-of-two length (>= 64) so the number of compiled (length, F)
    scan variants stays logarithmic in the job count instead of one per
    distinct tier population."""
    cap = _TIER_CHUNK_JOBS
    chunks = []
    o = 0
    while o < njobs:
        size = min(njobs - o, cap)
        nb = 64
        while nb < size:
            nb *= 2
        chunks.append((slice(o, o + size), nb - size))
        o += size
    return chunks


def _run_max_jobs_cascade(stats, r0s, k0s, margin, *, S, W, m, w, tr, tc, pw,
                          wc=None, excl=None, pwc=None, stats_c=None,
                          combine=True):
    """Cascade pass A: (A1) one sweep with bf16 operands (f32
    accumulation) captures approximate per-job maxima; (A2)
    only the (row, job) pairs whose approximate maximum lands within
    2*BF16_SWEEP_BOUND + 2*margin of the row's approximate global max
    are re-swept at HYBRID_PRECISION (tiered skinny panels) — any other
    pair provably holds neither the true max nor any suspect:
    M <= M~ + B < g~ - B - 2*margin <= g - 2*margin = thr.  Returns the
    plain capture path's (thr, cap_groups) contract with exact
    thresholds and refined captures (unrefined slots decode to -1 and
    never flag in pass B)."""
    B = jnp.float32(BF16_SWEEP_BOUND)
    r0s = np.asarray(r0s, np.int32)
    k0s = np.asarray(k0s, np.int32)
    Lr = w + S
    Lc = (w if wc is None else wc) + W
    neg = jnp.float32(AGGREGATE_INIT)

    # A1: bf16 approximate sweep with capture.
    rmax_a = jnp.full((Lr,), neg, jnp.float32)
    cmax_a = jnp.full((Lc,), neg, jnp.float32)
    gr_d, gk_d = jnp.asarray(r0s), jnp.asarray(k0s)
    (rmax_a, cmax_a), (jrow, jcol) = _max_jobs_group(
        stats, gr_d, gk_d, rmax_a, cmax_a,
        S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
        stats_c=stats_c, capture=True, prec="BF16_BF16_F32",
    )
    cap1 = [(gr_d, gk_d, jrow, jcol)]

    # Refine thresholds: approximate global max minus (2B + 2*margin).
    gthr = _build_thr(rmax_a, cmax_a, margin + B, w=w, pw=pw,
                      wc=wc, pwc=pwc, combine=combine)
    gthr_r, gthr_c = (gthr, None) if combine else gthr

    # A2: tiered sparse exact refine.
    F2 = _sparse_budget(S, W)
    tiers = _sparse_tiers(F2)
    tiers, tier_sel, over_jobs = _route_tiers(
        cap1, gthr_r, gthr_r if gthr_c is None else gthr_c, tiers,
        S=S, W=W, tag="cascade refine A2", F2=F2,
    )
    rmax = jnp.full((Lr,), neg, jnp.float32)
    cmax = jnp.full((Lc,), neg, jnp.float32)
    cap2 = []
    for F in tiers:
        if not tier_sel[F]:
            continue
        for args in _tier_batches(cap1, tier_sel[F], F, S=S, W=W, w=w):
            rmax, cmax, jr2, jc2, overs = _refine_group(
                stats, gthr_r, *args, rmax, cmax,
                S=S, W=W, m=m, w=w, tr=tr, tc=tc, F=F,
                wc=wc, excl=excl, stats_c=stats_c, gthr_col=gthr_c,
                prec=HYBRID_PRECISION,
            )
            # Overflowed jobs' contributions were zeroed in-kernel; the
            # zeroed capture rows stay in cap2 (they flag nothing) and
            # the jobs re-run densely below.
            cap2.append((args[0], args[1], jr2, jc2))
            overs = np.asarray(overs)
            if overs.any():
                over_jobs.append(
                    (np.asarray(args[0])[overs], np.asarray(args[1])[overs])
                )
    if over_jobs:
        ro = np.concatenate([r for r, _ in over_jobs])
        ko = np.concatenate([k for _, k in over_jobs])
        Logger.verbose_log(
            f"cascade refine A2: {ro.shape[0]} job(s) to the dense sweep"
        )
        gr_d, gk_d = jnp.asarray(ro), jnp.asarray(ko)
        (rmax, cmax), (jrow, jcol) = _max_jobs_group(
            stats, gr_d, gk_d, rmax, cmax,
            S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
            stats_c=stats_c, capture=True, prec=HYBRID_PRECISION,
        )
        cap2.append((gr_d, gk_d, jrow, jcol))
    thr = _build_thr(rmax, cmax, margin, w=w, pw=pw, wc=wc, pwc=pwc,
                     combine=combine)
    return thr, cap2


# Below this profile width the whole device side of a hybrid self-join
# (pass A value sweep -> threshold -> dense pass B capture -> fold) runs
# as ONE jitted dispatch with ONE packed fetch: at small n the sparse
# machinery saves nothing (the dense re-sweep is another cheap full
# sweep) while the staged passes cost several host round trips.  Not
# yet tuned on the GPU.
HYBRID_SMALL_FUSED_W = 1 << 16


@partial(jax.jit,
         static_argnames=("S", "W", "m", "w", "tr", "tc", "pw", "prec"))
def _hybrid_small_fused(stats, r0s, k0s, margin, *, S, W, m, w, tr, tc,
                        pw, prec=None):
    """One-dispatch small-n hybrid device chain.  Returns (packed (w,
    1+2K) int32 suspect summary, device thr) — thr stays on device for
    a potential pass C; only the packed summary is fetched."""
    Lr, Lc = w + S, w + W
    neg = jnp.float32(AGGREGATE_INIT)
    rmax = jnp.full((Lr,), neg, jnp.float32)
    cmax = jnp.full((Lc,), neg, jnp.float32)
    rmax, cmax = _max_jobs_group(
        stats, r0s, k0s, rmax, cmax,
        S=S, W=W, m=m, w=w, tr=tr, tc=tc, prec=prec,
    )
    thr = _build_thr(rmax, cmax, margin, w=w, pw=pw)
    rows_g, cols_g = _init_suspects(Lr), _init_suspects(Lc)
    rows_g, cols_g = _suspect_jobs_group(
        stats, thr, r0s, k0s, rows_g, cols_g,
        S=S, W=W, m=m, w=w, tr=tr, tc=tc, prec=prec,
    )
    sus = _fold_suspects(rows_g, cols_g, w=w)
    packed = jnp.concatenate([sus.cnt[:, None], sus.mn, sus.mx], axis=1)
    return packed, thr


@partial(jax.jit,
         static_argnames=("S", "W", "m", "w", "tr", "tc", "pw",
                          "wc", "pwc", "excl", "prec"))
def _hybrid_small_fused_two(stats, r0s, k0s, margin, *, S, W, m, w, tr, tc,
                            pw, wc=None, pwc=None, excl=None,
                            stats_c=None, prec=None):
    """Two-sided variant of _hybrid_small_fused (left/right profiles
    and AB-joins — combine=False semantics): one dispatch producing both
    sides' packed suspect summaries plus the device-resident per-side
    thresholds.  The two packed blocks are returned separately (their
    widths differ for AB)."""
    wc_ = w if wc is None else wc
    pwc_ = pw if pwc is None else pwc
    Lr, Lc = w + S, wc_ + W
    neg = jnp.float32(AGGREGATE_INIT)
    rmax = jnp.full((Lr,), neg, jnp.float32)
    cmax = jnp.full((Lc,), neg, jnp.float32)
    rmax, cmax = _max_jobs_group(
        stats, r0s, k0s, rmax, cmax,
        S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
        stats_c=stats_c, prec=prec,
    )
    thr_r, thr_c = _build_thr(rmax, cmax, margin, w=w, pw=pw,
                              wc=wc_, pwc=pwc_, combine=False)
    rows_g, cols_g = _init_suspects(Lr), _init_suspects(Lc)
    rows_g, cols_g = _suspect_jobs_group(
        stats, thr_r, r0s, k0s, rows_g, cols_g,
        S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
        stats_c=stats_c, thr_col=thr_c, prec=prec,
    )
    pk = lambda s, width: jnp.concatenate(
        [s.cnt[:width, None], s.mn[:width], s.mx[:width]], axis=1
    )
    if wc_ == w:
        # equal-width sides (left/right): one stacked fetch
        return jnp.stack([pk(rows_g, w), pk(cols_g, wc_)]), thr_r, thr_c
    return (pk(rows_g, w), pk(cols_g, wc_)), thr_r, thr_c


def run_max_jobs(stats, r0s, k0s, margin, *, S, W, m, w, tr, tc, pw,
                 wc=None, excl=None, pwc=None, stats_c=None, combine=True,
                 capture=False, ckpt=None):
    """Pass A: value-only max sweep over all jobs (in checkpoint-sized
    groups under ``ckpt``), folded into the suspect threshold(s).

    combine=True (self-join): one thr array over the shared subsequence
    axis.  combine=False (AB-join): separate (thr_rows, thr_cols) over
    the query/target axes, with stats_c/wc/excl carrying the AB geometry.

    capture=True additionally returns the per-job maxima groups
    [(r0s, k0s, jobrow (G,S), jobcol (G,W)), ...] (device-resident) for
    the sparse pass B.  With MPX_HYBRID_CASCADE=1 this runs the bf16
    cascade instead (see _run_max_jobs_cascade / _cascade_enabled); the
    thresholds and captured maxima are exact either way.

    ``ckpt`` (mpx.checkpoint.HybridCheckpoint, self-join only) persists
    (rmax, cmax, next_group) after every group and resumes mid-pass;
    groups completed before a crash lose their device captures, so they
    are recorded on ``ckpt.uncaptured`` for a dense pass-B sweep (the
    cascade is bypassed under ckpt: its tier batches have no stable
    group order to resume)."""
    if capture and _cascade_enabled(stats) and ckpt is None:
        return _run_max_jobs_cascade(
            stats, r0s, k0s, margin, S=S, W=W, m=m, w=w, tr=tr, tc=tc,
            pw=pw, wc=wc, excl=excl, pwc=pwc, stats_c=stats_c,
            combine=combine,
        )
    r0s = np.asarray(r0s, np.int32)
    k0s = np.asarray(k0s, np.int32)
    Lr = w + S
    Lc = (w if wc is None else wc) + W
    neg = jnp.float32(AGGREGATE_INIT)
    rmax = jnp.full((Lr,), neg, jnp.float32)
    cmax = jnp.full((Lc,), neg, jnp.float32)
    cap_groups = []
    groups = _job_groups(r0s, k0s, w, ckpt)
    start = 0
    if ckpt is not None:
        st = ckpt.load_a()
        if st is not None:
            rmax = jnp.asarray(st[0])
            cmax = jnp.asarray(st[1])
            start = st[2]
            ckpt.uncaptured = groups[:start]
            Logger.info(
                f"hybrid pass A: resuming at group {start}/{len(groups)}"
            )
    for gi in range(start, len(groups)):
        gr, gk = groups[gi]
        gr_d, gk_d = jnp.asarray(gr), jnp.asarray(gk)
        out = _max_jobs_group(
            stats, gr_d, gk_d, rmax, cmax,
            S=S, W=W, m=m, w=w, tr=tr, tc=tc, wc=wc, excl=excl,
            stats_c=stats_c, capture=capture, prec=HYBRID_PRECISION,
        )
        if capture:
            (rmax, cmax), (jrow, jcol) = out
            cap_groups.append((gr_d, gk_d, jrow, jcol))
        else:
            rmax, cmax = out
        if ckpt is not None:
            ckpt.save_a(rmax, cmax, gi + 1)
    thr = _build_thr(
        rmax, cmax, margin, w=w, pw=pw,
        wc=wc, pwc=pwc, combine=combine,
    )
    if capture:
        return thr, cap_groups
    return thr


@partial(jax.jit, static_argnames=("m", "w", "excl", "K", "CW", "side"))
def scan_flagged_rows(stats, thr, flag_idx, *, m, w, excl, K, CW,
                      stats_t=None, side=0, Uf=None, fin_f=None,
                      thr_f=None, col_offset=0):
    """Pass C: exact suspect extraction for overflow rows, on the device.

    For each flagged subsequence, recompute its full correlation row
    blockwise (CW columns at a time, both sides of the join), keep the
    top-K entries by a streaming top-k merge, and count every entry
    reaching thr.  count <= K proves the top-K contains ALL suspects.
    flag_idx is padded with out-of-range rows (thr = +inf there).

    ``stats_t`` selects a different target series (AB-joins; pass
    excl=-1 to disable the trivial-match zone); ``w`` is the TARGET
    profile width.  ``side`` restricts neighbors for the left/right
    profiles: +1 keeps only later targets (c - r >= excl), -1 only
    earlier ones (r - c >= excl), 0 both.

    The sharded-inputs ring tier scans one SHARD of the column axis per
    device: it passes the flagged operands explicitly (``Uf`` (F, m)
    unit windows, ``fin_f``, ``thr_f`` — no device holds the full query
    axis) and ``col_offset``, the global coordinate of the local shard's
    first column (flag_idx stays GLOBAL, for the trivial-match zone)."""
    if stats_t is None:
        stats_t = stats
    F = flag_idx.shape[0]
    if Uf is None:
        inv_f = stats.inv[flag_idx]
        fin_f = jnp.isfinite(inv_f)
        if stats.windows is not None:
            Uf = stats.windows[flag_idx]
        else:
            j = jnp.arange(m, dtype=jnp.int32)
            Wf = stats.T[flag_idx[:, None] + j[None, :]]
            Uf = (Wf - stats.mu[flag_idx][:, None]) * jnp.where(
                fin_f, inv_f, 0
            )[:, None]
    if thr_f is None:
        thr_f = thr[flag_idx]

    pw = stats_t.mu.shape[0]
    nchunks = pw // CW
    neg = jnp.float32(AGGREGATE_INIT)

    def body(carry, ci):
        bv, bi, cnt = carry
        c0 = ci * CW
        zero = np.int32(0)
        if stats_t.windows is not None:
            Uc = jax.lax.dynamic_slice(stats_t.windows, (c0, zero), (CW, m))
        else:
            Tc = jax.lax.dynamic_slice(stats_t.T, (c0,), (CW + m - 1,))
            mu_c = jax.lax.dynamic_slice(stats_t.mu, (c0,), (CW,))
            inv_c = jax.lax.dynamic_slice(stats_t.inv, (c0,), (CW,))
            finc = jnp.isfinite(inv_c)
            cols_ = jnp.stack([Tc[t : t + CW] for t in range(m)], axis=1)
            Uc = (cols_ - mu_c[:, None]) * jnp.where(finc, inv_c, 0)[:, None]
        inv_c = jax.lax.dynamic_slice(stats_t.inv, (c0,), (CW,))
        fin_c = jnp.isfinite(inv_c)
        P = jax.lax.dot_general(
            Uf, Uc, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=_prec(HYBRID_PRECISION),
        )
        cols = col_offset + c0 + jnp.arange(CW, dtype=jnp.int32)[None, :]
        delta = cols - flag_idx[:, None]
        if side > 0:
            zone = delta >= excl
        elif side < 0:
            zone = -delta >= excl
        else:
            zone = jnp.abs(delta) >= excl
        valid = (
            zone
            & (cols <= w - 1)
            & fin_c[None, :]
            & fin_f[:, None]
        )
        Pm = jnp.where(valid, P, neg)
        cnt = cnt + jnp.sum(Pm >= thr_f[:, None], axis=1, dtype=jnp.int32)
        v, loc = jax.lax.top_k(Pm, K)
        idx = col_offset + c0 + loc.astype(jnp.int32)
        # streaming merge with the carry
        av = jnp.concatenate([bv, v], axis=1)
        ai = jnp.concatenate([bi, idx], axis=1)
        nv, sel = jax.lax.top_k(av, K)
        ni = jnp.take_along_axis(ai, sel, axis=1)
        return (nv, ni, cnt), None

    init = (
        jnp.full((F, K), neg, jnp.float32),
        jnp.full((F, K), -1, jnp.int32),
        jnp.zeros((F,), jnp.int32),
    )
    (bv, bi, cnt), _ = jax.lax.scan(body, init, jnp.arange(nchunks, dtype=jnp.int32))
    bi = jnp.where(bv > neg, bi, -1)
    return bv, bi, cnt


# ---------------------------------------------------------------------------
# Multi-chip pass A/B: jobs shard over a 1-D mesh (the MP_KERNEL_REPL
# analog, like mpx.parallel.sharding); per-device partial maxima /
# suspect summaries merge with the same associative operators across the
# device axis.  Pass C / rescoring remain single-device + host (they are
# O(flagged), not O(n^2)).


def _shard_jobs(grid, num_shards):
    from mpx.config import pad_job_grid

    # dummy rows start beyond every real subsequence: fully masked no-ops
    grid = pad_job_grid(grid, num_shards, dummy_r0=grid.r0.max() + 2**20)
    per_dev = grid.r0.shape[0] // num_shards
    order = np.arange(grid.r0.shape[0]).reshape(per_dev, num_shards).T.reshape(-1)
    r0s = jnp.asarray(grid.r0[order]).reshape(num_shards, per_dev)
    k0s = jnp.asarray(grid.k0[order]).reshape(num_shards, per_dev)
    return r0s, k0s


def _fold_device_axis(stacked: SuspectWindow) -> SuspectWindow:
    """Fold (ndev, L) suspect summaries over the device axis."""
    n = stacked.cnt.shape[0]
    acc = jax.tree.map(lambda a: a[0], stacked)
    for d in range(1, n):
        acc = _combine_suspects(acc, jax.tree.map(lambda a: a[d], stacked))
    return acc


def run_max_jobs_sharded(stats, grid, margin, *, num_shards, S, W, m, w,
                         tr, tc, pw, mesh=None):
    """Sharded pass A: each device max-sweeps its job subset; partials
    max-merge over the mesh into one replicated threshold array."""
    from jax.sharding import PartitionSpec as P

    from mpx.parallel.mesh import default_mesh

    if mesh is None:
        mesh = default_mesh(num_shards)
    r0s, k0s = _shard_jobs(grid, num_shards)
    Lr = w + S
    neg = jnp.float32(AGGREGATE_INIT)

    def local(st, r, k):
        rmax = jnp.full((Lr,), neg, jnp.float32)
        cmax = jnp.full((w + W,), neg, jnp.float32)
        rmax, cmax = _max_jobs_group(
            st, r[0], k[0], rmax, cmax, S=S, W=W, m=m, w=w, tr=tr, tc=tc,
            prec=HYBRID_PRECISION,
        )
        return rmax[None], cmax[None]

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("jobs"), P("jobs")),
        out_specs=P("jobs"),
        check_vma=False,
    )

    @partial(jax.jit, static_argnames=())
    def merged(st, r, k, mg):
        rmax, cmax = shard_fn(st, r, k)
        return _build_thr(
            jnp.max(rmax, axis=0), jnp.max(cmax, axis=0), mg, w=w, pw=pw
        )

    with mesh:
        return merged(stats, r0s, k0s, jnp.float32(margin))


def run_suspect_jobs_sharded(stats, thr, grid, *, num_shards, S, W, m, w,
                             tr, tc, mesh=None):
    """Sharded pass B: per-device suspect summaries folded over the
    device axis (sum counts, min/max capture), then the self-join's
    row/column sides folded per subsequence."""
    from jax.sharding import PartitionSpec as P

    from mpx.parallel.mesh import default_mesh

    if mesh is None:
        mesh = default_mesh(num_shards)
    r0s, k0s = _shard_jobs(grid, num_shards)
    Lr, Lc = w + S, w + W

    def local(st, t, r, k):
        rows_g, cols_g = _suspect_jobs_group(
            st, t, r[0], k[0], _init_suspects(Lr), _init_suspects(Lc),
            S=S, W=W, m=m, w=w, tr=tr, tc=tc, prec=HYBRID_PRECISION,
        )
        expand = lambda sw: jax.tree.map(lambda a: a[None], sw)
        return expand(rows_g), expand(cols_g)

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P("jobs"), P("jobs")),
        out_specs=P("jobs"),
        check_vma=False,
    )

    @jax.jit
    def merged(st, t, r, k):
        rows_s, cols_s = shard_fn(st, t, r, k)
        rows_g = _fold_device_axis(rows_s)
        cols_g = _fold_device_axis(cols_s)
        return _fold_suspects(rows_g, cols_g, w=w)

    with mesh:
        return merged(stats, thr, r0s, k0s)


# ---------------------------------------------------------------------------
# Host-side exact f64 stages (native C++ with numpy fallbacks)


def _rescore_pairs_ab(Tq, muq, invq, Tt, mut, invt, m, rows, cols) -> np.ndarray:
    """Exact f64 Pearson for (query rows[i], target cols[i]);
    cols[i] < 0 -> init."""
    from mpx import native

    if native.is_available():
        return native.rescore_ab(Tq, muq, invq, Tt, mut, invt, m, rows, cols)

    P = np.full(rows.shape[0], AGGREGATE_INIT, np.float64)
    ok = (cols >= 0) & np.isfinite(invt[np.maximum(cols, 0)]) & np.isfinite(
        invq[rows]
    )
    idx = np.nonzero(ok)[0]
    blk = 1 << 16
    winq = np.lib.stride_tricks.sliding_window_view(Tq, m)
    wint = np.lib.stride_tricks.sliding_window_view(Tt, m)
    for o in range(0, idx.shape[0], blk):
        sel = idx[o : o + blk]
        a, b = rows[sel], cols[sel]
        wa = winq[a] - muq[a][:, None]
        wb = wint[b] - mut[b][:, None]
        P[sel] = np.einsum("ij,ij->i", wa, wb) * invq[a] * invt[b]
    return P


def _rescore_pairs(T64, mu, inv, m, rows, cols) -> np.ndarray:
    """Exact f64 Pearson for (rows[i], cols[i]); cols[i] < 0 -> init."""
    return _rescore_pairs_ab(T64, mu, inv, T64, mu, inv, m, rows, cols)


def _row_scan(T64, mu, inv, m, w, excl, rows) -> tuple[np.ndarray, np.ndarray]:
    """Exact f64 best neighbor over ALL valid pairs of each given row."""
    from mpx import native

    if native.is_available():
        return native.row_scan(T64, mu, inv, m, w, excl, rows)

    win = np.lib.stride_tricks.sliding_window_view(T64, m)
    bestP = np.full(rows.shape[0], AGGREGATE_INIT, np.float64)
    bestI = np.full(rows.shape[0], INDEX_INIT, np.int32)
    fin = np.isfinite(inv)
    cent = win - mu[:, None]  # (w, m); fine for fallback-scale inputs
    for i, r in enumerate(rows):
        if not fin[r]:
            continue
        qt = cent @ cent[r]
        with np.errstate(invalid="ignore"):
            P = qt * inv * inv[r]
        ks = np.abs(np.arange(w) - r)
        P[(ks < excl) | ~fin] = AGGREGATE_INIT
        bi = int(np.argmax(P))
        bestP[i] = P[bi]
        bestI[i] = bi if P[bi] > AGGREGATE_INIT else INDEX_INIT
    return bestP, bestI


# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("S", "W", "k"))
def _job_kth_max_group(r0s, k0s, jrow_g, jcol_g, gv, *, S, W, k):
    """Fold pass A's captured per-job maxima into per-row top-k job
    maxima (descending (L, k) carry).  The k-th largest per-job maximum
    LOWER-bounds the row's true k-th best pair: only the k-1 pairs
    strictly above v_k can push a job's maximum above v_k, so at most
    k-1 job maxima exceed it.  That makes thr = kth_jobs - 2*margin a
    sound k-NN suspect threshold available for free after pass A."""

    def insert(cur, v):
        # insert one value into each row's desc-sorted (k,) vector
        out = [jnp.maximum(cur[:, 0], v)]
        for j in range(1, k):
            out.append(jnp.maximum(cur[:, j], jnp.minimum(cur[:, j - 1], v)))
        return jnp.stack(out, axis=1)

    def body(gv, job):
        r0, k0, jrow, jcol = job
        zero = np.int32(0)
        rv = _decode_max_u16(jrow)
        cv = _decode_max_u16(jcol)
        cur = jax.lax.dynamic_slice(gv, (r0, zero), (S, k))
        gv = jax.lax.dynamic_update_slice(gv, insert(cur, rv), (r0, zero))
        c0 = r0 + k0
        cur = jax.lax.dynamic_slice(gv, (c0, zero), (W, k))
        gv = jax.lax.dynamic_update_slice(gv, insert(cur, cv), (c0, zero))
        return gv, None

    return jax.lax.scan(body, gv, (r0s, k0s, jrow_g, jcol_g))[0]


def _row_topk_scan(T64, mu, inv, m, w, excl, rows, k):
    """Exact f64 top-k over full profile rows (both sides), batched
    blockwise GEMM — the last-resort path for rows whose suspect set
    cannot be bounded (> the device pass C's K2 near-ties).  Rows are
    processed RB at a time so the O(w*m) per-row sweep runs as
    (block, m) @ (m, RB) GEMMs instead of per-row GEMVs (the host has
    one core; BLAS3 vs BLAS2 is ~5-8x there)."""
    wins = np.lib.stride_tricks.sliding_window_view(T64, m)[:w]
    out_v = np.full((rows.size, k), AGGREGATE_INIT, np.float64)
    out_i = np.full((rows.size, k), INDEX_INIT, np.int32)
    fin = np.isfinite(inv)
    RB = 32
    kk = min(k, w)
    for t0 in range(0, rows.size, RB):
        sel = np.arange(t0, min(t0 + RB, rows.size))
        rr = rows[sel]
        live = fin[rr]
        Q = np.where(
            live[:, None],
            (wins[rr] - mu[rr][:, None]) * np.where(live, inv[rr], 0)[:, None],
            0.0,
        )  # (R, m)
        P = np.empty((w, sel.size), np.float64)
        for b in range(0, w, 8192):
            e = min(b + 8192, w)
            cent = wins[b:e] - mu[b:e, None]
            P[b:e] = (cent @ Q.T) * inv[b:e, None]
        P[~fin, :] = AGGREGATE_INIT
        # trivial-match zone + dead query rows
        d = np.arange(w)[:, None] - rr[None, :]
        P[np.abs(d) < excl] = AGGREGATE_INIT
        P[:, ~live] = AGGREGATE_INIT
        part = np.argpartition(-P, kk - 1, axis=0)[:kk]  # (k, R)
        vals = np.take_along_axis(P, part, axis=0)
        order = np.argsort(-vals, axis=0, kind="stable")
        part = np.take_along_axis(part, order, axis=0)
        vals = np.take_along_axis(vals, order, axis=0)
        real = vals > AGGREGATE_INIT
        for j, t in enumerate(sel):
            nr = int(real[:, j].sum())
            out_v[t, :nr] = vals[: nr, j]
            out_i[t, :nr] = part[: nr, j]
    return out_v, out_i


def compute_topk_profile_f64_hybrid(
    T,
    k: int = 4,
    config: Optional[MatrixProfileConfig] = None,
    *,
    m: Optional[int] = None,
    margin: Optional[float] = None,
    profile=None,
):
    """Exact double-precision k-NN profile via the hybrid tier.

    Same evidence structure as the k=1 hybrid, with an iterative
    per-row threshold descent: pass A's f32 max sweep seeds
    ``thr = gmax32 - 2*margin``; each round, rows whose k best RESCORED
    suspects clear ``thr + margin`` are certified (any non-suspect has
    ``P64 < thr + margin <= v_k``, so it cannot displace them), and the
    rest lower their thresholds (doubling steps) until their suspect
    band holds k provable neighbors.  Certified rows set thr = +inf, so
    later rounds' sparse sweeps skip them entirely.  Overflowing rows
    ride the pass-C top-64 scan with its on-device coverage proof;
    pathological rows (> 64 near-ties) fall back to an exact host scan.

    Requires ``k <= 2*SUSPECT_K`` (the capture width); larger k should
    use the strict device tier.  Returns (distances (w, k) float64,
    indices (w, k) int32), rows sorted ascending; missing neighbors are
    (inf, -1) — the same contract as mpx.topk.compute_topk_profile."""
    from mpx.ops.precompute import precompute_statistics, precompute_statistics_numpy

    if k < 1 or k > 2 * SUSPECT_K:
        raise ValueError(
            f"hybrid top-k requires 1 <= k <= {2 * SUSPECT_K}, got {k}"
        )
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32, dtype="float64")
    m = config.m
    T64 = np.asarray(T, np.float64)
    n = T64.shape[0]
    config.validate_series(n, T64)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    excl = m // 4
    if margin is None:
        margin = default_margin(m)
    margin_f = float(margin)

    with _phase(profile, "1. Pre-Computation [host f64]"):
        from mpx import native

        if native.is_available():
            # mu/inv only: the hybrid needs just the exact rescoring
            # operands, and the stats-only kernel's vectorized
            # reductions are ~9x faster than the full precompute.
            s64 = native.precompute_stats(T64, m)
        else:
            s64 = precompute_statistics_numpy(T64, m)
        mu64, inv64 = s64["mu"], s64["inv"]

    with _phase(profile, "1. Pre-Computation [device f32]"):
        stats = precompute_statistics(
            T64, m, band=S, chunk=W, dtype="float32", host_stats=s64,
            matmul_only=True,
        )
        jax.block_until_ready(stats.mu)

    grid = make_job_grid(w, S, W)
    pw = stats.mu.shape[0]
    sparse = _sparse_ok(stats, w)
    kw = dict(S=S, W=W, m=m, w=w, tr=config.tile_rows, tc=config.tile_cols)

    with _phase(profile, "2. Compute [mxu f32 pass A]"):
        cap = None
        if sparse:
            thr_d, cap = run_max_jobs(
                stats, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                jnp.float32(margin), pw=pw, capture=True, **kw
            )
        else:
            thr_d = run_max_jobs(
                stats, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                jnp.float32(margin), pw=pw, **kw
            )
        thr_h = np.asarray(thr_d).copy()

    if sparse:
        # Initial per-row k-NN threshold from pass A's captured job
        # maxima: their k-th largest lower-bounds v_k (at most k-1
        # pairs — hence k-1 job maxima — exceed it), so round one of
        # the loop below certifies nearly every row instead of
        # descending from the 1-NN threshold.
        with _phase(profile, "2. Compute [topk thr estimate]"):
            Lg = w + S + W
            gv = jnp.full((Lg, k), jnp.float32(AGGREGATE_INIT), jnp.float32)
            for gr, gk, jrow, jcol in cap:
                gv = _job_kth_max_group(gr, gk, jrow, jcol, gv, S=S, W=W, k=k)
            est = np.asarray(gv[:w, k - 1], np.float64)
            q16 = 2.0 / 65535.0
            good = est > AGGREGATE_INIT / 2
            # The k-th-job-max estimate COLLAPSES on plateau data: a
            # row's top-k pairs are usually consecutive columns inside
            # ONE job, so the k-th largest job max is the max of the
            # k-th best job — far below v_k.  Unclamped, that seeded a
            # threshold so low that it once flooded 98% of all rows into
            # the full-width pass C.
            # Clamp the descent to CAP below the 1-NN threshold:
            # raising thr is always sound (certification is
            # self-validating; failing rows just descend), and CAP is
            # sized from the measured suspect-band density (mean 19.5
            # suspects/row at delta=8e-3 on the walk data) so the band
            # stays enumerable by the capture slots / plateau bracket.
            cap_delta = float(os.environ.get("MPX_TOPK_CAP", 8e-3))
            seeded = np.where(good, est - q16 - 2.0 * margin_f, -np.inf)
            thr_h[:w] = np.maximum(
                seeded, thr_h[:w] - cap_delta
            ).astype(np.float32)

    rescore = lambda r, c: _rescore_pairs(T64, mu64, inv64, m, r, c)
    nslots = 2 * SUSPECT_K
    topv = np.full((w, k), AGGREGATE_INIT, np.float64)
    topi = np.full((w, k), INDEX_INIT, np.int32)
    certified = np.zeros(w, bool)
    delta = np.zeros(w, np.float32)
    MAX_IT = 8
    # Pass-C capture widths: K1 slots for the first device scan of each
    # overflow row, K2 for the wide re-scan of rows whose tie plateau
    # defeats K1 certification (env-tunable so tests can force every
    # escalation stage at toy sizes).
    K64 = int(os.environ.get("MPX_TOPK_K1", 64))
    CW = 16384

    def commit(rows, vals, idxs):
        topv[rows] = vals[:, :k]
        topi[rows] = idxs[:, :k]
        certified[rows] = True

    def best_of(rows, cand_rows, P_rows):
        """Sort each row's rescored candidates (desc value, ties by
        ascending index) and return (vals (R, k), idxs (R, k), nreal,
        vk)."""
        order = np.lexsort(
            (np.where(cand_rows >= 0, cand_rows, np.int64(2**31)), -P_rows),
            axis=-1,
        )
        Ps = np.take_along_axis(P_rows, order, 1)
        Is = np.take_along_axis(cand_rows, order, 1)
        nreal = (Ps > AGGREGATE_INIT).sum(1)
        pad = max(0, k - Ps.shape[1])
        if pad:
            Ps = np.pad(Ps, ((0, 0), (0, pad)), constant_values=AGGREGATE_INIT)
            Is = np.pad(Is, ((0, 0), (0, pad)), constant_values=INDEX_INIT)
        vk = np.where(nreal >= k, Ps[:, k - 1], -np.inf)
        Is = np.where(Ps > AGGREGATE_INIT, Is, INDEX_INIT)
        return Ps, Is, nreal, vk

    for it in range(MAX_IT):
        thr_dev = jnp.asarray(thr_h)
        with _phase(profile, "2. Compute [mxu f32 topk pass B]",
                    f"iter_{it}"):
            if sparse:
                sus = run_suspect_jobs_sparse(stats, thr_dev, cap, **kw)
            else:
                sus = run_suspect_jobs(
                    stats, thr_dev, jnp.asarray(grid.r0),
                    jnp.asarray(grid.k0), **kw
                )
            sus = jax.device_get(sus)

        with _phase(profile, "3. Rescore [host f64 topk]", f"iter_{it}"):
            cnt = sus.cnt[:w]
            cand = np.concatenate([sus.mn[:w], sus.mx[:w][:, ::-1]], axis=1)
            cand[(cand == int(SUSPECT_MIN_INIT)) | (cand < 0)] = -1
            todo = ~certified
            # everything-is-a-suspect rows: thr below any correlation
            allin = thr_h[:w] <= -1.0

            small = np.nonzero(todo & (cnt <= nslots))[0].astype(np.int32)
            if small.size:
                sl = cand[small].copy()
                for j in range(1, nslots):
                    dup = (sl[:, :j] == sl[:, j : j + 1]).any(axis=1)
                    sl[dup & (sl[:, j] >= 0), j] = -1
                P = rescore(
                    np.repeat(small, nslots), sl.reshape(-1)
                ).reshape(-1, nslots)
                P[sl < 0] = AGGREGATE_INIT
                Ps, Is, nreal, vk = best_of(small, sl, P)
                ok = ((nreal >= k) & (vk >= thr_h[small] + margin_f)) | (
                    allin[small]
                )
                if ok.any():
                    commit(small[ok], Ps[ok], Is[ok])

            over = todo & (cnt > nslots)
            # Narrow-spread plateau rows: every suspect lies in the
            # captured [mn1, mx1] bracket; when it is compact, rescoring
            # the whole interval enumerates ALL suspects on the host —
            # no device pass C needed (mirrors the k=1 resolve).  The
            # cap is 512 (p99 plateau width on the walk data is ~94):
            # wide enough that pass C — a full-width device rescan per
            # row — only sees genuinely SCATTERED suspect sets.  Rows
            # are processed in spread-sorted chunks so each chunk's
            # rescore width is its own max spread, not the global cap.
            RUNCAP = int(os.environ.get("MPX_TOPK_RUNCAP", 512))
            mn1w = sus.mn[:w, 0]
            mx1w = sus.mx[:w, 0]
            spread = mx1w.astype(np.int64) - mn1w.astype(np.int64) + 1
            narrow = (
                over & (mn1w != int(SUSPECT_MIN_INIT)) & (spread <= RUNCAP)
            )
            nrows_all = np.nonzero(narrow)[0].astype(np.int32)
            if nrows_all.size:
                nrows_all = nrows_all[
                    np.argsort(spread[nrows_all], kind="stable")
                ]
                ROWCHUNK = 16384
                for o in range(0, nrows_all.size, ROWCHUNK):
                    nrows = nrows_all[o : o + ROWCHUNK]
                    rc = max(8, int(spread[nrows].max() + 7) // 8 * 8)
                    runs = (
                        mn1w[nrows][:, None]
                        + np.arange(rc, dtype=np.int32)[None, :]
                    )
                    runs = np.where(runs <= mx1w[nrows][:, None], runs, -1)
                    if excl > 0:
                        d_ = runs - nrows[:, None]
                        runs = np.where(np.abs(d_) >= excl, runs, -1)
                    P = rescore(
                        np.repeat(nrows, rc), runs.reshape(-1).astype(np.int32)
                    ).reshape(-1, rc)
                    P[runs < 0] = AGGREGATE_INIT
                    Ps, Is, nreal, vk = best_of(nrows, runs, P)
                    ok = ((nreal >= k) & (vk >= thr_h[nrows] + margin_f)) | (
                        allin[nrows]
                    )
                    if ok.any():
                        commit(nrows[ok], Ps[ok], Is[ok])

            big = np.nonzero(over & ~narrow)[0].astype(np.int32)
            # Rows whose k-th candidate cannot clear the K64-th device
            # value + margin (tie plateaus wider than 64): collected
            # across chunks and escalated with a WIDER device pass C
            # below, instead of the O(w*m)-per-row host scan (which
            # dominated the wall when these rows went to the host).
            wild_rows: list = []
            # Pass C in chunks of rows: bounds the (rows, K) top-k
            # carries of one dispatch.
            CHUNK_ROWS = 2048
            for o in range(0, big.size, CHUNK_ROWS):
                grp = big[o : o + CHUNK_ROWS]
                with _phase(profile, "2. Compute [mxu f32 topk pass C]",
                            f"iter_{it}_{o}"):
                    F = max(256, ((grp.size + 255) // 256) * 256)
                    pad = np.full(F - grp.size, pw - 1, np.int32)
                    fidx = jnp.asarray(np.concatenate([grp, pad]))
                    CW_ = CW
                    while pw % CW_:
                        CW_ //= 2
                    bv, bi, _ = jax.device_get(
                        scan_flagged_rows(
                            stats, thr_dev, fidx, m=m, w=w, excl=excl,
                            K=K64, CW=CW_,
                        )
                    )
                    bv = bv[: grp.size]
                    bi = bi[: grp.size]
                P = rescore(
                    np.repeat(grp, K64), bi.reshape(-1).astype(np.int32)
                ).reshape(-1, K64)
                # Slots the device filled with init (rows with < 64
                # valid pairs) carry arbitrary column indices — mask
                # them before scoring can resurrect invalid pairs.
                P[(bi < 0) | (bv <= np.float32(AGGREGATE_INIT))] = (
                    AGGREGATE_INIT
                )
                Ps, Is, nreal, vk = best_of(grp, bi.astype(np.int32), P)
                # Certification is against the f32 top-64 itself, not
                # the suspect threshold: any pair OUTSIDE the candidates
                # has P32 <= bv[63], hence P64 <= bv[63] + margin — if
                # the k-th rescored candidate clears that, no outsider
                # can displace the top-k.  bv[63] = init means the row
                # has < 64 valid pairs, all of them candidates.
                bv_last = bv[:, K64 - 1].astype(np.float64)
                ok = ((nreal >= k) & (vk >= bv_last + margin_f)) | (
                    bv_last <= AGGREGATE_INIT
                )
                if ok.any():
                    commit(grp[ok], Ps[ok], Is[ok])
                # k-th within margin of the 64th (tie plateau wider
                # than 64): escalate with a wider K below.
                if (~ok).any():
                    wild_rows.append(grp[~ok])

            # Wide-K escalation: one more device pass C at K2 slots for
            # the plateau rows.  The certification logic is identical
            # (any pair outside the top-K2 has P32 <= bv[K2-1], hence
            # P64 <= bv[K2-1] + margin); with plateaus measured at
            # p99≈94 near-ties, K2=512 clears nearly every row that K=64
            # could not, for O(K2) rescores/row instead of the O(w*m)
            # host scan.  MPX_TOPK_K2=0 restores the direct host scan.
            wild_all = (
                np.concatenate(wild_rows) if wild_rows
                else np.empty(0, np.int32)
            )
            K2 = int(os.environ.get("MPX_TOPK_K2", 512))
            if wild_all.size and K2 > K64:
                K2 = min(K2, pw)
                still = []
                for o in range(0, wild_all.size, max(256, CHUNK_ROWS // 8)):
                    grp = wild_all[o : o + max(256, CHUNK_ROWS // 8)]
                    with _phase(profile, "2. Compute [mxu f32 topk pass C wide]",
                                f"iter_{it}_{o}"):
                        F = max(256, ((grp.size + 255) // 256) * 256)
                        pad = np.full(F - grp.size, pw - 1, np.int32)
                        fidx = jnp.asarray(np.concatenate([grp, pad]))
                        CW_ = CW
                        while pw % CW_:
                            CW_ //= 2
                        bv, bi, _ = jax.device_get(
                            scan_flagged_rows(
                                stats, thr_dev, fidx, m=m, w=w, excl=excl,
                                K=K2, CW=CW_,
                            )
                        )
                        bv = bv[: grp.size]
                        bi = bi[: grp.size]
                    P = rescore(
                        np.repeat(grp, K2), bi.reshape(-1).astype(np.int32)
                    ).reshape(-1, K2)
                    P[(bi < 0) | (bv <= np.float32(AGGREGATE_INIT))] = (
                        AGGREGATE_INIT
                    )
                    Ps, Is, nreal, vk = best_of(grp, bi.astype(np.int32), P)
                    bv_last = bv[:, K2 - 1].astype(np.float64)
                    ok = ((nreal >= k) & (vk >= bv_last + margin_f)) | (
                        bv_last <= AGGREGATE_INIT
                    )
                    if ok.any():
                        commit(grp[ok], Ps[ok], Is[ok])
                    if (~ok).any():
                        still.append(grp[~ok])
                wild_all = (
                    np.concatenate(still) if still
                    else np.empty(0, np.int32)
                )
            # Pathological remainder (plateau wider than K2): exact
            # host scan, batched GEMM.
            if wild_all.size:
                with _phase(profile, "3. Rescore [host f64 topk scan]"):
                    vv, ii = _row_topk_scan(
                        T64, mu64, inv64, m, w, excl, wild_all, k
                    )
                    commit(wild_all, vv, ii)
            Logger.verbose_log(
                f"topk iter {it}: small={small.size} "
                f"narrow={nrows_all.size} "
                f"big={big.size} wild={sum(x.size for x in wild_rows)} "
                f"host-scanned={wild_all.size} "
                f"certified={int(certified.sum())}/{w}"
            )

        rem = ~certified
        if not rem.any():
            break
        # Lower the remaining rows' thresholds (doubling descent) and
        # freeze certified rows out of the next sparse sweep.
        delta[rem] = np.maximum(4 * margin_f, 2 * delta[rem])
        thr_h[:w][rem] = thr_h[:w][rem] - delta[rem]
        thr_h[:w][certified] = np.inf
    else:
        left = np.nonzero(~certified)[0].astype(np.int32)
        if left.size:
            Logger.warning(
                f"hybrid top-k: {left.size} row(s) did not converge in "
                f"{MAX_IT} rounds; exact host scans"
            )
            with _phase(profile, "3. Rescore [host f64 topk scan]"):
                vv, ii = _row_topk_scan(T64, mu64, inv64, m, w, excl, left, k)
                commit(left, vv, ii)

    with _phase(profile, "4. Post-Computation [host]"):
        D = np.sqrt(np.maximum(2.0 * m * (1.0 - topv), 0.0))
        D = np.where(topi >= 0, D, np.inf)
        return D, topi


def compute_matrix_profile_f64_hybrid(
    T,
    config: Optional[MatrixProfileConfig] = None,
    *,
    m: Optional[int] = None,
    margin: Optional[float] = None,
    profile=None,
    ckpt=None,
):
    """Exact double-precision self-join profile via the hybrid tier.

    Returns (MP float64 distances, MPI int32) as numpy arrays, matching
    the reference's double semantics at the 1e-8 test tolerance.

    ``ckpt`` (mpx.checkpoint.HybridCheckpoint; single-device self-joins
    only — use mpx.checkpoint.compute_hybrid_with_checkpoint) makes the
    run resumable at dispatch-group granularity.
    """
    from mpx.ops.precompute import precompute_statistics, precompute_statistics_numpy

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32, dtype="float64")
    m = config.m
    T64 = np.asarray(T, np.float64)
    n = T64.shape[0]
    config.validate_series(n, T64)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    excl = m // 4
    if margin is None:
        margin = default_margin(m)

    # 1+2. Statistics, twice (both exact-f64-derived):
    #    * HOST f64 stats — single source of truth for the exact
    #      rescoring stages (always computed, stays on host);
    #    * DEVICE f32 stats — the matmul operands for passes A/B/C.
    #    Large runs compute the device stats ON DEVICE from T alone
    #    (_precompute_jax_f64_matmul) instead of staging host-derived
    #    mu/inv: T is 8.4 MB at 1M vs 12.7 MB for T32+mu+inv, the
    #    dispatch is async so the host f64 stats overlap it, and the
    #    only contract risk — the degenerate-
    #    window mask, which is excluded OUTRIGHT rather than margin-
    #    protected — is reconciled exactly below.  Small runs keep the
    #    host-staging path (one jit avoided; transfer is trivial).
    dev_stats = _device_stats_enabled(w)
    dev_bad = None
    if dev_stats:
        with _phase(profile, "1. Pre-Computation [device f64 stats]"):
            # async dispatch; overlapped by the host stats below
            stats = precompute_statistics(
                T64, m, band=S, chunk=W, dtype="float32", backend="jax",
                matmul_only=True, windows=False,
            )
            # Enqueue the degeneracy mask AHEAD of the sweep dispatches:
            # the optimistic reconcile below fetches it while pass A
            # runs, so its transfer never waits on O(n^2) device work.
            dev_bad = jax.jit(jnp.isinf)(stats.inv)

    with _phase(profile, "1. Pre-Computation [host f64]"):
        from mpx import native

        if native.is_available():
            # mu/inv only: the hybrid needs just the exact rescoring
            # operands, and the stats-only kernel's vectorized
            # reductions are ~9x faster than the full precompute.
            s64 = native.precompute_stats(T64, m)
        else:
            s64 = precompute_statistics_numpy(T64, m)
        mu64, inv64 = s64["mu"], s64["inv"]

    reconcile = None
    if dev_stats:
        with _phase(profile, "1. Pre-Computation [windows]"):
            from mpx.ops.precompute import _maybe_windows

            # async dispatch — built from the UNRECONCILED device stats;
            # reconcile() rebuilds it in the ~never case of a patch
            stats = _maybe_windows(stats, m, None)

        def reconcile():
            """Blocking degeneracy check (its fetch overlaps the pass-A
            dispatch chain).  Returns True when the device
            mask disagreed with the host classification and ``stats``
            was patched — the caller must then RE-dispatch any sweep
            work issued against the optimistic stats."""
            nonlocal stats
            fixed = _reconcile_degenerate(stats, inv64, w, dev_bad=dev_bad)
            if fixed is stats:
                return False
            stats = _maybe_windows(fixed._replace(windows=None), m, None)
            return True
    else:
        # matmul_only: the hybrid sweeps are all windows matmuls — the
        # recurrence seeds (df/dg/qt0) would be half the staging bytes
        # for nothing.
        with _phase(profile, "1. Pre-Computation [device f32]"):
            stats = precompute_statistics(
                T64, m, band=S, chunk=W, dtype="float32", host_stats=s64,
                matmul_only=True,
            )
            jax.block_until_ready(stats.mu)

    grid = make_job_grid(w, S, W)
    num_shards = config.num_shards or 1
    pw = stats.mu.shape[0]
    shard_tag = f", sharded x{num_shards}" if num_shards > 1 else ""
    if ckpt is not None and num_shards > 1:
        raise ValueError("hybrid checkpointing is single-device")

    sparse = num_shards == 1 and _sparse_ok(stats, w)

    if (ckpt is None and num_shards == 1 and w <= HYBRID_SMALL_FUSED_W):
        # Small problems: the whole device side in one dispatch + one
        # packed fetch (see _hybrid_small_fused).
        with _phase(profile, "2. Compute [mxu f32 fused A+B]"):
            packed, thr = _hybrid_small_fused(
                stats, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                jnp.float32(margin),
                S=S, W=W, m=m, w=w,
                tr=config.tile_rows, tc=config.tile_cols, pw=pw,
                prec=HYBRID_PRECISION,
            )
            jax.block_until_ready(packed)
        with _phase(profile, "2. Compute [packed fetch]"):
            host = np.asarray(packed)
        K = SUSPECT_K
        sus = SuspectWindow(
            cnt=host[:, 0], mn=host[:, 1 : 1 + K], mx=host[:, 1 + K :]
        )
        sym = None
        if native.is_available():
            sym = lambda cand: native.resolve_slots(
                T64, mu64, inv64, m, cand, w
            )
        bestP, bestI = _resolve_side(
            sus, w, m,
            rescore=lambda r, c: _rescore_pairs(T64, mu64, inv64, m, r, c),
            stats_q=stats, stats_t=stats, thr_q=thr, excl=excl, wt=w,
            escalate=lambda rows: _row_scan(T64, mu64, inv64, m, w, excl,
                                            rows),
            profile=profile, sym_resolve=sym,
        )
        with _phase(profile, "4. Post-Computation [host]"):
            MP = np.sqrt(np.maximum(2.0 * m * (1.0 - bestP), 0.0))
            return MP, bestI

    if reconcile is not None and (ckpt is not None or num_shards > 1):
        # Checkpointed / sharded runs reconcile synchronously up front:
        # their persisted or per-shard state must never mix optimistic
        # and patched statistics.
        with _phase(profile, "1. Pre-Computation [mask reconcile]"):
            reconcile()
            reconcile = None
            jax.block_until_ready(stats.mu)

    state_b = ckpt.load_b() if ckpt is not None else None
    if state_b is not None:
        # Resume mid-pass-B: pass A is complete (thr persisted); the
        # pending jobs re-sweep DENSELY from the loaded suspect state
        # (their pass-A captures died with the crashed process; the
        # dense sweep captures the identical suspect set).
        thr = jnp.asarray(state_b["thr"])
        r0p, k0p = ckpt.pending_jobs(grid)
        Logger.info(
            f"hybrid pass B: resuming, {r0p.shape[0]} of "
            f"{ckpt.njobs} jobs pending"
        )
        with _phase(profile, "2. Compute [mxu f32 pass B resume dense]"):
            rows_g = SuspectWindow(
                cnt=jnp.asarray(state_b["rows_cnt"]),
                mn=jnp.asarray(state_b["rows_mn"]),
                mx=jnp.asarray(state_b["rows_mx"]),
            )
            cols_g = SuspectWindow(
                cnt=jnp.asarray(state_b["cols_cnt"]),
                mn=jnp.asarray(state_b["cols_mn"]),
                mx=jnp.asarray(state_b["cols_mx"]),
            )
            sus = run_suspect_jobs(
                stats, thr, r0p, k0p,
                S=S, W=W, m=m, w=w,
                tr=config.tile_rows, tc=config.tile_cols,
                ckpt=ckpt, rows_g=rows_g, cols_g=cols_g,
            )
            sus = jax.device_get(sus)
    else:
        # 3. Pass A: f32 value-only max sweep -> suspect threshold (the
        #    sparse variant also captures each job's row/col maxima — the
        #    pass-B skip oracle).  Dispatched OPTIMISTICALLY against the
        #    unreconciled device stats when reconcile is pending: the
        #    degeneracy check's fetch then overlaps pass A on device, and
        #    a mismatch (~never: the estimators disagree only within ulp
        #    of the variance threshold) re-dispatches the pass.
        with _phase(profile, f"2. Compute [mxu f32 pass A{shard_tag}]"):

            def dispatch_pass_a():
                if num_shards > 1:
                    return run_max_jobs_sharded(
                        stats, grid, margin, num_shards=num_shards,
                        S=S, W=W, m=m, w=w,
                        tr=config.tile_rows, tc=config.tile_cols, pw=pw,
                    ), None
                if sparse:
                    return run_max_jobs(
                        stats, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                        jnp.float32(margin),
                        S=S, W=W, m=m, w=w,
                        tr=config.tile_rows, tc=config.tile_cols, pw=pw,
                        capture=True, ckpt=ckpt,
                    )
                return run_max_jobs(
                    stats, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                    jnp.float32(margin),
                    S=S, W=W, m=m, w=w,
                    tr=config.tile_rows, tc=config.tile_cols, pw=pw,
                    ckpt=ckpt,
                ), None

            thr, cap = dispatch_pass_a()
            if reconcile is not None and reconcile():
                Logger.info(
                    "hybrid: device degeneracy mask patched — "
                    "re-dispatching pass A against reconciled stats"
                )
                thr, cap = dispatch_pass_a()
            if ckpt is not None or _sync_phases():
                jax.block_until_ready(thr)
        if ckpt is not None:
            ckpt.begin_b(thr)

        # 4. Pass B: suspect sweep against thr = gmax - 2*margin.
        pass_b_tag = "sparse" if sparse else "suspects"
        with _phase(profile,
                    f"2. Compute [mxu f32 pass B {pass_b_tag}{shard_tag}]"):
            if num_shards > 1:
                sus = run_suspect_jobs_sharded(
                    stats, thr, grid, num_shards=num_shards,
                    S=S, W=W, m=m, w=w,
                    tr=config.tile_rows, tc=config.tile_cols,
                )
            elif sparse:
                sus = run_suspect_jobs_sparse(
                    stats, thr, cap,
                    S=S, W=W, m=m, w=w,
                    tr=config.tile_rows, tc=config.tile_cols,
                    profile=profile, ckpt=ckpt,
                )
                cap = None  # free the captured job maxima
            else:
                sus = run_suspect_jobs(
                    stats, thr, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                    S=S, W=W, m=m, w=w,
                    tr=config.tile_rows, tc=config.tile_cols, ckpt=ckpt,
                )
            # one bulk transfer instead of per-array slicing executables
            sus = jax.device_get(sus)

    from mpx import native as _native

    sym = None
    if _native.is_available():
        sym = lambda cand: _native.resolve_slots(T64, mu64, inv64, m, cand, w)
    bestP, bestI = _resolve_side(
        sus, w, m,
        rescore=lambda r, c: _rescore_pairs(T64, mu64, inv64, m, r, c),
        stats_q=stats, stats_t=stats, thr_q=thr, excl=excl, wt=w,
        escalate=lambda rows: _row_scan(T64, mu64, inv64, m, w, excl, rows),
        profile=profile, sym_resolve=sym,
    )

    with _phase(profile, "4. Post-Computation [host]"):
        MP = np.sqrt(np.maximum(2.0 * m * (1.0 - bestP), 0.0))
        return MP, bestI


def _resolve_side(sus, wq, m, *, rescore, stats_q, stats_t, thr_q, excl, wt,
                  escalate, profile, side=0, sym_resolve=None,
                  oneside_resolve=None, passc_fn=None):
    """Shared suspect-resolution stage: rescore the captured candidates
    exactly, run the device pass C for capture-overflow rows, and hand
    pathological rows to the exact host scan.  ``sus`` is a host
    SuspectWindow over the query axis (length >= wq).

    ``sym_resolve(cand) -> (bestP, bestI)`` (self-joins only): one C
    pass over the raw (wq, nslots) capture-slot matrix — slot dedupe,
    symmetric-pair filtering (each unordered pair scored once, merged
    into both endpoints), and exact f64 scoring
    (mpx/native/scamp_host.cpp:mpx_resolve_slots)."""
    cnt = sus.cnt[:wq]
    # All 2*SUSPECT_K capture slots, ascending: k smallest then the
    # k largest (descending storage reversed).
    cand = np.concatenate(
        [sus.mn[:wq], sus.mx[:wq][:, ::-1]], axis=1
    )
    nslots = cand.shape[1]

    # Escalation masks up front, so the device pass C can be DISPATCHED
    # before the host rescore runs — jax dispatch is async, so the device
    # row scans overlap the single-core host rescoring below.
    RUNCAP, K = 64, 64
    over4 = cnt > nslots
    mn1w = sus.mn[:wq, 0]
    mx1w = sus.mx[:wq, 0]
    spread = mx1w.astype(np.int64) - mn1w.astype(np.int64) + 1
    narrow = over4 & (mn1w != int(SUSPECT_MIN_INIT)) & (spread <= RUNCAP)
    nrows = np.nonzero(narrow)[0].astype(np.int32)
    flagged = np.nonzero(over4 & ~narrow)[0].astype(np.int32)
    passc = None
    # stats_q=None without a passc_fn: no replicated device statistics
    # exist and the caller supplied no sharded pass C — the few
    # wide-overflow rows go straight to the exact host row scan.
    if flagged.size and passc_fn is not None:
        with _phase(profile, "2. Compute [mxu f32 pass C flagged rows]"):
            # sharded pass C (the ring tier): the callee pads, scans
            # each device's column shard, and merges to (F, K) + counts
            passc = passc_fn(flagged, K)
    elif flagged.size and stats_q is not None:
        CW = 16384
        pw = stats_q.mu.shape[0]
        pwt = stats_t.mu.shape[0]
        with _phase(profile, "2. Compute [mxu f32 pass C flagged rows]"):
            # pad F to a 512-row bucket (bounded recompiles; pass C cost
            # is linear in F, so fine-grained buckets beat powers of two)
            F = max(256, ((flagged.size + 511) // 512) * 512)
            pad = np.full(F - flagged.size, pw - 1, np.int32)
            fidx = jnp.asarray(np.concatenate([flagged, pad]))
            # CW must divide the padded target width (a multiple of 8192;
            # smaller only for tiny inputs)
            CW_ = CW
            while pwt % CW_:
                CW_ //= 2
            passc = scan_flagged_rows(
                stats_q, thr_q, fidx, m=m, w=wt, excl=excl, K=K, CW=CW_,
                stats_t=None if stats_t is stats_q else stats_t, side=side,
            )

    with _phase(profile, "3. Rescore [host f64]"):
        if sym_resolve is not None:
            # Suspect-ness is per-row (each row has its own threshold
            # gmax32[i] - 2*margin), so pair (i, c) may be captured on
            # one side only.  The C resolver keeps (i, c) from row i's
            # slots iff c > i, or c < i and i is NOT in c's slots (then
            # only i's side has it); when both sides captured it, the
            # c-side copy survives via its own c > i rule — each pair
            # is scored exactly once and merged into both endpoints
            # (sound for any valid pair: non-suspects of a row strictly
            # lose there, so extra merges never change that row's
            # answer).
            bestP, bestI = sym_resolve(cand)
        elif oneside_resolve is not None:
            # Left/right and AB-joins: the two pair endpoints land in
            # different output arrays, so there is no symmetric dedupe —
            # but the C resolver still folds sentinel skipping, slot
            # dedupe, exact scoring, and the per-row best into one pass
            # (mpx_resolve_slots_ab).
            bestP, bestI = oneside_resolve(cand)
        else:
            # Sentinels (no suspect in that slot) -> -1: rescore
            # returns init.
            cand[(cand == int(SUSPECT_MIN_INIT)) | (cand < 0)] = -1
            # Drop duplicate slots (cnt <= 2 rows repeat the same index
            # in several capture slots): the host has ONE core, so the
            # exact rescore is O(slots x m) — dedup cuts it ~2-4x.
            for j in range(1, nslots):
                dup = (cand[:, :j] == cand[:, j : j + 1]).any(axis=1)
                cand[dup & (cand[:, j] >= 0), j] = -1
            rows_idx = np.repeat(np.arange(wq, dtype=np.int32), nslots)
            P = rescore(rows_idx, cand.reshape(-1).astype(np.int32)).reshape(
                wq, nslots
            )
            # Exclude duplicate slots from the tie-break by index: keep
            # the best P; ties resolve to the smallest neighbor index.
            bestP = P.max(axis=1)
            tie = P >= bestP[:, None]
            cand_for_tie = np.where(tie & (cand >= 0), cand, np.int32(2**30))
            bestI = cand_for_tie.min(axis=1)
            bestI = np.where(
                (bestP > AGGREGATE_INIT) & (bestI < 2**30), bestI, INDEX_INIT
            ).astype(np.int32)

    # Narrow-spread escalation: capture-slot overflow (cnt > 2K), but
    # every suspect lies in the captured index interval [mn1, mx1] by
    # construction — when that interval is small (correlation plateaus:
    # smooth data puts the near-maximal neighbors at consecutive
    # offsets), rescoring the WHOLE interval exactly covers all suspects
    # at O(spread) host work, no device pass C needed.
    if nrows.size:
        with _phase(profile, "3. Rescore [host f64 plateau runs]"):
            base = mn1w[nrows]
            runs = base[:, None] + np.arange(RUNCAP, dtype=np.int32)[None, :]
            runs = np.where(runs <= mx1w[nrows][:, None], runs, -1)
            # The interval endpoints are genuine suspects (valid side),
            # but the interior may cross the trivial-match zone / side
            # boundary — mask those entries before rescoring.
            if excl > 0:
                delta = runs - nrows[:, None]
                if side > 0:
                    ok_zone = delta >= excl
                elif side < 0:
                    ok_zone = -delta >= excl
                else:
                    ok_zone = np.abs(delta) >= excl
                runs = np.where(ok_zone, runs, -1)
            rP = rescore(
                np.repeat(nrows, RUNCAP), runs.reshape(-1).astype(np.int32)
            ).reshape(nrows.size, RUNCAP)
            rbest = rP.max(axis=1)
            rtie = rP >= rbest[:, None]
            rcand = np.where(rtie & (runs >= 0), runs, np.int32(2**30))
            ridx = rcand.min(axis=1)
            bestP[nrows] = rbest
            bestI[nrows] = np.where(
                (rbest > AGGREGATE_INIT) & (ridx < 2**30), ridx, INDEX_INIT
            ).astype(np.int32)

    # Escalation: capture overflow spread too wide for interval
    # rescoring.  The device pass C was dispatched before the host
    # rescore above; collect its (already overlapped) results here.
    if flagged.size and passc is None:
        with _phase(profile, "3. Rescore [host f64 escalation]"):
            eP2, eI2 = escalate(flagged)
            bestP[flagged] = eP2
            bestI[flagged] = eI2
    elif flagged.size:
        with _phase(profile, "3. Rescore [host f64 flagged]"):
            bv, bi, ccnt = jax.device_get(passc)
            bv, bi, ccnt = (
                bv[: flagged.size], bi[: flagged.size], ccnt[: flagged.size]
            )
            frows = np.repeat(flagged, K)
            eP = rescore(frows, bi.reshape(-1).astype(np.int32)).reshape(
                flagged.size, K
            )
            # Device-init slots (rows with < K valid pairs) carry
            # arbitrary column indices; mask them before the exact
            # scoring can resurrect invalid (e.g. trivial-match) pairs.
            eP[(bi < 0) | (bv <= np.float32(AGGREGATE_INIT))] = AGGREGATE_INIT
            fbest = eP.max(axis=1)
            ftie = eP >= fbest[:, None]
            fcand = np.where(ftie & (bi >= 0), bi, np.int32(2**30))
            fidx_best = fcand.min(axis=1)
            bestP[flagged] = fbest
            bestI[flagged] = np.where(
                (fbest > AGGREGATE_INIT) & (fidx_best < 2**30),
                fidx_best, INDEX_INIT,
            ).astype(np.int32)

        # Ultra-escalation: even K slots overflowed (pathological ties).
        over = flagged[ccnt > K]
        if over.size:
            with _phase(profile, "3. Rescore [host f64 escalation]"):
                if over.size > 1000:
                    Logger.warning(
                        f"hybrid tier: {over.size} subsequences have more "
                        f"than {K} near-maximal pairs; exact host scans may "
                        f"dominate the runtime"
                    )
                eP2, eI2 = escalate(over)
                bestP[over] = eP2
                bestI[over] = eI2
    return bestP, bestI


def compute_ab_join_f64_hybrid(
    A,
    B,
    config: Optional[MatrixProfileConfig] = None,
    *,
    m: Optional[int] = None,
    margin: Optional[float] = None,
    profile=None,
):
    """Exact double-precision AB-join via the hybrid tier.

    Returns an ABJoinResult (numpy float64 distances / int32 indices):
    both directional profiles come out of the same two f32 sweeps (rows
    = A suspects, columns = B suspects), each side rescored exactly in
    host f64.  No trivial-match exclusion zone (AB semantics)."""
    from mpx import native
    from mpx.abjoin import ABJoinResult
    from mpx.ops.precompute import precompute_statistics, precompute_statistics_numpy

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32, dtype="float64")
    m = config.m
    A64 = np.asarray(A, np.float64)
    B64 = np.asarray(B, np.float64)
    config.validate_series(A64.shape[0], A64)
    config.validate_series(B64.shape[0], B64)
    wa = A64.shape[0] - m + 1
    wb = B64.shape[0] - m + 1
    config = config.shrink_to(max(wa, wb))
    S, W = config.band, config.chunk
    if margin is None:
        margin = default_margin(m)
    NO_EXCL = -(2**30)

    with _phase(profile, "1. Pre-Computation [host f64]"):
        if native.is_available():
            sa = native.precompute_stats(A64, m)
            sb = native.precompute_stats(B64, m)
        else:
            sa = precompute_statistics_numpy(A64, m)
            sb = precompute_statistics_numpy(B64, m)

    with _phase(profile, "1. Pre-Computation [device f32]"):
        stats_a = precompute_statistics(
            A64, m, band=S, chunk=W, dtype="float32", host_stats=sa,
            matmul_only=True,
        )
        stats_b = precompute_statistics(
            B64, m, band=S, chunk=W, dtype="float32", host_stats=sb,
            matmul_only=True,
        )
        jax.block_until_ready(stats_b.mu)

    # Rectangle jobs over A-rows x B-cols, encoded as (r0, k0 = c0 - r0)
    # so the shared job machinery reconstructs c0 = r0 + k0.
    r0s, k0s = [], []
    for r0 in range(0, wa, S):
        for c0 in range(0, wb, W):
            r0s.append(r0)
            k0s.append(c0 - r0)
    r0s = jnp.asarray(np.asarray(r0s, np.int32))
    k0s = jnp.asarray(np.asarray(k0s, np.int32))

    pwa = stats_a.mu.shape[0]
    pwb = stats_b.mu.shape[0]

    sparse = _sparse_ok(stats_a, max(wa, wb)) and stats_b.windows is not None

    if max(wa, wb) <= HYBRID_SMALL_FUSED_W:
        # One-dispatch device chain (see _hybrid_small_fused_two).
        with _phase(profile, "2. Compute [mxu f32 fused A+B]"):
            packed, thr_a, thr_b = _hybrid_small_fused_two(
                stats_a, r0s, k0s, jnp.float32(margin),
                S=S, W=W, m=m, w=wa,
                tr=config.tile_rows, tc=config.tile_cols,
                pw=pwa, wc=wb, pwc=pwb, excl=NO_EXCL, stats_c=stats_b,
                prec=HYBRID_PRECISION,
            )
            host = jax.device_get(packed)
        K = SUSPECT_K
        mk = lambda h: SuspectWindow(
            cnt=np.asarray(h[:, 0]), mn=np.asarray(h[:, 1 : 1 + K]),
            mx=np.asarray(h[:, 1 + K :]),
        )
        # host is a stacked (2, w, 1+2K) array (wa == wb) or a 2-tuple
        sus_a, sus_b = mk(host[0]), mk(host[1])
    else:
        with _phase(profile, "2. Compute [mxu f32 pass A]"):
            cap = None
            if sparse:
                (thr_a, thr_b), cap = run_max_jobs(
                    stats_a, r0s, k0s, jnp.float32(margin),
                    S=S, W=W, m=m, w=wa, tr=config.tile_rows,
                    tc=config.tile_cols,
                    pw=pwa, wc=wb, excl=NO_EXCL, pwc=pwb, stats_c=stats_b,
                    combine=False, capture=True,
                )
            else:
                thr_a, thr_b = run_max_jobs(
                    stats_a, r0s, k0s, jnp.float32(margin),
                    S=S, W=W, m=m, w=wa, tr=config.tile_rows,
                    tc=config.tile_cols,
                    pw=pwa, wc=wb, excl=NO_EXCL, pwc=pwb, stats_c=stats_b,
                    combine=False,
                )
            jax.block_until_ready(thr_b)

        pass_b_tag = "sparse" if sparse else "suspects"
        with _phase(profile, f"2. Compute [mxu f32 pass B {pass_b_tag}]"):
            if sparse:
                sus_a, sus_b = run_suspect_jobs_sparse(
                    stats_a, thr_a, cap,
                    S=S, W=W, m=m, w=wa, tr=config.tile_rows,
                    tc=config.tile_cols,
                    wc=wb, excl=NO_EXCL, stats_c=stats_b, thr_col=thr_b,
                    combine=False, profile=profile,
                )
                cap = None
            else:
                sus_a, sus_b = run_suspect_jobs(
                    stats_a, thr_a, r0s, k0s,
                    S=S, W=W, m=m, w=wa, tr=config.tile_rows,
                    tc=config.tile_cols,
                    wc=wb, excl=NO_EXCL, stats_c=stats_b, thr_col=thr_b,
                    combine=False,
                )
            sus_a, sus_b = jax.device_get((sus_a, sus_b))

    from mpx import native as _native

    os_ab = None
    os_ba = None
    if _native.is_available():
        os_ab = lambda cand: _native.resolve_slots_ab(
            A64, sa["mu"], sa["inv"], B64, sb["mu"], sb["inv"], m, cand,
            wa, wb,
        )
        os_ba = lambda cand: _native.resolve_slots_ab(
            B64, sb["mu"], sb["inv"], A64, sa["mu"], sa["inv"], m, cand,
            wb, wa,
        )
    mp_a, mpi_a = _resolve_side(
        sus_a, wa, m,
        rescore=lambda r, c: _rescore_pairs_ab(
            A64, sa["mu"], sa["inv"], B64, sb["mu"], sb["inv"], m, r, c
        ),
        stats_q=stats_a, stats_t=stats_b, thr_q=thr_a, excl=-1, wt=wb,
        escalate=lambda rows: _row_scan_ab(
            A64, sa["mu"], sa["inv"], B64, sb["mu"], sb["inv"], m, wb, rows
        ),
        profile=profile, oneside_resolve=os_ab,
    )
    mp_b, mpi_b = _resolve_side(
        sus_b, wb, m,
        rescore=lambda r, c: _rescore_pairs_ab(
            B64, sb["mu"], sb["inv"], A64, sa["mu"], sa["inv"], m, r, c
        ),
        stats_q=stats_b, stats_t=stats_a, thr_q=thr_b, excl=-1, wt=wa,
        escalate=lambda rows: _row_scan_ab(
            B64, sb["mu"], sb["inv"], A64, sa["mu"], sa["inv"], m, wa, rows
        ),
        profile=profile, oneside_resolve=os_ba,
    )

    with _phase(profile, "4. Post-Computation [host]"):
        return ABJoinResult(
            mp_a=np.sqrt(np.maximum(2.0 * m * (1.0 - mp_a), 0.0)),
            mpi_a=mpi_a,
            mp_b=np.sqrt(np.maximum(2.0 * m * (1.0 - mp_b), 0.0)),
            mpi_b=mpi_b,
        )


def _row_scan_sided(T64, mu, inv, m, w, excl, rows, side):
    """Exact one-sided f64 scan (numpy; the sided ultra-escalation is
    rare enough that BLAS-per-row is fine)."""
    win = np.lib.stride_tricks.sliding_window_view(T64, m)
    cent = win - mu[:, None]
    fin = np.isfinite(inv)
    bestP = np.full(rows.shape[0], AGGREGATE_INIT, np.float64)
    bestI = np.full(rows.shape[0], INDEX_INIT, np.int32)
    cols = np.arange(w)
    for i, r in enumerate(rows):
        if not fin[r]:
            continue
        with np.errstate(invalid="ignore"):
            P = (cent @ cent[r]) * inv * inv[r]
        delta = cols - r
        zone = delta >= excl if side > 0 else -delta >= excl
        P[~zone | ~fin] = AGGREGATE_INIT
        bi = int(np.argmax(P))
        bestP[i] = P[bi]
        bestI[i] = bi if P[bi] > AGGREGATE_INIT else INDEX_INIT
    return bestP, bestI


def compute_left_right_f64_hybrid(
    T,
    config: Optional[MatrixProfileConfig] = None,
    *,
    m: Optional[int] = None,
    margin: Optional[float] = None,
    profile=None,
):
    """Exact double-precision LEFT/RIGHT profiles via the hybrid tier.

    Returns (MP_left, MPI_left, MP_right, MPI_right) numpy arrays —
    nearest earlier / later neighbor respectively (the per-side
    aggregates of mpx.ops.aggregates.postcompute_left_right, computed
    exactly).  The job grid covers the upper triangle, so the row side
    IS the right profile and the column side the left profile; pass A/B
    run with per-side thresholds and each side resolves independently
    with side-restricted escalation."""
    from mpx.ops.precompute import precompute_statistics, precompute_statistics_numpy

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32, dtype="float64")
    m = config.m
    T64 = np.asarray(T, np.float64)
    n = T64.shape[0]
    config.validate_series(n, T64)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    excl = m // 4
    if margin is None:
        margin = default_margin(m)

    with _phase(profile, "1. Pre-Computation [host f64]"):
        from mpx import native

        if native.is_available():
            # mu/inv only: the hybrid needs just the exact rescoring
            # operands, and the stats-only kernel's vectorized
            # reductions are ~9x faster than the full precompute.
            s64 = native.precompute_stats(T64, m)
        else:
            s64 = precompute_statistics_numpy(T64, m)
        mu64, inv64 = s64["mu"], s64["inv"]

    with _phase(profile, "1. Pre-Computation [device f32]"):
        stats = precompute_statistics(
            T64, m, band=S, chunk=W, dtype="float32", host_stats=s64,
            matmul_only=True,
        )
        jax.block_until_ready(stats.mu)

    grid = make_job_grid(w, S, W)
    r0s, k0s = jnp.asarray(grid.r0), jnp.asarray(grid.k0)
    pw = stats.mu.shape[0]

    sparse = _sparse_ok(stats, w)

    if w <= HYBRID_SMALL_FUSED_W:
        # One-dispatch device chain + one packed fetch (the per-side
        # variant of the self-join fused path above).
        with _phase(profile, "2. Compute [mxu f32 fused A+B]"):
            packed, thr_r, thr_c = _hybrid_small_fused_two(
                stats, r0s, k0s, jnp.float32(margin),
                S=S, W=W, m=m, w=w,
                tr=config.tile_rows, tc=config.tile_cols, pw=pw,
                prec=HYBRID_PRECISION,
            )
            host = np.asarray(packed)
        K = SUSPECT_K
        mk = lambda h: SuspectWindow(
            cnt=h[:, 0], mn=h[:, 1 : 1 + K], mx=h[:, 1 + K :]
        )
        sus_r, sus_c = mk(host[0]), mk(host[1])
    else:
        with _phase(profile, "2. Compute [mxu f32 pass A]"):
            cap = None
            if sparse:
                (thr_r, thr_c), cap = run_max_jobs(
                    stats, r0s, k0s, jnp.float32(margin),
                    S=S, W=W, m=m, w=w, tr=config.tile_rows,
                    tc=config.tile_cols,
                    pw=pw, pwc=pw, combine=False, capture=True,
                )
            else:
                thr_r, thr_c = run_max_jobs(
                    stats, r0s, k0s, jnp.float32(margin),
                    S=S, W=W, m=m, w=w, tr=config.tile_rows,
                    tc=config.tile_cols,
                    pw=pw, pwc=pw, combine=False,
                )
            jax.block_until_ready(thr_c)

        pass_b_tag = "sparse" if sparse else "suspects"
        with _phase(profile, f"2. Compute [mxu f32 pass B {pass_b_tag}]"):
            if sparse:
                sus_r, sus_c = run_suspect_jobs_sparse(
                    stats, thr_r, cap,
                    S=S, W=W, m=m, w=w, tr=config.tile_rows,
                    tc=config.tile_cols,
                    thr_col=thr_c, combine=False, profile=profile,
                )
                cap = None
            else:
                sus_r, sus_c = run_suspect_jobs(
                    stats, thr_r, r0s, k0s,
                    S=S, W=W, m=m, w=w, tr=config.tile_rows,
                    tc=config.tile_cols,
                    thr_col=thr_c, combine=False,
                )
            sus_r, sus_c = jax.device_get((sus_r, sus_c))

    from mpx import native as _native

    rescore = lambda r, c: _rescore_pairs(T64, mu64, inv64, m, r, c)
    oneside = None
    if _native.is_available():
        oneside = lambda cand: _native.resolve_slots_ab(
            T64, mu64, inv64, T64, mu64, inv64, m, cand, w, w
        )
    # row side = RIGHT profile (later neighbors)
    rP, rI = _resolve_side(
        sus_r, w, m, rescore=rescore,
        stats_q=stats, stats_t=stats, thr_q=thr_r, excl=excl, wt=w,
        escalate=lambda rows: _row_scan_sided(T64, mu64, inv64, m, w, excl,
                                              rows, +1),
        profile=profile, side=+1, oneside_resolve=oneside,
    )
    # column side = LEFT profile (earlier neighbors)
    lP, lI = _resolve_side(
        sus_c, w, m, rescore=rescore,
        stats_q=stats, stats_t=stats, thr_q=thr_c, excl=excl, wt=w,
        escalate=lambda rows: _row_scan_sided(T64, mu64, inv64, m, w, excl,
                                              rows, -1),
        profile=profile, side=-1, oneside_resolve=oneside,
    )

    with _phase(profile, "4. Post-Computation [host]"):
        to_d = lambda P: np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0))
        return to_d(lP), lI, to_d(rP), rI


def _row_scan_ab(Tq, muq, invq, Tt, mut, invt, m, wt, rows):
    """Exact f64 best target neighbor per query row (no exclusion)."""
    from mpx import native

    if native.is_available():
        return native.row_scan_ab(Tq, muq, invq, Tt, mut, invt, m, wt, -1, rows)

    wint = np.lib.stride_tricks.sliding_window_view(Tt, m)
    winq = np.lib.stride_tricks.sliding_window_view(Tq, m)
    cent_t = wint - mut[:, None]
    fin = np.isfinite(invt)
    bestP = np.full(rows.shape[0], AGGREGATE_INIT, np.float64)
    bestI = np.full(rows.shape[0], INDEX_INIT, np.int32)
    for i, r in enumerate(rows):
        if not np.isfinite(invq[r]):
            continue
        q = winq[r] - muq[r]
        with np.errstate(invalid="ignore"):
            P = (cent_t @ q) * invt * invq[r]
        P[~fin] = AGGREGATE_INIT
        bi = int(np.argmax(P))
        bestP[i] = P[bi]
        bestI[i] = bi if P[bi] > AGGREGATE_INIT else INDEX_INIT
    return bestP, bestI
