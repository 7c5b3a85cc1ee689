"""Multi-dimensional matrix profile (mSTAMP, Yeh/Kamgar/Keogh KDD'17).

Beyond reference parity — /root/reference computes 1-D self-joins only
(kernel/MatrixProfileKernelTiled.cpp); this module extends the same job
decomposition to d-dimensional series: for every subsequence pair the
z-normalized distance is computed PER DIMENSION, the per-pair distances
are sorted across dimensions, and the k-dimensional distance is the mean
of the k smallest — giving d stacked profiles ``PMP[k-1]`` (the best
k-dimensional motif ends at ``argmin(PMP[k-1])``).

Design
------
* The d per-dimension correlation tiles of a (S x W) job are ONE batched
  matmul over stacked unit-window panels: ``P[t] = U_r[t] @ U_c[t]^T``
  (einsum ``dsm,dwm->dsw``) — the batch dimension rides the MXU schedule
  for free, so the sweep costs ~d x the 1-D mxu kernel.
* The cross-dimension sort runs over the MAJOR axis of the (d, S, W)
  block (d is small: 2..64): XLA lowers it to a d-lane compare-exchange
  network over fully vectorized (S, W) lanes — never a minor-axis sort
  (see mpx/kernels/mxu.py compaction notes).
* Per-k aggregation reuses the 1-D epilogue shape: min + iota-min index
  tie-break, min-merged into carried (d, L) profile arrays inside one
  ``lax.scan`` over the job grid (no host round trips).

Zero-variance contract (matches mpx.analysis.mass / ops/precompute):
a dimension whose row OR column window is (numerically) constant gets
distance +inf for that pair — flat windows never match in z-norm space —
so such pairs sort those dimensions last and drop out of low-k profiles.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.kernels.mxu import _PRECISION
from mpx.ops.precompute import precompute_statistics_numpy

_BIG_I = np.int32(2**30)


class MultiProfile(NamedTuple):
    """Stacked k-dimensional profiles: row ``k-1`` is the k-dim profile."""

    PMP: np.ndarray   # (d, w) float — k-dim z-norm distances
    PMPI: np.ndarray  # (d, w) int32 — matching subsequence index (-1: none)


def _stack_stats(T: np.ndarray, m: int, pw: int, dt):
    """Per-dimension host-f64 statistics, padded/stacked for the device:
    (d, pw + m - 1) series, (d, pw) mu, (d, pw) inv (0 where degenerate
    or padded — operand rows are zeroed; masks carry validity)."""
    d, n = T.shape
    w = n - m + 1
    Tb = np.zeros((d, pw + m - 1), dtype=dt)
    mub = np.zeros((d, pw), dtype=dt)
    invb = np.zeros((d, pw), dtype=dt)
    finb = np.zeros((d, pw), dtype=bool)
    for t in range(d):
        s = precompute_statistics_numpy(T[t].astype(np.float64), m)
        fin = np.isfinite(s["inv"])
        Tb[t, : n] = T[t].astype(dt)
        mub[t, : w] = s["mu"].astype(dt)
        invb[t, : w] = np.where(fin, s["inv"], 0.0).astype(dt)
        finb[t, : w] = fin
    return Tb, mub, invb, finb


def _panels(Tb, mub, invb, o, count: int, m: int):
    """Stacked unit-window panels (d, count, m) at offset ``o`` — the
    batched analog of mpx.kernels.mxu._windows (m static shifted slices,
    no gather)."""
    d = Tb.shape[0]
    zero = np.int32(0)
    Tseg = jax.lax.dynamic_slice(Tb, (zero, o), (d, count + m - 1))
    mu = jax.lax.dynamic_slice(mub, (zero, o), (d, count))
    inv = jax.lax.dynamic_slice(invb, (zero, o), (d, count))
    cols = [Tseg[:, j : j + count] for j in range(m)]
    U = jnp.stack(cols, axis=2)
    return (U - mu[:, :, None]) * inv[:, :, None]


def _network_pairs(n: int) -> list:
    """Batcher odd-even mergesort comparator pairs for ``n`` lanes
    (indices beyond a power-of-two pad are pruned: virtual +inf pads
    sort to the end, so their comparators are no-ops).  5 comparators
    at n=4, 19 at n=8."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def _net_sort(x, descending: bool):
    """Ascending (or descending) sort over the major axis via an
    explicit compare-exchange network: each comparator is one
    jnp.minimum + jnp.maximum over the fully vectorized (S, W) lanes —
    5 comparators at d=4 versus XLA's general variadic-sort lowering.
    Exact for the downstream prefix means (any correct sort yields the
    same prefix multisets).  Falls back to jnp.sort beyond 8 lanes
    (comparator count grows O(d log^2 d); the network stops paying)."""
    d = x.shape[0]
    if d > 8 or os.environ.get("MPX_MSTAMP_NETSORT", "1") == "0":
        s = jnp.sort(x, axis=0)
        return s[::-1] if descending else s
    rows = [x[i] for i in range(d)]
    for i, j in _network_pairs(d):
        lo = jnp.minimum(rows[i], rows[j])
        hi = jnp.maximum(rows[i], rows[j])
        rows[i], rows[j] = lo, hi
    if descending:
        rows.reverse()
    return jnp.stack(rows)


def _order_dims(dist, include: tuple, discords: bool):
    """Per-pair dimension ordering for the prefix means.

    Default: ascending sort (k-dim distance = mean of the k smallest).
    ``discords=True``: descending (mean of the k LARGEST — the mSTAMP
    discord-search variant).  ``include``: those dimensions are forced
    to the front (always part of the chosen k-subset; the constrained
    search of the mSTAMP paper), each group sorted internally."""
    d = dist.shape[0]

    def srt(x):
        return _net_sort(x, discords)

    if not include:
        return srt(dist)
    inc = np.asarray(include, np.int32)
    rest = np.asarray([t for t in range(d) if t not in set(include)],
                      np.int32)
    parts = [srt(dist[inc])]
    if rest.size:
        parts.append(srt(dist[rest]))
    return jnp.concatenate(parts, axis=0)


def _scan_jobs(Tb, mub, invb, finb, r0s, k0s, *,
               S: int, W: int, m: int, w: int, excl: int, dt,
               include: tuple = (), discords: bool = False):
    """The shared job-scan body: lax.scan over (r0, k0) jobs, min-merging
    each job's per-k tile aggregates into carried (d, L) arrays.  Traced
    by both the single-device jit and each shard of the mesh runner."""
    d = Tb.shape[0]
    L = w + S + W  # same padded length as driver._agg_length
    dtype = jnp.dtype(dt)
    inf = jnp.asarray(jnp.inf, dtype)
    vals0 = jnp.full((d, L), jnp.inf, dtype)
    idxs0 = jnp.full((d, L), -1, jnp.int32)
    kdiv = (1.0 + jnp.arange(d, dtype=dtype))[:, None, None]

    def merge(vals, idxs, new_v, new_i, o):
        zero = np.int32(0)
        size = new_v.shape[1]
        cur_v = jax.lax.dynamic_slice(vals, (zero, o), (d, size))
        cur_i = jax.lax.dynamic_slice(idxs, (zero, o), (d, size))
        take = new_v < cur_v
        mv = jnp.where(take, new_v, cur_v)
        mi = jnp.where(take, new_i, cur_i)
        return (
            jax.lax.dynamic_update_slice(vals, mv, (zero, o)),
            jax.lax.dynamic_update_slice(idxs, mi, (zero, o)),
        )

    def body(carry, job):
        vals, idxs = carry
        r0, k0 = job
        c0 = r0 + k0
        Ur = _panels(Tb, mub, invb, r0, S, m)
        Uc = _panels(Tb, mub, invb, c0, W, m)
        fr = jax.lax.dynamic_slice(finb, (np.int32(0), r0), (d, S))
        fc = jax.lax.dynamic_slice(finb, (np.int32(0), c0), (d, W))

        # One batched matmul for all d dimension tiles.
        P = jnp.einsum("dsm,dwm->dsw", Ur, Uc,
                       preferred_element_type=dtype, precision=_PRECISION)
        dist = jnp.sqrt(jnp.maximum(2.0 * m * (1.0 - P), 0.0))
        dist = jnp.where(fr[:, :, None] & fc[:, None, :], dist, inf)

        # Order dimensions per pair (major axis) and prefix-average:
        # Dk[k-1] = mean of the k best per-dim distances (see
        # _order_dims for the include/discords variants).
        Dk = jnp.cumsum(_order_dims(dist, include, discords), axis=0) / kdiv

        rows = r0 + jnp.arange(S, dtype=jnp.int32)[:, None]
        cols = c0 + jnp.arange(W, dtype=jnp.int32)[None, :]
        valid = ((cols - rows >= excl) & (rows <= w - 1) & (cols <= w - 1))
        Dk = jnp.where(valid[None, :, :], Dk, inf)

        row_v = jnp.min(Dk, axis=2)
        ri = jnp.min(jnp.where(Dk == row_v[:, :, None], cols[None], _BIG_I),
                     axis=2)
        row_i = jnp.where(jnp.isfinite(row_v), ri.astype(jnp.int32),
                          jnp.int32(-1))
        col_v = jnp.min(Dk, axis=1)
        ci = jnp.min(jnp.where(Dk == col_v[:, None, :], rows[None], _BIG_I),
                     axis=1)
        col_i = jnp.where(jnp.isfinite(col_v), ci.astype(jnp.int32),
                          jnp.int32(-1))

        vals, idxs = merge(vals, idxs, row_v, row_i, r0)
        vals, idxs = merge(vals, idxs, col_v, col_i, c0)
        return (vals, idxs), None

    (vals, idxs), _ = jax.lax.scan(body, (vals0, idxs0), (r0s, k0s))
    return vals, idxs


@partial(
    jax.jit,
    static_argnames=("S", "W", "m", "w", "excl", "dt", "include",
                     "discords"),
)
def _run_mstamp_jobs(Tb, mub, invb, finb, r0s, k0s, *,
                     S: int, W: int, m: int, w: int, excl: int, dt,
                     include: tuple = (), discords: bool = False):
    vals, idxs = _scan_jobs(Tb, mub, invb, finb, r0s, k0s,
                            S=S, W=W, m=m, w=w, excl=excl, dt=dt,
                            include=include, discords=discords)
    return vals[:, :w], idxs[:, :w]


def _run_mstamp_sharded(Tb, mub, invb, finb, grid, *,
                        num_shards: int, S: int, W: int, m: int, w: int,
                        excl: int, dt, mesh=None,
                        include: tuple = (), discords: bool = False):
    """Job-sharded mSTAMP over a 1-D device mesh — the same round-robin
    job split + stacked-partial merge as mpx.parallel.sharding, with a
    MIN/argmin (distance-space) merge over the device axis."""
    from jax.sharding import PartitionSpec as P

    from mpx.config import pad_job_grid
    from mpx.parallel.mesh import default_mesh

    if mesh is None:
        mesh = default_mesh(num_shards)
    grid = pad_job_grid(grid, num_shards, dummy_r0=w)
    per_dev = grid.r0.shape[0] // num_shards
    order = np.arange(grid.r0.shape[0]).reshape(per_dev, num_shards).T.reshape(-1)
    r0s = jnp.asarray(grid.r0[order].reshape(num_shards, per_dev))
    k0s = jnp.asarray(grid.k0[order].reshape(num_shards, per_dev))

    def local(Tb, mub, invb, finb, r, k):
        vals, idxs = _scan_jobs(Tb, mub, invb, finb, r[0], k[0],
                                S=S, W=W, m=m, w=w, excl=excl, dt=dt,
                                include=include, discords=discords)
        return vals[None], idxs[None]

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("jobs"), P("jobs")),
        out_specs=P("jobs"),
        check_vma=False,
    )

    @jax.jit
    def merged(Tb, mub, invb, finb, r, k):
        vals, idxs = shard_fn(Tb, mub, invb, finb, r, k)  # (ndev, d, L)
        best = jnp.argmin(vals, axis=0)  # first (lowest-rank) minimum
        v = jnp.take_along_axis(vals, best[None], axis=0)[0]
        i = jnp.take_along_axis(idxs, best[None], axis=0)[0]
        return v[:, :w], i[:, :w]

    return merged(Tb, mub, invb, finb, r0s, k0s)


def compute_multidim_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    include=None,
    discords: bool = False,
) -> MultiProfile:
    """mSTAMP self-join of a (d, n) multi-dimensional series.

    Returns :class:`MultiProfile` with ``PMP[k-1, i]`` = the smallest
    mean-of-k-best-dimension z-norm distance from subsequence ``i`` to
    any non-trivial subsequence, and ``PMPI[k-1, i]`` its index.  Row 0
    (k=1) equals the best single-dimension profile; row d-1 (k=d) the
    all-dimensions profile.  ``config`` supplies dtype and the
    (band, chunk) schedule; shape knobs follow the 1-D driver.

    ``include``: dimension indices that must be part of every chosen
    k-subset (the mSTAMP paper's constrained search).  ``discords=True``
    averages the k LARGEST per-dim distances instead (multi-dimensional
    discord search: discords = argmax of the resulting profile).
    """
    from mpx.dtypes import canonical_dtype, needs_x64, x64_scope
    from mpx.ops.precompute import _padded_width

    T = np.asarray(T)
    if T.ndim == 1:
        T = T[None, :]
    if T.ndim != 2:
        raise ValueError(f"expected (d, n) series, got shape {T.shape}")
    d, n = T.shape
    if d > n:
        raise ValueError(
            f"series is (d={d}, n={n}) — dimensions in rows; transpose?")
    inc = tuple(sorted(int(t) for t in include)) if include else ()
    if inc and not all(0 <= t < d for t in inc):
        raise ValueError(f"include={inc} out of range for d={d}")
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("mSTAMP has one kernel (batched windows matmul); "
                         "use kernel='auto'")
    for t in range(d):  # NaN/inf in ANY dimension poisons correlations
        config.validate_series(n, T[t])
    if config.input_quant is not None:
        from mpx.io.apfixed import quantize

        T = quantize(np.asarray(T, np.float64), config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)
    pw = _padded_width(w, S, W)

    Tb, mub, invb, finb = _stack_stats(T, m, pw, dt)
    grid = make_job_grid(w, S, W)
    num_shards = config.num_shards or 1
    with x64_scope(needs_x64(dt)):
        if num_shards > 1:
            vals, idxs = _run_mstamp_sharded(
                jnp.asarray(Tb), jnp.asarray(mub), jnp.asarray(invb),
                jnp.asarray(finb), grid,
                num_shards=num_shards,
                S=S, W=W, m=m, w=w, excl=m // 4, dt=str(dt),
                include=inc, discords=discords,
            )
        else:
            vals, idxs = _run_mstamp_jobs(
                jnp.asarray(Tb), jnp.asarray(mub), jnp.asarray(invb),
                jnp.asarray(finb),
                jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                S=S, W=W, m=m, w=w, excl=m // 4, dt=str(dt),
                include=inc, discords=discords,
            )
        PMP = np.asarray(vals)
        PMPI = np.asarray(idxs)
    return MultiProfile(PMP=PMP, PMPI=PMPI)


def multidim_motif(profile: MultiProfile, k: int) -> tuple[int, int, float]:
    """The best k-dimensional motif pair from an mSTAMP result:
    ``(i, j, distance)`` with i the argmin of the k-dim profile."""
    P, I = profile.PMP[k - 1], profile.PMPI[k - 1]
    if not np.isfinite(P).any():
        raise ValueError(
            f"the k={k} profile has no valid pairs (a flat dimension "
            "makes the all-dimensions profile +inf; see docs/numerics.md)")
    i = int(np.nanargmin(np.where(np.isfinite(P), P, np.nan)))
    return i, int(I[i]), float(P[i])


def multidim_discord(profile: MultiProfile, k: int) -> tuple[int, float]:
    """The strongest k-dimensional discord from a ``discords=True``
    mSTAMP result: ``(i, distance)`` with i the argmax of the k-dim
    profile (the subsequence farthest from its nearest neighbor)."""
    P = profile.PMP[k - 1]
    if not np.isfinite(P).any():
        raise ValueError(
            f"the k={k} profile has no valid pairs (a flat dimension "
            "masks pairs entirely in discord mode; see docs/numerics.md)")
    i = int(np.nanargmax(np.where(np.isfinite(P), P, np.nan)))
    return i, float(P[i])


class MdlResult(NamedTuple):
    best_k: int            # dimensionality with the largest bit save
    bitsaves: np.ndarray   # (d,) float — bits saved at each k (1-based)
    motifs: list           # per k: (i, j) motif pair used
    subspaces: list        # per k: the k dimension indices used


def multidim_mdl(T, m: int, *, profile: MultiProfile | None = None,
                 bits: int = 4, include=None,
                 config=None) -> MdlResult:
    """WHICH dimensionality k is meaningful: MDL-based unconstrained
    search (the mSTAMP paper's third tool, Matrix Profile VI §IV-C).

    For each k, the best k-dim motif pair is scored by how many bits
    the pair SAVES when one subsequence is encoded relative to the
    other instead of raw.  Each selected dimension's subsequences are
    z-normalized and discretized to ``bits`` bits on the pair's shared
    min-max grid; encoding the residual ``disc(B) - disc(A)`` costs
    ``m * log2(u) + u * bits`` (u = distinct residual values, the
    second term the dictionary), versus ``m * bits`` raw:

        bitsave(k) = sum over the k subspace dims of
                     m*bits - (m*log2(u_t) + u_t*bits)

    Correlated dimensions have few residual values (large save); a
    noise dimension's residuals are spread (negative save) — so the
    save peaks at the natural dimensionality and ``best_k`` is its
    argmax.  A z-degenerate (flat) dimension contributes ``-m*bits``
    (it can never justify itself).  Host-side O(d^2 m) given the
    profile; computes the mSTAMP profile first when not supplied."""
    T = np.asarray(T, np.float64)
    if T.ndim == 1:
        T = T[None, :]
    d, n = T.shape
    if bits < 1:
        raise ValueError("bits must be >= 1")
    if profile is None:
        profile = compute_multidim_profile(T, m, config=config,
                                           include=include)
    if profile.PMP.shape[0] != d:
        raise ValueError(
            f"profile has {profile.PMP.shape[0]} rows for d={d} series")

    from mpx.ops.precompute import ZERO_VARIANCE_REL

    def _dl_given(a: np.ndarray, b: np.ndarray) -> float:
        """Bits saved encoding z-norm(b) relative to z-norm(a)."""
        ca, cb = a - a.mean(), b - b.mean()
        sa, sb = ca @ ca, cb @ cb
        if sa <= ZERO_VARIANCE_REL * (a @ a) or \
           sb <= ZERO_VARIANCE_REL * (b @ b):
            return -float(m * bits)
        za, zb = ca / np.sqrt(sa), cb / np.sqrt(sb)
        lo = min(za.min(), zb.min())
        hi = max(za.max(), zb.max())
        scale = (2**bits - 1) / (hi - lo) if hi > lo else 0.0
        da = np.round((za - lo) * scale).astype(np.int64)
        db = np.round((zb - lo) * scale).astype(np.int64)
        u = np.unique(db - da).shape[0]
        return float(m * bits - (m * np.log2(max(u, 1)) + u * bits))

    bitsaves = np.full(d, -np.inf)
    motifs, subspaces = [], []
    for k in range(1, d + 1):
        try:
            i, j, _ = multidim_motif(profile, k)
        except ValueError:  # no valid pairs at this k (flat dimension)
            motifs.append(None)
            subspaces.append(None)
            continue
        dims = multidim_subspace(T, m, i, j, k, include=include)
        bitsaves[k - 1] = sum(
            _dl_given(T[t, i : i + m], T[t, j : j + m]) for t in dims)
        motifs.append((i, j))
        subspaces.append(dims)
    if not np.isfinite(bitsaves).any():
        raise ValueError("no dimensionality has a valid motif pair")
    best_k = int(np.argmax(bitsaves)) + 1
    return MdlResult(best_k=best_k, bitsaves=bitsaves,
                     motifs=motifs, subspaces=subspaces)


def multidim_subspace(T, m: int, i: int, j: int, k: int,
                      include=None, discords: bool = False) -> np.ndarray:
    """WHICH k dimensions form the motif (or discord) pair ``(i, j)``:
    the mSTAMP subspace — per-dimension z-norm distances between
    subsequences ``i`` and ``j``, sorted ascending (descending for
    discord mode), with any ``include`` dimensions pinned first; the
    first k dimension indices are returned (the subset whose MEAN is
    exactly the k-dim profile value at ``i``).

    Host-side O(d*m): two subsequences only — no sweep.  Flat
    (zero-variance) subsequences get +inf distance and therefore sort
    last (first in discord mode they sort last as well — an undefined
    correlation can never justify a subspace).
    """
    T = np.asarray(T, np.float64)
    if T.ndim == 1:
        T = T[None, :]
    d, n = T.shape
    if not (1 <= k <= d):
        raise ValueError(f"k={k} out of range for d={d}")
    for p in (i, j):
        if not (0 <= p <= n - m):
            raise ValueError(f"subsequence {p} out of range (w={n - m + 1})")
    inc = tuple(sorted(int(t) for t in include)) if include else ()
    if inc and not all(0 <= t < d for t in inc):
        raise ValueError(f"include={inc} out of range for d={d}")
    # len(inc) may exceed k: like the device ordering, the prefix then
    # takes the k closest INCLUDE dimensions

    from mpx.ops.precompute import ZERO_VARIANCE_REL

    dist = np.full(d, np.inf)
    for t in range(d):
        a, b = T[t, i : i + m], T[t, j : j + m]
        ca, cb = a - a.mean(), b - b.mean()
        sa, sb = ca @ ca, cb @ cb
        # the kernels' RELATIVE zero-variance clamp, so a numerically-
        # constant dimension the profile masked never enters the subspace
        if sa > ZERO_VARIANCE_REL * (a @ a) and sb > ZERO_VARIANCE_REL * (b @ b):
            p = np.clip((ca @ cb) / np.sqrt(sa * sb), -1.0, 1.0)
            dist[t] = np.sqrt(2.0 * m * (1.0 - p))

    fin = np.isfinite(dist)
    key = np.where(fin, -dist if discords else dist, np.inf)
    order = np.argsort(key, kind="stable")
    if inc:
        # mirror _order_dims: include dims first (sorted internally),
        # then the rest
        inc_sorted = sorted(inc, key=lambda t: key[t])
        rest = [t for t in order if t not in set(inc)]
        order = np.asarray(inc_sorted + rest)
    return order[:k].astype(np.int64)
