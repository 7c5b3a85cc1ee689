"""Driver: job scheduling, on-device merging, and the public API.

The analog of the reference host driver's ``RunMatrixProfileKernel``
(host/MatrixProfileHost.cpp:54-160), re-designed for XLA:

* the per-iteration host loop that round-robins diagonal chunks onto
  compute units becomes a single jit-compiled ``lax.scan`` over the job
  grid (one compilation, any problem size);
* the host-side ``UpdateAggregates`` merge loop becomes on-device
  max-merges of each job's output windows into global row/column
  profiles (no host round trips inside the hot loop);
* kernel replication over DDR banks becomes job-list sharding over a
  device mesh (see :mod:`mpx.parallel.sharding`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import AGGREGATE_INIT, canonical_dtype
from mpx.kernels import band_geometry, get_sweep_fn, resolve_kernel
from mpx.ops.aggregates import init_aggregates, merge_window, postcompute
from mpx.ops.precompute import precompute_statistics
from mpx.types import Aggregates, Stats


def _agg_length(w: int, S: int, W: int) -> int:
    # Tail windows reach at most c0 + S + W with c0 <= w - 1.
    return w + S + W


# Small-problem fused path: below these widths a one-pass run executes
# as ONE jitted dispatch (device f64 precompute -> job sweeps ->
# postcompute) with one packed fetch, instead of three-plus dispatches
# and an O(n) statistics transfer — the reference finishes tiny problems
# in one kernel launch (host/MatrixProfileHost.cpp).  f64 is capped
# lower because its fused precompute and sweeps are costlier per
# window.  Neither cap has been tuned on the GPU yet.
SMALL_FUSED_MAX_W = 1 << 19
SMALL_FUSED_MAX_W_F64 = 1 << 16


@partial(
    jax.jit,
    static_argnames=("S", "W", "m", "w", "kernel", "dtype", "tr", "tc"),
)
def run_jobs(
    stats: Stats,
    r0s: jax.Array,
    k0s: jax.Array,
    *,
    S: int,
    W: int,
    m: int,
    w: int,
    kernel: str,
    dtype: str,
    tr: int = 8,
    tc: int = 2048,
):
    """Sweep all jobs sequentially on one device, merging aggregates
    on-device.  Returns (row Aggregates, column Aggregates), padded to
    _agg_length(w, S, W)."""
    geom = band_geometry(S, W, m, w, tr, tc)
    dt = canonical_dtype(dtype)
    L = _agg_length(w, S, W)
    return job_scan(stats, r0s, k0s, geom=geom, dt=dt, kernel=kernel, L=L)


def job_scan(stats, r0s, k0s, *, geom, dt, kernel, L):
    """The shared job-scan body (single-chip run_jobs, the fused
    small-n tier, and each shard of run_jobs_sharded all trace this):
    lax.scan over (r0, k0) jobs, max-merging every job's band output
    into carried (L,) row/column aggregate arrays."""
    sweep = get_sweep_fn(kernel)

    rows0 = init_aggregates(L, dt, AGGREGATE_INIT)
    cols0 = init_aggregates(L, dt, AGGREGATE_INIT)

    def body(carry, job):
        rows, cols = carry
        r0, k0 = job
        out = sweep(stats, r0, k0, geom, dt)
        rows = merge_window(rows, out.row, r0)
        cols = merge_window(cols, out.col, r0 + k0)
        return (rows, cols), None

    (rows, cols), _ = jax.lax.scan(body, (rows0, cols0), (r0s, k0s))
    return rows, cols


@partial(
    jax.jit,
    static_argnames=(
        "S", "W", "m", "w", "pw", "kernel", "dtype",
        "tr", "tc", "left_right", "use_windows",
    ),
)
def run_fused_small(
    T64,
    r0s,
    k0s,
    *,
    S: int,
    W: int,
    m: int,
    w: int,
    pw: int,
    kernel: str,
    dtype: str,
    tr: int = 8,
    tc: int = 2048,
    left_right: bool = False,
    use_windows: bool = False,
):
    """One-dispatch end-to-end profile for small problems: on-device f64
    statistics (ops/precompute._precompute_jax_f64), the job sweep scan,
    and the final merge all inside a single executable.  Must be called
    inside an x64 scope (the f64 statistics trace needs it even for f32
    compute dtypes)."""
    from mpx.ops.precompute import _precompute_jax_f64, build_windows

    dt = canonical_dtype(dtype)
    mu, df, dg, inv, qt0 = _precompute_jax_f64(T64, m)

    def pad(x, width):
        return jnp.pad(x.astype(dt), (0, width - x.shape[0]))

    stats = Stats(
        T=pad(T64, pw + m - 1),
        mu=pad(mu, pw),
        df=pad(df, pw),
        dg=pad(dg, pw),
        inv=pad(inv, pw),
        qt0=pad(qt0, pw),
    )
    if use_windows:
        stats = stats._replace(windows=build_windows(stats, m))

    geom = band_geometry(S, W, m, w, tr, tc)
    rows, cols = job_scan(
        stats, r0s, k0s, geom=geom, dt=dt, kernel=kernel,
        L=_agg_length(w, S, W),
    )
    if left_right:
        from mpx.ops.aggregates import postcompute_left_right

        out = postcompute_left_right(rows, cols, m, w)
    else:
        out = postcompute(rows, cols, m, w)
    # Pack every output into ONE array, fetched once.  Indices are
    # value-converted (NOT bitcast: int32 patterns land in the f32
    # denormal range, which devices may flush to zero) — exact because
    # the fused caps keep every index < 2^19 << 2^24, the f32
    # integer-exact limit; _unpack_fused rounds them back.
    def enc(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            x = x.astype(dt)
        return x

    return jnp.stack([enc(x) for x in out])


def _unpack_fused(host: np.ndarray, left_right: bool):
    """Host-side inverse of run_fused_small's output packing."""

    def dec_i(row):
        return np.rint(row).astype(np.int32)

    if left_right:
        return host[0], dec_i(host[1]), host[2], dec_i(host[3])
    return host[0], dec_i(host[1])


def compute_matrix_profile(
    T,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    stats: Optional[Stats] = None,
    profile=None,
    left_right: bool = False,
):
    """Compute the self-join matrix profile of ``T``.

    Returns (MP, MPI): z-normalized Euclidean distances and int32
    nearest-neighbor indices, matching the reference semantics
    (untouched entries: sqrt(2m(1+1e12)) / -1).  Runs routed through
    the hybrid tier (float64, and float32 at w >= HYBRID32_MIN_W)
    return host numpy arrays — the exact rescoring ends on the host —
    as does the small-problem fused tier (w <= SMALL_FUSED_MAX_W*),
    whose outputs arrive packed in a single device fetch; the remaining
    one-pass device paths return jax arrays.  Use np.asarray for a
    backend-agnostic consumer.

    With ``left_right=True`` returns (MP_left, MPI_left, MP_right,
    MPI_right) instead — the nearest *earlier* / *later* neighbor
    profiles (used for time-ordered anomaly detection; they are the
    framework's row/column aggregates before the final merge).

    ``profile`` optionally takes a :class:`mpx.utils.profile.BenchmarkProfile`
    to record per-phase timings like the reference's report
    (include/host/BenchmarkProfile.hpp).
    """
    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m

    T = np.asarray(T) if not isinstance(T, jax.Array) else T
    n = T.shape[0]
    config.validate_series(n, T)
    if config.input_quant is not None:
        # ap_fixed input tier: the reference's FileIO double->ap cast
        # (range check + round-toward-zero; mpx/io/apfixed.py), then the
        # standard exact pipeline on the quantized values.
        from mpx.io.apfixed import quantize

        T = quantize(np.asarray(T), config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)
    num_shards_ = config.num_shards or 1
    kernel = resolve_kernel(
        config.kernel, dt, m,
        allow_hybrid=(
            stats is None
            and (
                # jobs mode: hybrid covers left/right single-device
                (config.shard_mode == "jobs"
                 and not (left_right and num_shards_ > 1))
                # ring mode: run_ring_hybrid_f64 serves both f64 and
                # large-w f32 (exact distances cast down); left/right
                # stays on the strict tier
                or (config.shard_mode == "ring" and not left_right)
            )
        ),
        w=w,
    )

    from mpx.dtypes import needs_x64, x64_scope
    from mpx.utils.profile import phase as _phase

    if kernel == "hybrid":
        if canonical_dtype(config.dtype) not in (
            np.dtype(np.float64), np.dtype(np.float32),
        ):
            raise ValueError("kernel='hybrid' requires dtype float32/float64")
        if stats is not None:
            raise ValueError(
                "kernel='hybrid' does not support externally-provided stats"
            )
        if left_right and num_shards_ > 1:
            raise ValueError(
                "hybrid left/right profiles are single-device; drop "
                "--shards or use --kernel mxu"
            )
        # The hybrid tier computes the exact f64 profile either way; a
        # float32 request just casts the (exact) distances down (see
        # mpx.kernels.resolve_kernel for the widths routed here).
        f32_out = canonical_dtype(config.dtype) == np.dtype(np.float32)
        if f32_out:
            import dataclasses

            config = dataclasses.replace(config, dtype="float64")
        # numpy outputs: staying off-device avoids the f32 canonicalization
        # trap for f64 results outside an x64 scope.
        if left_right:
            from mpx.hybrid import compute_left_right_f64_hybrid

            out = compute_left_right_f64_hybrid(T, config, profile=profile)
            if f32_out:
                out = tuple(
                    o.astype(np.float32) if o.dtype == np.float64 else o
                    for o in out
                )
            return out
        if config.shard_mode == "ring":
            # explicit kernel='hybrid' with sharded inputs
            from mpx.parallel.ring import run_ring_hybrid_f64

            MP, MPI = run_ring_hybrid_f64(
                np.asarray(T), m, num_shards=num_shards_,
                band=config.band, chunk=config.chunk, profile=profile,
            )
        else:
            from mpx.hybrid import compute_matrix_profile_f64_hybrid

            MP, MPI = compute_matrix_profile_f64_hybrid(
                T, config, profile=profile
            )
        if f32_out:
            MP = MP.astype(np.float32)
        return MP, MPI

    x64 = needs_x64(dt)

    num_shards = config.num_shards
    # shard_mode='ring' is an explicit request (default 'jobs'); honor it
    # on any mesh size — a 1-device "ring" is how the sharded-inputs tier
    # is benchmarked on one device.
    if config.shard_mode == "ring":
        num_shards = num_shards or 1
        from mpx.parallel.ring import run_ring_hybrid_f64, run_ring_sharded

        if left_right:
            raise ValueError("ring sharding does not support --left-right")
        if stats is not None:
            raise ValueError(
                "ring sharding restages statistics internally and cannot "
                "take externally-provided stats (they would be silently "
                "ignored)"
            )
        Th = T if isinstance(T, np.ndarray) else np.asarray(T)
        if dt == np.dtype(np.float64):
            # The flagship dtype over sharded inputs: the hybrid
            # evidence chain (exact f64) on the ring schedule.
            return run_ring_hybrid_f64(
                Th, m, num_shards=num_shards, band=S, chunk=W,
                profile=profile,
            )
        with _phase(profile, f"2. Compute [ring sharded x{num_shards}]"):
            MP, MPI = run_ring_sharded(
                Th, m, num_shards=num_shards, band=S, chunk=W,
                dtype=str(dt),
            )
            return MP, MPI

    fused_w_cap = (
        SMALL_FUSED_MAX_W_F64
        if dt == np.dtype(np.float64)
        else SMALL_FUSED_MAX_W
    )
    # The packed single-fetch output stores indices as f32 values;
    # exactness requires every index < 2^24 regardless of env overrides.
    fused_w_cap = min(fused_w_cap, (1 << 23))
    if (
        stats is None
        and (num_shards is None or num_shards <= 1)
        # explicit grouping (any non-None value, including the
        # grouping-off request 0) wins over fusing
        and config.dispatch_group is None
        and w <= fused_w_cap
    ):
        from mpx.ops.precompute import WINDOWS_BUDGET, _padded_width

        pw = _padded_width(w, S, W)
        use_windows = kernel == "mxu" and pw * m * dt.itemsize <= WINDOWS_BUDGET
        grid = make_job_grid(w, S, W)
        with _phase(profile, f"1-3. Fused end-to-end [{kernel}]"), x64_scope(True):
            T64 = jnp.asarray(np.asarray(T, np.float64))
            packed = run_fused_small(
                T64,
                jnp.asarray(grid.r0),
                jnp.asarray(grid.k0),
                S=S, W=W, m=m, w=w, pw=pw,
                kernel=kernel, dtype=str(dt),
                tr=config.tile_rows, tc=config.tile_cols,
                left_right=left_right, use_windows=use_windows,
            )
            # One sync + one fetch; numpy outputs (like the hybrid tier).
            host = np.asarray(packed)
        return _unpack_fused(host, left_right)

    if stats is None:
        with _phase(profile, "1. Pre-Computation [device]"):
            stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt)
            jax.block_until_ready(stats)

    grid = make_job_grid(w, S, W)

    if num_shards is not None and num_shards > 1:
        from mpx.parallel.sharding import run_jobs_sharded

        with _phase(profile, f"2. Compute [{kernel}, sharded x{num_shards}]"), x64_scope(x64):
            rows, cols = run_jobs_sharded(
                stats,
                grid,
                num_shards=num_shards,
                S=S,
                W=W,
                m=m,
                w=w,
                kernel=kernel,
                dtype=str(dt),
                tr=config.tile_rows,
                tc=config.tile_cols,
            )
            jax.block_until_ready((rows, cols))
    else:
        group = config.dispatch_group
        njobs = grid.r0.shape[0]
        if group and njobs > group:
            # Grouped dispatches (explicit dispatch_group): each group
            # is its own profile entry in the benchmark report.
            from mpx.config import pad_job_grid
            from mpx.ops.aggregates import merge_aggregates

            # Balance group sizes: padding straight to a multiple of the
            # cap can waste up to a whole group of dummy compute (each
            # dummy still runs its masked matmul).  ceil-split instead,
            # then pad by at most ngroups-1 jobs.
            ngroups = -(-njobs // group)
            group = -(-njobs // ngroups)
            group = ((group + 63) // 64) * 64  # shape-bucket the size
            grid = pad_job_grid(grid, group, dummy_r0=w)
            njobs = grid.r0.shape[0]
            rows = cols = None
            with x64_scope(x64):
                for gi, off in enumerate(range(0, njobs, group)):
                    sl = slice(off, off + group)
                    with _phase(profile, f"2. Compute [{kernel}]", f"group_{gi}"):
                        g_rows, g_cols = run_jobs(
                            stats,
                            jnp.asarray(grid.r0[sl]),
                            jnp.asarray(grid.k0[sl]),
                            S=S, W=W, m=m, w=w,
                            kernel=kernel, dtype=str(dt),
                            tr=config.tile_rows, tc=config.tile_cols,
                        )
                        if rows is None:
                            rows, cols = g_rows, g_cols
                        else:
                            rows = merge_aggregates(rows, g_rows)
                            cols = merge_aggregates(cols, g_cols)
                        jax.block_until_ready((rows, cols))
        else:
            with _phase(profile, f"2. Compute [{kernel}]"), x64_scope(x64):
                rows, cols = run_jobs(
                    stats,
                    jnp.asarray(grid.r0),
                    jnp.asarray(grid.k0),
                    S=S,
                    W=W,
                    m=m,
                    w=w,
                    kernel=kernel,
                    dtype=str(dt),
                    tr=config.tile_rows,
                    tc=config.tile_cols,
                )
                jax.block_until_ready((rows, cols))

    with _phase(profile, "3. Post-Computation [device]"), x64_scope(x64):
        if left_right:
            from mpx.ops.aggregates import postcompute_left_right

            out = jax.jit(postcompute_left_right, static_argnums=(2, 3))(
                rows, cols, m, w
            )
            jax.block_until_ready(out)
            return out
        MP, MPI = jax.jit(postcompute, static_argnums=(2, 3))(rows, cols, m, w)
        jax.block_until_ready((MP, MPI))
    return MP, MPI


def matrix_profile(T, m: int, **kwargs):
    """Convenience wrapper: numpy in, numpy out."""
    config = MatrixProfileConfig(m=m, **kwargs) if kwargs else MatrixProfileConfig(m=m)
    MP, MPI = compute_matrix_profile(T, config=config)
    return np.asarray(MP), np.asarray(MPI)
