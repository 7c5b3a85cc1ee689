"""Batched profiles for MANY small series in one compiled sweep.

Beyond reference parity (the reference binary processes exactly one
series per invocation — host/MatrixProfileHost.cpp:54-160): fleets of
short series (one per sensor / shard / day) are the small-problem
regime where per-run overhead dominates, and the accelerator answer is
batching, not faster dispatch: ``jax.vmap`` over the existing
one-dispatch fused tier (mpx/driver.py:run_fused_small) turns B
profiles into ONE executable whose leading axis XLA tiles across the
device — and, on a mesh, into an embarrassingly data-parallel program
(the batch axis is sharded; zero collectives until the final gather).

Grouping: the batch is processed in fixed-size groups so (a) a group's
working set fits the memory budget and (b) all groups share one
compiled executable (the last group is padded by repetition).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpx.config import MatrixProfileConfig, make_job_grid
from mpx.dtypes import canonical_dtype, x64_scope
from mpx.kernels import resolve_kernel


@partial(
    jax.jit,
    static_argnames=(
        "S", "W", "m", "w", "pw", "kernel", "dtype",
        "tr", "tc", "use_windows",
    ),
)
def _run_fused_batch(T64s, r0s, k0s, **statics):
    from mpx.driver import run_fused_small

    return jax.vmap(
        lambda T64: run_fused_small(T64, r0s, k0s, **statics)
    )(T64s)


def compute_batch_profiles(
    batch,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    group: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Self-join profiles of a (B, n) batch of equal-length series.

    Returns ``(MP, MPI)`` with shape (B, n - m + 1): row b equals
    ``compute_matrix_profile(batch[b])`` through the same fused one-pass
    kernel tier (one dispatch per group instead of one-plus per
    series).  Note the fleet always uses the one-pass kernels: dtypes
    the per-series path routes to the multi-dispatch hybrid tier
    (float64, large-w float32) agree within the dtype tolerance, not
    bit-for-bit.

    ``group`` bounds series per dispatch (default: the whole batch, cut
    down so the group's working set fits the per-series memory budget,
    mpx.ops.precompute.WINDOWS_BUDGET).  With
    ``config.num_shards > 1`` the group's batch axis is laid out over a
    device mesh — pure data parallelism, no collectives.
    """
    from mpx.driver import SMALL_FUSED_MAX_W, SMALL_FUSED_MAX_W_F64
    from mpx.ops.precompute import WINDOWS_BUDGET, _padded_width

    if config is None:
        config = MatrixProfileConfig(m=m if m is not None else 32)
    elif m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    m = config.m

    batch = np.asarray(batch, np.float64)
    if batch.ndim != 2 or batch.shape[0] < 1:
        raise ValueError(
            f"batch must be 2-D (B >= 1, n) of equal-length series, got "
            f"shape {batch.shape}; pad or truncate ragged fleets first"
        )
    B, n = batch.shape
    config.validate_series(n)  # shape checks (1-D finiteness msg below)
    if not np.isfinite(batch).all():
        s, p = np.argwhere(~np.isfinite(batch))[0]
        raise ValueError(
            f"batch contains a non-finite value (series {s}, sample "
            f"{p}); NaN/inf would silently poison every correlation"
        )
    if config.input_quant is not None:
        from mpx.io.apfixed import quantize

        batch = quantize(batch, config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = canonical_dtype(config.dtype)
    # one fused dispatch per group: the hybrid tier (multi-dispatch,
    # host rescore) cannot batch — route its dtypes to one-pass kernels
    if config.kernel == "hybrid":
        raise ValueError(
            "kernel='hybrid' cannot batch (it is a multi-dispatch tier "
            "ending in a host rescore); use kernel='auto' — the fleet "
            "runs the one-pass kernels at full dtype accuracy"
        )
    kernel = resolve_kernel(config.kernel, dt, m, allow_hybrid=False, w=w)

    cap = (SMALL_FUSED_MAX_W_F64 if dt == np.dtype(np.float64)
           else SMALL_FUSED_MAX_W)
    cap = min(cap, 1 << 23)  # packed-index exactness bound
    if w > cap:
        raise ValueError(
            f"batched tier is for small series: w={w} > {cap} for dtype "
            f"{dt} (run large series individually — the job/hybrid "
            f"tiers already amortize dispatches there)"
        )

    grid = make_job_grid(w, S, W)
    pw = _padded_width(w, S, W)
    use_windows = kernel == "mxu" and pw * m * dt.itemsize <= WINDOWS_BUDGET

    shards = config.num_shards or 1
    if group is None:
        group = B
    if group < 1:
        raise ValueError("group must be >= 1")
    # the vmapped group materializes group-many per-series working sets
    # at once — bound the dominant one (the windows matrix when used,
    # else the sweep panel) by the same budget the per-series path uses
    per_series_bytes = max(
        pw * m * dt.itemsize if use_windows else 0, S * W * dt.itemsize
    )
    group = max(1, min(group, WINDOWS_BUDGET // per_series_bytes))
    group = min(group, B)
    # pad the group to the mesh so the batch axis splits evenly
    group = ((group + shards - 1) // shards) * shards

    sharding = None
    if shards > 1:
        from jax.sharding import NamedSharding, PartitionSpec

        from mpx.parallel.mesh import default_mesh

        mesh = default_mesh(shards, axis="batch")
        sharding = NamedSharding(mesh, PartitionSpec("batch"))

    statics = dict(
        S=S, W=W, m=m, w=w, pw=pw, kernel=kernel, dtype=str(dt),
        tr=config.tile_rows, tc=config.tile_cols, use_windows=use_windows,
    )
    r0s, k0s = jnp.asarray(grid.r0), jnp.asarray(grid.k0)
    MP = np.empty((B, w), dt)
    MPI = np.empty((B, w), np.int32)
    with x64_scope(True):
        for lo in range(0, B, group):
            chunk = batch[lo : lo + group]
            got = chunk.shape[0]
            if got < group:
                # repeat-pad so every group reuses ONE executable
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], group - got, axis=0)]
                )
            T64s = jnp.asarray(chunk)
            if sharding is not None:
                T64s = jax.device_put(T64s, sharding)
            packed = np.asarray(_run_fused_batch(T64s, r0s, k0s, **statics))
            MP[lo : lo + got] = packed[:got, 0]
            MPI[lo : lo + got] = np.rint(packed[:got, 1]).astype(np.int32)
    return MP, MPI
