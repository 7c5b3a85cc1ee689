"""Multi-chip job sharding (the MP_KERNEL_REPL analog).

The reference replicates the kernel over N compute units, copies the full
input to each unit's DDR bank, round-robins diagonal chunks onto the units,
and merges partial aggregates on the host
(host/MatrixProfileHost.cpp:78-137).  mpx does the JAX version:

* the (band x chunk) job list is padded and split evenly over a 1-D mesh;
* ``shard_map`` runs each device's private job scan (same compiled kernel
  as single-chip) against replicated statistics;
* per-device partial row/column profiles are merged with a max/argmax
  reduction — value max via the XLA collective, index resolved
  deterministically to the smallest owning device's candidate — riding
  ICI instead of the reference's host PCIe round trip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from mpx.config import pad_job_grid
from mpx.kernels import band_geometry, get_sweep_fn
from mpx.dtypes import AGGREGATE_INIT, canonical_dtype
from mpx.ops.aggregates import init_aggregates, merge_window
from mpx.parallel.mesh import default_mesh
from mpx.types import Aggregates, JobGrid, Stats


def _local_scan(stats, r0s, k0s, *, geom, dt, kernel, L):
    from mpx.driver import job_scan

    return job_scan(stats, r0s, k0s, geom=geom, dt=dt, kernel=kernel, L=L)


def _merge_stacked(agg_v: jax.Array, agg_i: jax.Array) -> Aggregates:
    """Merge (ndev, L) stacked partial aggregates along axis 0.

    argmax picks the first (lowest device rank) maximum — deterministic
    tie-breaking regardless of job placement."""
    best = jnp.argmax(agg_v, axis=0)
    value = jnp.take_along_axis(agg_v, best[None, :], axis=0)[0]
    index = jnp.take_along_axis(agg_i, best[None, :], axis=0)[0]
    return Aggregates(value=value, index=index)


def run_jobs_sharded(
    stats: Stats,
    grid: JobGrid,
    *,
    num_shards: int,
    S: int,
    W: int,
    m: int,
    w: int,
    kernel: str,
    dtype: str,
    tr: int = 8,
    tc: int = 2048,
    mesh=None,
):
    """Shard the job grid over ``num_shards`` devices and merge profiles."""
    if mesh is None:
        mesh = default_mesh(num_shards)
    geom = band_geometry(S, W, m, w, tr, tc)
    dt = canonical_dtype(dtype)
    L = w + S + W

    grid = pad_job_grid(grid, num_shards, dummy_r0=w)
    per_dev = grid.r0.shape[0] // num_shards
    # Round-robin placement (like the reference's CU round-robin,
    # host/MatrixProfileHost.cpp:107) balances the ragged tail jobs.
    order = np.arange(grid.r0.shape[0]).reshape(per_dev, num_shards).T.reshape(-1)
    r0s = grid.r0[order].reshape(num_shards, per_dev)
    k0s = grid.k0[order].reshape(num_shards, per_dev)

    from mpx.parallel.distributed import globalize, mesh_spans_processes

    if mesh_spans_processes(mesh):
        # Multi-host (DCN) run: inputs must be global jax.Arrays laid
        # out to match the shard_map specs — each process transfers
        # only its addressable shards over its own PCIe.
        stats = globalize(stats, mesh, P())
        r0s, k0s = globalize((r0s, k0s), mesh, P("jobs"))
    else:
        r0s, k0s = jnp.asarray(r0s), jnp.asarray(k0s)

    local = partial(
        _local_scan, geom=geom, dt=dt, kernel=kernel, L=L
    )

    # shard_map outputs concatenate along the mapped axis; make the local
    # outputs rank-2 (1, L) so stacking yields (ndev, L).
    def local_wrapper(st, r, k):
        rows, cols = local(st, r[0], k[0])
        expand = lambda a: Aggregates(a.value[None, :], a.index[None, :])
        return expand(rows), expand(cols)

    shard_fn = jax.shard_map(
        local_wrapper,
        mesh=mesh,
        in_specs=(P(), P("jobs"), P("jobs")),
        out_specs=P("jobs"),
        check_vma=False,
    )

    def sharded(st, r, k):
        rows, cols = shard_fn(st, r, k)
        # (ndev, L)-stacked partial profiles; merge over the device axis
        # (XLA inserts the cross-device collective).
        return (
            _merge_stacked(rows.value, rows.index),
            _merge_stacked(cols.value, cols.index),
        )

    with mesh:
        return jax.jit(sharded)(stats, r0s, k0s)
