"""Multi-host (DCN) execution skeleton.

The reference scales by replicating compute units on ONE board behind
one host (CMakeLists.txt:120-125, host/MatrixProfileHost.cpp:78-137);
its multi-host equivalent spans *hosts*: each process owns a slice of
the devices, processes rendezvous through JAX's coordination service,
and the same sharded job scan runs over the process-spanning mesh with
XLA inserting collectives inside a host and network transfers across
hosts.

mpx keeps the single-controller programming model: after
``initialize()``, ``jax.devices()`` is the GLOBAL device list, a 1-D
job mesh is laid over it, and ``distributed_matrix_profile`` runs the
exact same job-sharded sweep as ``mpx.parallel.sharding`` — inputs are
globalized with ``jax.device_put`` under ``NamedSharding`` (statistics
replicated, the job list sharded), so every process transfers only its
addressable shards and every process returns the full merged profile.

Environment bootstrap (torchrun-style), used when no explicit arguments
are given: ``MPX_COORDINATOR`` (host:port), ``MPX_NUM_PROCESSES``,
``MPX_PROCESS_ID``.  Single-process runs are a no-op — the module
degrades to the plain single-host path.

Untestable on real multi-host hardware in this environment; validated
by a 2-process virtual-CPU-mesh dryrun (__graft_entry__.dryrun_multichip
spawns it; Gloo provides the cross-process CPU collectives).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_ENV_COORD = "MPX_COORDINATOR"
_ENV_NPROC = "MPX_NUM_PROCESSES"
_ENV_PID = "MPX_PROCESS_ID"


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-process rendezvous (jax.distributed.initialize).

    Arguments fall back to MPX_COORDINATOR / MPX_NUM_PROCESSES /
    MPX_PROCESS_ID.  Returns True when running distributed, False for
    the single-process no-op.  Safe to call twice (idempotent)."""
    if is_initialized():
        # Already live through ANY channel (jax env bootstrap, SLURM
        # auto-detect, a direct jax.distributed.initialize) — report the
        # distributed runtime, not the env-var guard's view.
        return True
    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])

    if not coordinator or not num_processes or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_initialized() -> bool:
    return jax.distributed.is_initialized()


def global_mesh(axis: str = "jobs") -> Mesh:
    """1-D mesh over every chip of every process."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def mesh_spans_processes(mesh: Mesh) -> bool:
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def globalize(tree, mesh: Mesh, spec: P):
    """Host-local pytree -> global jax.Arrays under ``spec``.

    Every process must hold the SAME full-size host value (the usual
    case here: O(n) statistics and the job list are cheap to build
    everywhere, exactly like the reference replicating its input per
    DDR bank); device_put then transfers only the addressable shards."""
    sharding = NamedSharding(mesh, spec)
    return jax.tree.map(
        lambda x: jax.device_put(np.asarray(x), sharding), tree
    )


def distributed_matrix_profile(
    T,
    m: int,
    *,
    dtype: str = "float32",
    kernel: str = "mxu",
    band: int = 256,
    chunk: int = 512,
    tile_rows: int = 8,
    tile_cols: int = 2048,
    mesh: Optional[Mesh] = None,
):
    """Self-join matrix profile over a process-spanning device mesh.

    The jobs-mode analog of ``driver.compute_matrix_profile`` for
    multi-host runs: every process computes the O(n) statistics
    host-side, the O(n^2) job list is sharded over the global mesh, and
    the merged (MP, MPI) comes back replicated — each process returns
    the full numpy result."""
    from mpx.config import make_job_grid
    from mpx.dtypes import canonical_dtype, x64_scope
    from mpx.ops.aggregates import postcompute
    from mpx.ops.precompute import precompute_statistics
    from mpx.parallel.sharding import run_jobs_sharded

    if mesh is None:
        mesh = global_mesh()
    dt = canonical_dtype(dtype)
    n = int(np.asarray(T).shape[0])
    w = n - m + 1

    with x64_scope(dt == np.dtype(np.float64)):
        stats = precompute_statistics(
            T, m, band=band, chunk=chunk, dtype=dt, windows=False
        )
        grid = make_job_grid(w, band, chunk)
        rows, cols = run_jobs_sharded(
            stats, grid,
            num_shards=mesh.size,
            S=band, W=chunk, m=m, w=w,
            kernel=kernel, dtype=str(dt),
            tr=tile_rows, tc=tile_cols,
            mesh=mesh,
        )
        MP, MPI = jax.jit(postcompute, static_argnums=(2, 3))(rows, cols, m, w)
        return np.asarray(MP), np.asarray(MPI)
